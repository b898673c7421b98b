import numpy as np
import jax.numpy as jnp
import pytest

import qcqp_tpu as qt
from qcqp_tpu import core
from qcqp_tpu.expressions import canonicalize
from qcqp_tpu.solvers import sdp


def test_analytic_tiny_sdp():
    # min x11 + x22 s.t. x12 == 1 (via lifted encoding), X psd
    # -> X = [[1,1],[1,1]] scaled: min trace with off-diag fixed 1:
    # optimum trace = 2 (x11 = x22 = 1).
    W0 = jnp.eye(2, dtype=jnp.float64)
    Woff = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
    data = sdp.build_sdp(
        W0, Woff[None], jnp.asarray([1.0], jnp.float64),
        jnp.asarray([False]))
    sol = sdp.solve_sdp(data, max_iters=5000, tol=1e-10)
    np.testing.assert_allclose(float(sol.objective), 2.0, atol=1e-6)
    lam = np.linalg.eigvalsh(np.asarray(sol.X))
    assert lam.min() > -1e-8


def test_sdr_boolean_ls_bound_is_lower_bound():
    from .test_cd import boolean_ls_form
    form, A, b = boolean_ls_form(n=8, m=12, seed=3)
    X, bound = sdp.solve_sdr(form, max_iters=20000, tol=1e-9)
    # true optimum by brute force
    best = np.inf
    for bits in range(1 << 8):
        s = np.array([1.0 if bits >> i & 1 else -1.0 for i in range(8)])
        best = min(best, float(np.sum((A @ s - b) ** 2)))
    assert float(bound) <= best + 1e-4
    # bound must be reasonably tight for boolean LS (SDR is strong here)
    assert float(bound) >= 0.2 * best - 1.0
    # lifted solution structure
    X = np.asarray(X)
    np.testing.assert_allclose(X[-1, -1], 1.0, atol=1e-6)
    assert np.linalg.eigvalsh(X).min() > -1e-7
    # diag of X[:n,:n] == 1 (from x_i^2 == 1 constraints)
    np.testing.assert_allclose(np.diag(X)[:-1], 1.0, atol=1e-5)


def test_sdr_convex_qp_matches_exact():
    # For a convex QP with convex constraint the SDR is tight:
    # min ||x - c||^2 s.t. ||x||^2 <= 1 -> optimum (||c||-1)^2
    n = 4
    c = np.zeros(n); c[0] = 2.0
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x - c)),
                      [qt.sum_squares(x) <= 1])
    form, _, _ = canonicalize(prob)
    X, bound = sdp.solve_sdr(form, max_iters=20000, tol=1e-9)
    np.testing.assert_allclose(float(bound), 1.0, atol=1e-5)
    mu = np.asarray(X)[:-1, -1]
    np.testing.assert_allclose(mu, [1, 0, 0, 0], atol=1e-4)


def test_spectral_boolean_ls():
    from .test_cd import boolean_ls_form
    form, A, b = boolean_ls_form(n=6, m=9, seed=5)
    xs, bound = sdp.solve_spectral(form, max_iters=20000, tol=1e-9)
    _, sdr_bound = sdp.solve_sdr(form, max_iters=20000, tol=1e-9)
    # spectral relaxation is weaker (aggregated): bound <= sdr bound
    assert float(bound) <= float(sdr_bound) + 1e-4
    assert np.asarray(xs).shape == (6,)


def test_sdp_against_slsqp_oracle():
    from . import oracle
    rng = np.random.default_rng(0)
    N = 4
    C = rng.standard_normal((N, N)); C = 0.5 * (C + C.T)
    A1 = np.eye(N)
    A2 = np.zeros((N, N)); A2[0, 1] = A2[1, 0] = 0.5
    As = [A1, A2]
    bs = [1.0, 0.1]
    eqs = [True, False]
    data = sdp.build_sdp(
        jnp.asarray(C, jnp.float64),
        jnp.asarray(np.stack(As), jnp.float64),
        jnp.asarray(bs, jnp.float64),
        jnp.asarray([not e for e in eqs]))
    sol = sdp.solve_sdp(data, max_iters=30000, tol=1e-10)
    Xo, fo, ok = oracle.solve_sdp_oracle(C, As, bs, eqs)
    if ok:
        assert float(sol.objective) <= fo + 1e-4
        # our X must satisfy the constraints
        X = np.asarray(sol.X)
        np.testing.assert_allclose(np.sum(A1 * X), 1.0, atol=1e-6)
        assert np.sum(A2 * X) <= 0.1 + 1e-6
        assert np.linalg.eigvalsh(X).min() > -1e-7


def test_sdr_batch_matches_single():
    from .test_cd import boolean_ls_form
    from qcqp_tpu.parallel.scenarios import stack_forms
    forms = [boolean_ls_form(n=6, m=9, seed=s)[0] for s in (11, 12)]
    Xb, bounds, rp, rd = sdp.solve_sdr_batch(stack_forms(forms),
                                             max_iters=8000, tol=1e-8)
    for i, form in enumerate(forms):
        X1, b1 = sdp.solve_sdr(form, max_iters=8000, tol=1e-8)
        assert float(bounds[i]) == pytest.approx(float(b1), abs=1e-4)
        np.testing.assert_allclose(np.asarray(Xb[i]), np.asarray(X1),
                                   atol=1e-3)


def test_warm_jacobi_cone_matches_eigh():
    # warm-started Jacobi PSD projection path converges to the same bound
    from .test_cd import boolean_ls_form
    form, _, _ = boolean_ls_form(n=9, m=14, seed=21)
    data = sdp._sdr_data(form)
    s_eigh = sdp.solve_sdp(data, max_iters=20000, tol=1e-9)
    s_warm = sdp.solve_sdp(data, max_iters=20000, tol=1e-9,
                           psd_method="warm", warm_sweeps=2)
    assert float(s_warm.objective) == pytest.approx(float(s_eigh.objective),
                                                    abs=1e-6)
    assert float(s_warm.primal_res) < 1e-8
    # 1 sweep also suffices
    s_w1 = sdp.solve_sdp(data, max_iters=20000, tol=1e-9,
                         psd_method="warm", warm_sweeps=1)
    assert float(s_w1.objective) == pytest.approx(float(s_eigh.objective),
                                                  abs=1e-6)


def test_jacobi_sweeps_pure_jnp():
    from qcqp_tpu.kernels.jacobi import jacobi_sweeps
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    for n0 in (7, 12):  # odd size exercises the padding path
        A = rng.standard_normal((n0, n0))
        A = 0.5 * (A + A.T)
        lam, V = jacobi_sweeps(jnp.asarray(A), sweeps=10)
        rec = np.asarray(V) @ np.diag(np.asarray(lam)) @ np.asarray(V).T
        np.testing.assert_allclose(rec, A, atol=1e-8)
        np.testing.assert_allclose(sorted(np.asarray(lam)),
                                   np.linalg.eigvalsh(A), atol=1e-8)


def test_warm_start_resolve_fewer_iterations():
    """A perturbed instance re-solved from the previous state converges in a
    fraction of the cold iteration count (parameterized-family serving)."""
    from .test_cd import boolean_ls_form
    form, _, _ = boolean_ls_form(n=6, m=6, seed=7)
    sol0 = sdp.solve_sdr(form, max_iters=20000, tol=1e-8, full=True)

    # perturb the linear terms by 0.1% (a serving-style drift)
    form2 = type(form)(form.P, form.q * 1.001, form.r, form.is_eq)
    warm = sdp.solve_sdr(form2, max_iters=20000, tol=1e-8, full=True,
                         warm=sol0.state)
    cold = sdp.solve_sdr(form2, max_iters=20000, tol=1e-8, full=True)
    assert float(warm.primal_res) <= 1e-8 and float(warm.dual_res) <= 1e-8
    np.testing.assert_allclose(float(warm.objective), float(cold.objective),
                               rtol=1e-5, atol=1e-6)
    assert int(warm.iterations) < int(cold.iterations) * 0.7, (
        int(warm.iterations), int(cold.iterations))


def test_warm_start_batch_roundtrip():
    from .test_cd import boolean_ls_form
    from qcqp_tpu.parallel.scenarios import stack_forms
    forms = [boolean_ls_form(n=5, m=5, seed=s)[0] for s in range(3)]
    stacked = stack_forms(forms)
    X, b, rp, rd, states = sdp.solve_sdr_batch(
        stacked, max_iters=4000, tol=1e-7, return_state=True)
    X2, b2, rp2, rd2 = sdp.solve_sdr_batch(
        stacked, max_iters=50, tol=1e-7, warm=states)
    # warm restart of the same instances: already converged, stays converged
    assert np.asarray(rp2).max() < 1e-6
    np.testing.assert_allclose(np.asarray(b2), np.asarray(b), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Infeasibility / unboundedness certificates (the
# reference's conic solvers classify failure via the homogeneous self-dual
# embedding, qcqp/qcqp.py:94-95; the splitting solver now certifies both
# cases from its iterate deltas in << max_iters).
# ---------------------------------------------------------------------------

def test_infeasible_contradictory_equalities():
    """x0 == 0 and x0 == 1: affinely inconsistent lifted system — the
    build-time Farkas certificate classifies at iteration zero."""
    n = 3
    P = np.zeros((3, n, n))
    q = np.zeros((3, n))
    r = np.zeros(3)
    q[1, 0] = 1.0
    q[2, 0] = 1.0
    r[2] = -1.0
    form = core.make_form(P, q, r, [True, True])
    with pytest.raises(sdp.InfeasibleRelaxationError):
        sdp.solve_sdr(form, max_iters=2000)


def test_infeasible_cone_driven():
    """x0^2 + 1 == 0: affinely consistent but PSD-cone infeasible — the
    delta-iterate dual certificate classifies in ~1 check interval."""
    n = 3
    P = np.zeros((2, n, n))
    q = np.zeros((2, n))
    r = np.zeros(2)
    P[1, 0, 0] = 1.0
    r[1] = 1.0
    form = core.make_form(P, q, r, [True])
    with pytest.raises(sdp.InfeasibleRelaxationError):
        sdp.solve_sdr(form, max_iters=20000)


def test_unbounded_relaxation():
    """minimize -||x||^2 with a loose linear constraint: the SDR recedes
    along a PSD direction with negative objective — certified unbounded."""
    n = 3
    P = np.zeros((2, n, n))
    q = np.zeros((2, n))
    r = np.zeros(2)
    P[0] = -np.eye(n)
    q[1, 0] = 1.0
    r[1] = -100.0
    form = core.make_form(P, q, r, [False])
    with pytest.raises(sdp.UnboundedRelaxationError):
        sdp.solve_sdr(form, max_iters=20000)


def test_certificates_classify_quickly_and_feasible_unaffected():
    """Certified exits report iteration counts far below max_iters, and a
    feasible instance still solves to optimality with certificates on."""
    n = 3
    P = np.zeros((2, n, n))
    q = np.zeros((2, n))
    r = np.zeros(2)
    P[1, 0, 0] = 1.0
    r[1] = 1.0
    form = core.make_form(P, q, r, [True])
    sol = sdp.solve_sdr(form, max_iters=20000, check=False, full=True)
    assert int(sol.status_code) == sdp.STATUS_INFEASIBLE
    assert int(sol.iterations) <= 500

    # feasible: x0^2 - 1 == 0 solves fine with detection enabled
    r2 = np.zeros(2)
    r2[1] = -1.0
    form2 = core.make_form(P, q, r2, [True])
    X, bound = sdp.solve_sdr(form2, max_iters=20000)
    assert np.isfinite(float(bound))


def test_anderson_acceleration_iteration_count():
    """Anderson acceleration converges the boolean-LS SDR in a fraction of
    the plain splitting iteration count (~3000 plain
    iterations were the gap to interior-point-class latency; measured ~30x
    fewer on maxcut, ~12x here)."""
    np.random.seed(1)
    n, m = 10, 15
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    for i in range(n):
        P[1 + i, i, i] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.zeros(n + 1)
    r[0] = float(b @ b)
    r[1:] = -1.0
    form = core.make_form(P, q, r, np.ones(n, bool))
    data = sdp._sdr_data(form)
    accel = sdp.solve_sdp(data, max_iters=20000, tol=1e-8)
    plain = sdp.solve_sdp(data, max_iters=20000, tol=1e-8, accel_mem=0)
    assert float(accel.primal_res) <= 1e-8
    assert np.isclose(float(accel.objective), float(plain.objective),
                      rtol=1e-6, atol=1e-6)
    assert int(accel.iterations) <= int(plain.iterations) // 2
    assert int(accel.iterations) < 2000


def test_affine_farkas_precheck_host():
    """The host-f64 numpy Farkas pre-check (run before any f32 device
    attempt) classifies contradictory equalities and leaves
    feasible instances alone."""
    n = 3
    P = np.zeros((3, n, n))
    q = np.zeros((3, n))
    r = np.zeros(3)
    q[1, 0] = 1.0
    q[2, 0] = 1.0
    r[2] = -1.0
    bad = core.make_form(P.astype(np.float32), q.astype(np.float32),
                         r.astype(np.float32), [True, True])
    assert sdp._affine_farkas_infeasible(bad)

    r2 = r.copy()
    r2[2] = 0.0          # both rows say x0 == 0: consistent
    ok = core.make_form(P.astype(np.float32), q.astype(np.float32),
                        r2.astype(np.float32), [True, True])
    assert not sdp._affine_farkas_infeasible(ok)

    from .test_cd import boolean_ls_form
    form, _, _ = boolean_ls_form(n=8, m=12, seed=3)
    assert not sdp._affine_farkas_infeasible(form)


def test_unscaled_rel_viol_gate():
    """A converged SDR solution passes the unscaled-coordinate violation
    gate (Ruiz-scaled residuals alone can hide an unscaled
    violation), and a garbage X fails it."""
    from .test_cd import boolean_ls_form
    form, _, _ = boolean_ls_form(n=8, m=12, seed=3)
    X, _ = sdp.solve_sdr(form, max_iters=20000, tol=1e-9)
    assert sdp._unscaled_rel_viol(form, jnp.asarray(X)) < 1e-6
    Xbad = jnp.eye(form.n + 1, dtype=form.dtype) * 3.0
    Xbad = Xbad.at[-1, -1].set(1.0)
    assert sdp._unscaled_rel_viol(form, Xbad) > sdp._UNSCALED_VIOL_TOL


def test_ns_projection_matches_eigh():
    """The Newton-Schulz sign projection (the round-5 device cone
    projection, _cone_proj_ns) matches the exact eigh projection to f32
    accuracy on random symmetric matrices, with soft-clamp error only at
    eigenvalues far below the spectral norm."""
    rng = np.random.default_rng(7)
    for trial in range(3):
        A = rng.standard_normal((40, 40))
        A = jnp.asarray(0.5 * (A + A.T), jnp.float64)
        Xp, _ = sdp._cone_proj_ns(A, jnp.zeros(1, jnp.float64), ns_steps=16)
        lam, Q = np.linalg.eigh(np.asarray(A))
        Xref = (Q * np.maximum(lam, 0.0)) @ Q.T
        err = np.abs(np.asarray(Xp) - Xref).max()
        assert err < 1e-4 * np.abs(lam).max()


def test_solve_sdp_ns_path():
    """solve_sdp(psd_method='ns') converges the boolean-LS SDR to the same
    bound as the exact-eigh path (the f32 on-device configuration, run here
    on CPU f64 for exactness of the comparison)."""
    from .test_cd import boolean_ls_form
    form, _, _ = boolean_ls_form(n=8, m=12, seed=3)
    data = sdp._sdr_data(form)
    ref = sdp.solve_sdp(data, max_iters=20000, tol=1e-8)
    ns = sdp.solve_sdp(data, max_iters=20000, tol=1e-8, psd_method="ns",
                       accel_mem=0, alpha=1.0, detect_certificates=False)
    np.testing.assert_allclose(float(ns.objective), float(ref.objective),
                               rtol=1e-5, atol=1e-5)
    assert float(ns.primal_res) <= 1e-8


def test_sdr_batch_acceptance_gate_fallback():
    """Batch instances whose residuals miss the acceptance gate are
    transparently re-solved in f64 (the batch
    path used to return whatever residuals came out)."""
    from .test_cd import boolean_ls_form
    forms = [boolean_ls_form(n=6, m=8, seed=s)[0] for s in (0, 1, 2)]
    stacked = core.QCQPForm(
        jnp.stack([f.P for f in forms]), jnp.stack([f.q for f in forms]),
        jnp.stack([f.r for f in forms]),
        jnp.stack([f.is_eq for f in forms]))
    # a 10-iteration budget converges nothing: every instance must arrive
    # through the host fallback, accepted and matching the single path
    X, obj, rp, rd, acc = sdp.solve_sdr_batch(stacked, max_iters=10,
                                              return_accept=True)
    assert acc.all()
    assert float(jnp.max(jnp.maximum(rp, rd))) <= sdp._INACC_TOL
    for i, f in enumerate(forms):
        _, bound = sdp.solve_sdr(f, max_iters=20000, tol=1e-8)
        np.testing.assert_allclose(float(obj[i]), float(bound),
                                   rtol=1e-4, atol=1e-4)
    # gate=None restores the ungated legacy behavior
    X2, o2, rp2, rd2 = sdp.solve_sdr_batch(stacked, max_iters=10, gate=None)
    assert float(jnp.max(rp2)) > sdp._INACC_TOL
