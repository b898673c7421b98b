"""The two-phase CD sweep kernel (kernels/cd_sweep_pallas.py), run in the
Pallas interpreter on the CPU, against the batched XLA paths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qcqp_tpu.core import QCQPForm, max_violation
from qcqp_tpu.kernels.cd_sweep_pallas import phase1_sweeps, two_phase_sweeps
from qcqp_tpu.solvers.coord_descent import improve_coord_descent_batch
from qcqp_tpu.solvers.coord_descent_fused import coord_descent_phase1_fused


def _random_form(n, m, seed, eq_frac=0.5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    form = QCQPForm(jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
                    jnp.asarray(r, jnp.float32), jnp.asarray(is_eq))
    eq_idx = tuple(int(i) for i in np.nonzero(is_eq)[0])
    return form, eq_idx, rng


def _viols(form, xs):
    return np.asarray(jax.vmap(lambda x: max_violation(form, x))(xs))


@pytest.mark.parametrize("n,m,eq_frac,seed",
                         [(12, 7, 0.5, 0), (9, 5, 0.0, 1), (10, 4, 1.0, 2)])
def test_mega_matches_fused_quality(n, m, eq_frac, seed):
    """Whole-sweep kernel reaches feasibility statistically on par with the
    per-coordinate batched path (identical acceptance rules; trajectories
    may diverge at ulp-tangency oracles)."""
    form, eq_idx, rng = _random_form(n, m, seed, eq_frac)
    R = 128
    xs = jnp.asarray(rng.standard_normal((R, n)), jnp.float32)

    x_old = coord_descent_phase1_fused(form, xs, num_iters=10,
                                       eq_idx=eq_idx)
    x_new = phase1_sweeps(form.P, form.q, form.r, eq_idx, xs, num_iters=10,
                          interpret=True)
    v0, v_old, v_new = _viols(form, xs), _viols(form, x_old), _viols(form, x_new)
    # never worse than the start (documented ~1e-3 boundary slop)
    assert (v_new <= v0 + 1e-3).all()
    # statistically on par with the per-coordinate path
    assert np.median(v_new) <= np.median(v_old) * 1.5 + 1e-2
    assert (v_new < 1e-2).mean() >= (v_old < 1e-2).mean() - 0.1


def test_mega_zero_sweeps_is_identity():
    form, eq_idx, rng = _random_form(8, 4, 3)
    xs = jnp.asarray(rng.standard_normal((128, 8)), jnp.float32)
    out = phase1_sweeps(form.P, form.q, form.r, eq_idx, xs, num_iters=0,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(xs), atol=0)


def test_mega_feasible_start_untouched():
    """Lanes already under viol_tol never move (alive gate)."""
    form, eq_idx, rng = _random_form(6, 3, 4, eq_frac=0.0)
    # scale constraints so x=0 is strictly feasible: r <= -1 for inequalities
    P, q, r = (np.array(form.P), np.array(form.q), np.array(form.r))
    r[1:] = -1.0
    form = QCQPForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                    form.is_eq)
    xs = jnp.zeros((128, 6), jnp.float32)
    out = phase1_sweeps(form.P, form.q, form.r, eq_idx, xs, num_iters=5,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=0)


def _objs(form, xs):
    return np.asarray(jax.vmap(
        lambda x: x @ form.P[0] @ x + form.q[0] @ x + form.r[0])(xs))


@pytest.mark.parametrize("n,m,eq_frac,seed",
                         [(12, 7, 0.5, 0), (9, 5, 0.0, 1), (10, 4, 1.0, 2)])
def test_two_phase_matches_unfused_quality(n, m, eq_frac, seed):
    """Whole two-phase kernel is statistically on par with the unfused
    batched CD: same feasible fraction and best feasible objective (identical
    acceptance rules; trajectories may diverge at ulp-tangency oracles)."""
    form, eq_idx, rng = _random_form(n, m, seed, eq_frac)
    R = 128
    xs = jnp.asarray(rng.standard_normal((R, n)), jnp.float32)

    x_ref = improve_coord_descent_batch(form, xs, num_iters=10)
    x_new = two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                             num_iters=10, interpret=True)
    v_ref, v_new = _viols(form, x_ref), _viols(form, x_new)
    o_ref, o_new = _objs(form, x_ref), _objs(form, x_new)
    feas_ref, feas_new = v_ref < 1e-2, v_new < 1e-2
    # Per-instance margins are calibrated to the kernel's OWN
    # trajectory-reshuffle noise, measured by perturbing the bisection
    # midpoints 0.2%: feasible fraction 0.102 -> 0.023 (0.23x), median
    # violation 0.0305 -> 0.0516 (1.69x), best feasible objective -10.4 ->
    # -1.3 (scale-level swing).  Phase-1 outcomes on these barely-feasible
    # R=128 instances are chaotic in the probe trajectory; the tighter
    # bound is on the aggregate (test_two_phase_aggregate_quality).
    # max(): the ratio bound covers the low-feasibility chaotic regime,
    # the absolute bound binds at high feasibility — min() would let a
    # high-feasibility kernel lose 80% of its restarts unnoticed
    assert feas_new.mean() >= max(feas_ref.mean() * 0.2,
                                  feas_ref.mean() - 0.08)
    assert np.median(v_new) <= np.median(v_ref) * 2.5 + 1e-2
    if feas_ref.any() and feas_new.any():
        scale = 1.0 + abs(float(o_ref[feas_ref].min()))
        assert (o_new[feas_new].min()
                <= o_ref[feas_ref].min() + 1.0 * scale)


def test_two_phase_skip_phase1():
    """phase1=False descends the objective from an already feasible point
    without a feasibility pass (reference improve's phase1 kwarg)."""
    form, eq_idx, rng = _random_form(10, 5, 7, eq_frac=0.0)
    # loosen inequalities so x ~ 0 region is feasible; make the objective
    # strongly convex so the descent stays bounded (f32 drift at |x| >> 1
    # would otherwise defeat the from-scratch violation check below)
    P, q, r = (np.array(form.P), np.array(form.q), np.array(form.r))
    r[1:] = r[1:] - 5.0
    P[0] = P[0] + 3.0 * np.eye(10)
    form = QCQPForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                    form.is_eq)
    xs = jnp.asarray(0.01 * rng.standard_normal((128, 10)), jnp.float32)
    v0 = _viols(form, xs)
    assert (v0 < 1e-2).all()
    out = two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                           num_iters=10, phase1=False, interpret=True)
    o0, o1 = _objs(form, xs), _objs(form, out)
    v1 = _viols(form, out)
    # objective never increases; violations stay within the entry slack
    assert (o1 <= o0 + 1e-4).all()
    assert (v1 < 1e-2 + 1e-4).all()
    assert np.median(o1) < np.median(o0) - 0.1


def test_two_phase_infeasible_lanes_gated():
    """Lanes that end phase 1 above viol_tol never enter phase 2."""
    form, eq_idx, rng = _random_form(8, 4, 9, eq_frac=1.0)
    xs = jnp.asarray(10.0 + rng.standard_normal((128, 8)), jnp.float32)
    x1 = phase1_sweeps(form.P, form.q, form.r, eq_idx, xs, num_iters=3,
                       interpret=True)
    x2 = two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs, num_iters=3,
                          interpret=True)
    v1 = _viols(form, x1)
    bad = v1 >= 1e-2
    if bad.any():
        np.testing.assert_allclose(np.asarray(x2)[bad], np.asarray(x1)[bad],
                                   atol=0)


AGGREGATE_CASES = [(12, 7, 0.5, 0), (9, 5, 0.0, 1), (10, 4, 1.0, 2),
                   (12, 7, 0.5, 3), (16, 10, 0.5, 4)]
# Measured on these cases (kernel vs unfused, CPU): mean feasible fraction
# 0.267 vs 0.281, mean median violation 0.234 vs 0.195 (1.20x), mean
# best-objective gap -0.37 (the kernel's best is better on average).
AGG_FEAS_MARGIN = 0.05
AGG_MED_RATIO = 1.5
AGG_GAP = 0.25


def test_two_phase_aggregate_quality():
    """Across instances the per-instance chaos averages out, so the
    aggregate is held to a tight bound: mean feasible fraction, mean median
    violation and mean best-objective gap against the unfused batched CD."""
    feas, meds, gaps = [], [], []
    for n, m, eq_frac, seed in AGGREGATE_CASES:
        form, eq_idx, rng = _random_form(n, m, seed, eq_frac)
        xs = jnp.asarray(rng.standard_normal((128, n)), jnp.float32)
        x_ref = improve_coord_descent_batch(form, xs, num_iters=10)
        x_new = two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                                 num_iters=10, interpret=True)
        v_ref, v_new = _viols(form, x_ref), _viols(form, x_new)
        o_ref, o_new = _objs(form, x_ref), _objs(form, x_new)
        feas.append(((v_new < 1e-2).mean(), (v_ref < 1e-2).mean()))
        meds.append((np.median(v_new), np.median(v_ref)))
        if (v_ref < 1e-2).any() and (v_new < 1e-2).any():
            best_ref = o_ref[v_ref < 1e-2].min()
            gaps.append((o_new[v_new < 1e-2].min() - best_ref)
                        / (1.0 + abs(best_ref)))
    feas, meds = np.mean(feas, axis=0), np.mean(meds, axis=0)
    assert feas[0] >= feas[1] - AGG_FEAS_MARGIN, feas
    assert meds[0] <= AGG_MED_RATIO * meds[1] + 1e-3, meds
    assert np.mean(gaps) <= AGG_GAP, gaps


@pytest.mark.parametrize("phase1", [True, False])
@pytest.mark.parametrize("n,m", [(100, 50), (10, 15), (7, 3), (128, 63)])
def test_kernel_lowers_for_cuda(n, m, phase1):
    """The kernel passes the Pallas->Triton lowering for CUDA (which rejects
    non-power-of-two blocks and unsupported primitives) at every padding
    regime, without a GPU."""
    P = jnp.zeros((m + 1, n, n), jnp.float32)
    q = jnp.zeros((m + 1, n), jnp.float32)
    r = jnp.zeros((m + 1,), jnp.float32)
    xs = jnp.zeros((40, n), jnp.float32)
    eq_idx = tuple(range(0, m, 2))
    f = lambda P, q, r, xs: two_phase_sweeps(P, q, r, eq_idx, xs,
                                             num_iters=10, phase1=phase1)
    lowered = jax.jit(f).trace(P, q, r, xs).lower(
        lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()


def _kernel_dot_precisions(phase1):
    """The precision of every dot_general inside the kernel's body."""
    n, m = 7, 3
    args = (jnp.zeros((m + 1, n, n), jnp.float32),
            jnp.zeros((m + 1, n), jnp.float32),
            jnp.zeros((m + 1,), jnp.float32), jnp.zeros((40, n), jnp.float32))
    f = lambda P, q, r, xs: two_phase_sweeps(P, q, r, (0,), xs, num_iters=3,
                                             phase1=phase1)
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(f)(*args).jaxpr)
    return found


@pytest.mark.parametrize("phase1", [True, False])
def test_kernel_products_are_ieee_float32(phase1, monkeypatch):
    """Every product in the kernel asks for HIGHEST on both operands, which
    the Pallas->Triton lowering turns into IEEE float32 dots (DEFAULT or
    HIGH would be TF32).  The bench-shape quality gate cannot tell TF32
    apart, so the precision is checked here; the control shows the check
    sees a TF32 product."""
    from qcqp_tpu.kernels import cd_sweep_pallas as ks
    hi = jax.lax.Precision.HIGHEST
    precs = _kernel_dot_precisions(phase1)
    assert precs and all(p == (hi, hi) for p in precs), precs
    monkeypatch.setattr(ks, "_HP", jax.lax.Precision.DEFAULT)
    assert any(p != (hi, hi) for p in _kernel_dot_precisions(phase1))


def test_padding_leaves_x_unchanged():
    """Zero coordinates and zero constraint rows are inert: phase 1 on a
    problem padded with them by hand gives the same real coordinates and
    leaves the extra ones at 0."""
    form, eq_idx, rng = _random_form(7, 3, 11)
    n, m = 7, 3
    P = np.zeros((m + 5, n + 4, n + 4), np.float32)
    P[:m + 1, :n, :n] = np.asarray(form.P)
    q = np.zeros((m + 5, n + 4), np.float32)
    q[:m + 1, :n] = np.asarray(form.q)
    r = np.full(m + 5, -1.0, np.float32)
    r[:m + 1] = np.asarray(form.r)
    xs = rng.standard_normal((32, n)).astype(np.float32)
    xs_pad = np.concatenate([xs, np.zeros((32, 4), np.float32)], axis=1)
    out = np.asarray(phase1_sweeps(form.P, form.q, form.r, eq_idx,
                                   jnp.asarray(xs), num_iters=5,
                                   interpret=True))
    out_pad = np.asarray(phase1_sweeps(jnp.asarray(P), jnp.asarray(q),
                                       jnp.asarray(r), eq_idx,
                                       jnp.asarray(xs_pad), num_iters=5,
                                       interpret=True))
    np.testing.assert_array_equal(out_pad[:, n:], 0.0)
    np.testing.assert_array_equal(out_pad[:, :n], out)
    assert not np.array_equal(out, xs)
