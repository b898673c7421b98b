import numpy as np
import jax.numpy as jnp
import pytest

import qcqp_tpu as qt
from qcqp_tpu import core
from qcqp_tpu.expressions import canonicalize
from qcqp_tpu.solvers.admm import (
    improve_admm, improve_admm_batch, auto_rho, min_valid_rho,
)
from .test_cd import boolean_ls_form


def test_auto_rho_matches_heuristic():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=2)
    lmb = np.linalg.eigvalsh(np.asarray(form.P[0]))
    expect = 50.0 * (2 * (1 - lmb.min()) / form.m if lmb.min() < 0 else 1.0 / form.m)
    np.testing.assert_allclose(float(auto_rho(form)), expect, rtol=1e-10)
    assert float(min_valid_rho(form)) == pytest.approx(max(-lmb.min() / form.m,
                                                           -np.inf), abs=1e-12)


def test_admm_convex_projection_problem():
    # min ||x - c||^2 s.t. ||x||^2 <= 1: optimum at c/||c||
    n = 5
    c = np.zeros(n); c[0] = 2.0
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x - c)),
                      [qt.sum_squares(x) <= 1])
    form, _, _ = canonicalize(prob)
    x0 = jnp.zeros(n, jnp.float64)
    out = np.asarray(improve_admm(form, x0))
    v = float(core.max_violation(form, jnp.asarray(out)))
    f = float(core.eval_objective(form, jnp.asarray(out)))
    assert v < 5e-2
    assert f <= 1.1  # optimum is 1.0


def test_admm_boolean_ls():
    form, A, b = boolean_ls_form(n=8, m=12, seed=4)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(np.sign(rng.standard_normal(form.n)))
    out = np.asarray(improve_admm(form, x0))
    v = float(core.max_violation(form, jnp.asarray(out)))
    # ADMM keeps the best-so-far under `better`; must not be worse than start
    assert np.array_equal(
        np.asarray(core.better(form, jnp.asarray(out), x0)), out)
    assert v < 0.5


def test_admm_phase1_reaches_feasibility():
    # Convex feasibility: two overlapping balls; phase-1 consensus must find
    # the intersection from a far-away start.  (On nonconvex boolean
    # constraints phase 1 can limit-cycle — the reference's identical
    # iteration does too, which is why improve_admm guards with `better`.)
    n = 4
    a = np.full(n, 0.5)
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x)),
                      [qt.sum_squares(x) <= 1, qt.sum_squares(x - a) <= 1])
    form, _, _ = canonicalize(prob)
    from qcqp_tpu.kernels.projection import precompute_eigh
    from qcqp_tpu.solvers.admm import admm_phase1
    x0 = jnp.asarray(np.full(n, 3.0))
    z = np.asarray(admm_phase1(form, precompute_eigh(form), x0, 1e-2, 500))
    v = float(core.max_violation(form, jnp.asarray(z)))
    assert v < 1e-2, v


def test_admm_batch_matches_single():
    form, _, _ = boolean_ls_form(n=5, m=7, seed=8)
    rng = np.random.default_rng(2)
    xs = jnp.asarray(np.sign(rng.standard_normal((3, form.n))))
    batched = np.asarray(improve_admm_batch(form, xs, num_iters=50))
    for i in range(3):
        single = np.asarray(improve_admm(form, xs[i], num_iters=50))
        np.testing.assert_allclose(batched[i], single, atol=1e-8)


def _random_form32(n, m, seed, eq_frac=0.5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    return core.QCQPForm(jnp.asarray(P, jnp.float32),
                         jnp.asarray(q, jnp.float32),
                         jnp.asarray(r, jnp.float32), jnp.asarray(is_eq))


def test_admm_batch_f32_never_worse_than_start():
    """The better-folds (reference: qcqp.py:281,284-285) keep every batched
    float32 restart at least as good as its start."""
    form = _random_form32(10, 7, 5)
    rng = np.random.default_rng(9)
    xs = jnp.asarray(rng.standard_normal((4, 10)), jnp.float32)
    out = improve_admm_batch(form, xs, num_iters=60)
    for i in range(4):
        b = core.better(form, out[i], xs[i])
        np.testing.assert_array_equal(np.asarray(b), np.asarray(out[i]))


@pytest.mark.parametrize("R", [1, 3])
def test_admm_batch_odd_restart_counts(R):
    form = _random_form32(6, 4, 3)
    xs = jnp.asarray(np.random.default_rng(4).standard_normal((R, 6)),
                     jnp.float32)
    out = improve_admm_batch(form, xs, num_iters=30)
    assert out.shape == (R, 6)
    assert np.isfinite(np.asarray(out)).all()


def test_admm_batch_phase1_false():
    """phase1=False skips straight to the objective phase (the reference
    improve kwarg, qcqp.py:255) and still never ends worse than the
    start."""
    form = _random_form32(6, 4, 7)
    xs = jnp.asarray(np.sign(np.random.default_rng(8).standard_normal((2, 6))),
                     jnp.float32)
    out = improve_admm_batch(form, xs, num_iters=40, phase1=False)
    assert out.shape == (2, 6)
    assert np.isfinite(np.asarray(out)).all()
    for i in range(2):
        b = core.better(form, out[i], xs[i])
        np.testing.assert_array_equal(np.asarray(b), np.asarray(out[i]))


def test_admm_far_secular_root():
    """A projection whose secular root lies far out (a concave constraint
    with a tiny eigenvalue: ||x||^2 >= 2500) still lands feasible."""
    n = 4
    P = np.stack([np.eye(n), -1e-4 * np.eye(n)])
    form = core.QCQPForm(jnp.asarray(P, jnp.float32),
                         jnp.zeros((2, n), jnp.float32),
                         jnp.asarray([0.0, 0.25], jnp.float32),
                         jnp.asarray(np.zeros(1, bool)))
    xs = jnp.asarray(0.01 * np.ones((1, n)), jnp.float32)
    out = np.asarray(improve_admm_batch(form, xs, num_iters=200))
    assert np.isfinite(out).all()
    assert float(core.max_violation(form, jnp.asarray(out[0]))) < 1e-2


def test_handler_float32_admm_takes_the_xla_improve(monkeypatch):
    """QCQP.improve(ADMM) on a float32 handler (the GPU default dtype) runs
    the XLA improve."""
    import qcqp_tpu.api as api_mod
    calls = []
    orig = api_mod.improve_admm

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(api_mod, "improve_admm", spy)
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((9, 6)), rng.standard_normal(9)
    x = qt.Variable(6)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]), dtype=np.float32)
    h.suggest(qt.RANDOM)
    f, v = h.improve(qt.ADMM, num_iters=60)
    assert calls
    assert np.isfinite(f) and np.isfinite(v)


def _bls_form(dtype):
    """The reference's boolean least-squares example (10 x 15, seed 1)."""
    np.random.seed(1)
    A = np.random.randn(15, 10)
    b = np.random.randn(15)
    n = 10
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1 + np.arange(n), np.arange(n), np.arange(n)] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.full(n + 1, -1.0)
    r[0] = b @ b
    return core.QCQPForm(jnp.asarray(P, dtype), jnp.asarray(q, dtype),
                         jnp.asarray(r, dtype), jnp.asarray(np.ones(n, bool)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_admm_newton_projection_random_starts_boolean_ls(dtype):
    """With six-trip Newton projections, batched ADMM from 128 random
    starts reaches a point within 1e-2 of boolean feasibility in 300
    iterations; exact projections limit-cycle there (best ~0.7)."""
    import jax
    form = _bls_form(dtype)
    xs = jax.random.normal(jax.random.PRNGKey(1), (128, 10), dtype)
    out = improve_admm_batch(form, xs, num_iters=300, proj_trips=6)
    v = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out))
    assert np.isfinite(np.asarray(out)).all()
    assert v.min() < 1e-2, v.min()


@pytest.mark.parametrize("phase1", [True, False])
def test_admm_newton_never_worse_than_start(phase1):
    form = _random_form32(10, 7, 5)
    xs = jnp.asarray(np.random.default_rng(9).standard_normal((4, 10)),
                     jnp.float32)
    out = improve_admm_batch(form, xs, num_iters=60, phase1=phase1,
                             proj_trips=6)
    for i in range(4):
        b = core.better(form, out[i], xs[i])
        np.testing.assert_array_equal(np.asarray(b), np.asarray(out[i]))


def test_handler_admm_on_gpu_uses_newton_projections(monkeypatch):
    """QCQP.improve(ADMM) asks the router: on the GPU the projections are
    six Newton trips, on the CPU bisection (proj_trips=None)."""
    import jax
    import qcqp_tpu.api as api_mod
    seen = []
    orig = api_mod.improve_admm

    def spy(*a, **kw):
        seen.append(kw.get("proj_trips"))
        return orig(*a, **kw)

    monkeypatch.setattr(api_mod, "improve_admm", spy)
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((9, 6)), rng.standard_normal(9)
    x = qt.Variable(6)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]), dtype=np.float32)
    h.suggest(qt.RANDOM)
    h.improve(qt.ADMM, num_iters=30)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    f, v = h.improve(qt.ADMM, num_iters=30)
    assert seen == [None, 6]
    assert np.isfinite(f) and np.isfinite(v)
