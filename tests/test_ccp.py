"""Penalty-CCP improve: early-exit semantics.

The while_loop exits (outer stall+feasibility, inner dual+primal residual)
must not change solution quality versus the fixed 60 x 200 schedule.
"""

import numpy as np
import jax
import jax.numpy as jnp

from qcqp_tpu.core import QCQPForm, max_violation, eval_objective, better
from qcqp_tpu.solvers.ccp import improve_ccp


def _random_form(n, m, seed, eq_frac=0.3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    return QCQPForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                    jnp.asarray(is_eq))


def test_ccp_early_exit_quality_parity():
    form = _random_form(8, 6, seed=0)
    rng = np.random.default_rng(1)
    for i in range(3):
        x0 = jnp.asarray(rng.standard_normal(8))
        x_full = improve_ccp(form, x0, stall_tol=0.0, inner_tol=0.0)
        x_exit = improve_ccp(form, x0)
        vf = float(max_violation(form, x_full))
        ve = float(max_violation(form, x_exit))
        # early exit may stop at a (stalled, feasible-to-1e-4) point; it must
        # land in the same violation bucket and comparable objective
        assert np.floor(ve / 1e-2) <= np.floor(vf / 1e-2)
        if vf < 1e-2 and ve < 1e-2:
            ff = float(eval_objective(form, x_full))
            fe = float(eval_objective(form, x_exit))
            assert fe <= ff + 1e-2 + 0.05 * abs(ff)


def test_ccp_never_worse_than_start():
    form = _random_form(6, 5, seed=3)
    rng = np.random.default_rng(4)
    x0 = jnp.asarray(rng.standard_normal(6))
    out = improve_ccp(form, x0)
    b = better(form, out, x0)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(out))


def test_boolean_ls_quality_at_defaults_f32():
    """At its defaults the vmapped float32 CCP improve (the GPU path)
    drives a seeded boolean-LS instance feasible with a sane objective."""
    np.random.seed(1)
    n, m = 6, 9
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    for i in range(n):
        P[1 + i, i, i] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.full(n + 1, -1.0)
    r[0] = float(b @ b)
    form = QCQPForm(jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
                    jnp.asarray(r, jnp.float32), jnp.asarray(np.ones(n, bool)))
    xs = jax.random.normal(jax.random.PRNGKey(5), (8, n), jnp.float32)
    out = jax.vmap(lambda x: improve_ccp(form, x))(xs)
    v = np.asarray(jax.vmap(lambda x: max_violation(form, x))(out))
    f = np.asarray(jax.vmap(lambda x: eval_objective(form, x))(out))
    signs = 1.0 - 2.0 * ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1)
    brute = float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))
    feas = v < 1e-2
    assert feas.sum() >= 6          # most restarts land feasible
    assert float(np.min(np.where(feas, f, np.inf))) <= 3 * brute


def test_handler_float32_dccp_takes_the_xla_improve(monkeypatch):
    """QCQP.improve(DCCP) on a float32 handler (the GPU default dtype) runs
    the XLA improve and lands feasible."""
    import qcqp_tpu as qt
    import qcqp_tpu.solvers.ccp as ccp_mod
    calls = []
    orig = ccp_mod.improve_ccp

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(ccp_mod, "improve_ccp", spy)
    np.random.seed(1)
    x = qt.Variable(3)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(x)),
                           [qt.square(x) == 1]), dtype=np.float32)
    h.suggest(qt.RANDOM)
    f, v = h.improve(qt.DCCP)
    assert calls
    assert v < 1e-2
