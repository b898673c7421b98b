"""2-D (restarts x constraints) mesh program vs single-device ADMM."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qcqp_tpu as qt
from qcqp_tpu import core
from qcqp_tpu.core import QCQPForm
from qcqp_tpu.parallel import make_mesh_2d, improve_admm_2d, solve_restarts_2d
from qcqp_tpu.solvers.admm import improve_admm_batch


def _random_form(n, m, seed, eq_frac=0.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    # make constraints mostly satisfiable: shift r down
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1) - 1.0
    is_eq = rng.random(m) < eq_frac
    return QCQPForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                    jnp.asarray(is_eq))


def test_mesh2d_matches_single_device_quality():
    form = _random_form(n=8, m=10, seed=0)
    mesh = make_mesh_2d(2, 4)
    R = 8
    xs = jax.random.normal(jax.random.PRNGKey(0), (R, form.n), form.dtype)

    out2d = np.asarray(improve_admm_2d(form, xs, mesh, num_iters=200))
    out1d = np.asarray(improve_admm_batch(form, xs, num_iters=200))

    v2d = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out2d))
    v1d = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out1d))
    f2d = np.asarray(jax.vmap(lambda x: core.eval_objective(form, x))(out2d))
    f1d = np.asarray(jax.vmap(lambda x: core.eval_objective(form, x))(out1d))

    # identical algorithm, different reduction orders: quality parity per
    # restart under the (viol bucket, objective) order, not bitwise equality
    assert (v2d < 1e-2).mean() >= (v1d < 1e-2).mean() - 1e-9
    feas = (v2d < 1e-2) & (v1d < 1e-2)
    if feas.any():
        np.testing.assert_allclose(f2d[feas], f1d[feas], rtol=0.05, atol=0.05)


def test_mesh2d_constraint_padding():
    # m=7 not divisible by nc=4 -> padded with trivial rows
    form = _random_form(n=6, m=7, seed=1)
    mesh = make_mesh_2d(2, 4)
    xs = jax.random.normal(jax.random.PRNGKey(1), (4, form.n), form.dtype)
    out = np.asarray(improve_admm_2d(form, xs, mesh, num_iters=100))
    assert out.shape == (4, 6)
    assert np.isfinite(out).all()
    v = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out))
    v0 = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(xs))
    assert (v <= v0 + 1e-6).all()


def test_solve_restarts_2d_end_to_end():
    form = _random_form(n=6, m=6, seed=2)
    mesh = make_mesh_2d(4, 2)
    x, f, v = solve_restarts_2d(form, 16, jax.random.PRNGKey(0), mesh,
                                num_iters=200)
    assert float(v) < 1e-2
    # the returned objective is the actual objective at x
    f_chk = float(core.eval_objective(form, jnp.asarray(x)))
    np.testing.assert_allclose(float(f), f_chk, rtol=1e-6)


def test_mesh2d_rejects_bad_restart_count():
    form = _random_form(n=4, m=4, seed=3)
    mesh = make_mesh_2d(2, 4)
    xs = jnp.zeros((3, 4))
    with pytest.raises(ValueError):
        improve_admm_2d(form, xs, mesh)


def test_mesh2d_large_m_512_parity():
    """The use case mesh2d advertises — m in the hundreds sharded over the
    constraint axis — exercised at m=512 (previously
    untested above m=7): parity with the single-device batched ADMM at the
    same iteration budget, plus monotone violation."""
    form = _random_form(n=16, m=512, seed=3)
    mesh = make_mesh_2d(2, 4)
    R = 4
    xs = jax.random.normal(jax.random.PRNGKey(3), (R, form.n), form.dtype)

    out2d = np.asarray(improve_admm_2d(form, xs, mesh, num_iters=40))
    out1d = np.asarray(improve_admm_batch(form, xs, num_iters=40))

    v2d = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out2d))
    v1d = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(out1d))
    v0 = np.asarray(jax.vmap(lambda x: core.max_violation(form, x))(xs))
    assert np.isfinite(out2d).all()
    assert (v2d <= v0 + 1e-6).all()
    # same algorithm, different reduction order: violations agree to the
    # consensus tolerance scale
    np.testing.assert_allclose(v2d, v1d, rtol=0.1, atol=5e-2)
