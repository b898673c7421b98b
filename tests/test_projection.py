import numpy as np
import jax.numpy as jnp
import pytest

from qcqp_tpu.kernels.projection import project_onecons
from . import oracle


def run_kernel(z, P, q, r, is_eq):
    P = 0.5 * (P + P.T)
    lam, Q = np.linalg.eigh(P)
    qhat = Q.T @ q
    return np.asarray(project_onecons(
        jnp.asarray(z), jnp.asarray(lam), jnp.asarray(Q), jnp.asarray(qhat),
        jnp.asarray(r), jnp.asarray(is_eq)))


def test_fast_path_feasible_inequality():
    rng = np.random.default_rng(0)
    n = 5
    P = np.eye(n)
    q = np.zeros(n)
    z = rng.standard_normal(n) * 0.1
    r = -1.0  # ||x||^2 <= 1, z well inside
    x = run_kernel(z, P, q, r, False)
    np.testing.assert_allclose(x, z, atol=1e-12)


def test_projection_onto_sphere():
    # x^T x - 1 == 0: projection of z is z / ||z||
    rng = np.random.default_rng(1)
    n = 6
    z = rng.standard_normal(n) * 3.0
    x = run_kernel(z, np.eye(n), np.zeros(n), -1.0, True)
    np.testing.assert_allclose(x, z / np.linalg.norm(z), atol=1e-6)


def test_projection_onto_boolean_coordinate():
    # 1-D: x^2 == 1 -> nearest of +-1
    x = run_kernel(np.array([0.3]), np.array([[1.0]]), np.array([0.0]), -1.0, True)
    np.testing.assert_allclose(x, [1.0], atol=1e-6)
    x = run_kernel(np.array([-0.3]), np.array([[1.0]]), np.array([0.0]), -1.0, True)
    np.testing.assert_allclose(x, [-1.0], atol=1e-6)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("is_eq", [False, True])
def test_random_against_slsqp_oracle(seed, is_eq):
    rng = np.random.default_rng(100 + seed)
    n = 5
    A = rng.standard_normal((n, n))
    P = 0.5 * (A + A.T)
    q = rng.standard_normal(n)
    r = rng.standard_normal()
    z = rng.standard_normal(n)

    x = run_kernel(z, P, q, r, is_eq)
    fz = z @ P @ z + q @ z + r
    if (not is_eq) and fz <= 0:
        np.testing.assert_allclose(x, z, atol=1e-12)
        return

    # kernel lands on the constraint boundary
    fx = x @ P @ x + q @ x + r
    assert abs(fx) < 1e-4, fx

    ox = oracle.project_onecons_oracle(z, P, q, r, is_eq)
    if ox is None:
        return  # oracle failed to converge; kernel feasibility already checked
    d_kernel = np.sum((x - z) ** 2)
    d_oracle = np.sum((ox - z) ** 2)
    assert d_kernel <= d_oracle + 1e-5


def test_batched_matches_single():
    from qcqp_tpu.core import random_form
    from qcqp_tpu.kernels.projection import precompute_eigh
    from qcqp_tpu.solvers.admm import _project_batch
    rng = np.random.default_rng(7)
    form = random_form(rng, n=5, m=4)
    eigh = precompute_eigh(form)
    z = rng.standard_normal((4, 5))
    out = np.asarray(_project_batch(
        jnp.asarray(z), eigh, form.r[1:], form.is_eq, 1e-6))
    for i in range(4):
        single = run_kernel(z[i], np.asarray(form.P[i + 1]),
                            np.asarray(form.q[i + 1]), float(form.r[i + 1]),
                            bool(form.is_eq[i]))
        np.testing.assert_allclose(out[i], single, atol=1e-8)


# -- fixed-trip Newton projection (the GPU's batched ADMM path) -------------

def run_newton(z, P, q, r, is_eq, trips):
    from qcqp_tpu.kernels.projection import project_onecons_newton
    P = 0.5 * (P + P.T)
    lam, Q = np.linalg.eigh(P)
    return np.asarray(project_onecons_newton(
        jnp.asarray(z), jnp.asarray(lam), jnp.asarray(Q),
        jnp.asarray(Q.T @ q), jnp.asarray(r), jnp.asarray(is_eq),
        trips=trips))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("is_eq", [False, True])
def test_newton_converges_to_the_bisection_projection(seed, is_eq):
    """Given enough trips, the safeguarded Newton solve reaches the same
    secular root as the bisection."""
    rng = np.random.default_rng(100 + seed)
    n = 5
    A = rng.standard_normal((n, n))
    P = 0.5 * (A + A.T)
    q = rng.standard_normal(n)
    r = rng.standard_normal()
    z = rng.standard_normal(n)
    x_b = run_kernel(z, P, q, r, is_eq)
    x_n = run_newton(z, P, q, r, is_eq, trips=60)
    np.testing.assert_allclose(x_n, x_b, atol=1e-5)


@pytest.mark.parametrize("z,expect", [(0.3, 1.0), (-0.3, -1.0), (2.5, 1.0)])
def test_newton_boolean_coordinate(z, expect):
    x = run_newton(np.array([z]), np.array([[1.0]]), np.array([0.0]), -1.0,
                   True, trips=30)
    np.testing.assert_allclose(x, [expect], atol=1e-6)


def test_newton_fast_path_and_few_trips_stay_finite():
    """A feasible inequality start is returned as is; six trips from far
    away give a finite point on the segment towards the set."""
    n = 5
    z = np.full(n, 0.1)
    np.testing.assert_array_equal(
        run_newton(z, np.eye(n), np.zeros(n), -1.0, False, trips=6), z)
    z = np.full(n, 40.0)
    x = run_newton(z, np.eye(n), np.zeros(n), -1.0, True, trips=6)
    assert np.isfinite(x).all()
    assert np.linalg.norm(x) < np.linalg.norm(z)
