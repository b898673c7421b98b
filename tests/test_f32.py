"""float32 path coverage on the CPU backend.

The GPU paths run in float32; these tests pin that the solvers stay
correct at that precision (tolerances were chosen for f64 by the reference
but hold in f32 for O(1)-scaled data).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qcqp_tpu import core
from qcqp_tpu.solvers.coord_descent import improve_coord_descent
from qcqp_tpu.solvers.admm import improve_admm
from qcqp_tpu.solvers.ccp import improve_ccp
from qcqp_tpu.solvers.nlp import improve_nlp
from qcqp_tpu.solvers.sdp import solve_sdr
from .test_cd import boolean_ls_form


@pytest.fixture
def form32():
    form, A, b = boolean_ls_form(n=8, m=12, seed=3)
    return form.astype(jnp.float32), A, b


def test_cd_f32(form32):
    form, A, b = form32
    rng = np.random.default_rng(0)
    x = improve_coord_descent(form, jnp.asarray(rng.standard_normal(8),
                                                jnp.float32))
    assert x.dtype == jnp.float32
    assert float(core.max_violation(form, x)) < 1e-2
    np.testing.assert_allclose(np.abs(np.asarray(x)), 1.0, atol=2e-2)


def test_admm_f32(form32):
    form, _, _ = form32
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(np.sign(rng.standard_normal(8)), jnp.float32)
    x = improve_admm(form, x0, num_iters=200)
    assert x.dtype == jnp.float32
    assert np.isfinite(np.asarray(x)).all()


def test_ccp_f32(form32):
    form, _, _ = form32
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.standard_normal(8), jnp.float32)
    x = improve_ccp(form, x0, max_iter=40, inner_iters=100)
    assert x.dtype == jnp.float32
    assert float(core.max_violation(form, x)) < 5e-2


def test_nlp_f32(form32):
    form, _, _ = form32
    rng = np.random.default_rng(3)
    x0 = jnp.asarray(rng.standard_normal(8), jnp.float32)
    x = improve_nlp(form, x0)
    assert x.dtype == jnp.float32
    assert float(core.max_violation(form, x)) < 1e-2


def test_sdr_f32_bound_close_to_f64(form32):
    form, _, _ = form32
    # device='cpu' here either way; exercise the f32 data path with the
    # warm cone projection
    from qcqp_tpu.solvers.sdp import _sdr_data, solve_sdp
    s32 = solve_sdp(_sdr_data(form), max_iters=8000, tol=2e-5,
                    psd_method="warm")
    form64 = form.astype(jnp.float64)
    X, b64 = solve_sdr(form64, max_iters=20000, tol=1e-8)
    assert float(s32.objective) == pytest.approx(float(b64), abs=5e-3)
