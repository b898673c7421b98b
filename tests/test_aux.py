"""Auxiliary subsystems: scenarios, diagnostics, checkpoint, status gate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qcqp_tpu as qt
from qcqp_tpu import core, native
from qcqp_tpu.parallel.scenarios import (
    stack_forms, solve_scenarios, forms_from_bank,
)
from .test_cd import boolean_ls_form


def test_solve_scenarios_batched():
    forms = [boolean_ls_form(n=6, m=8, seed=s)[0] for s in range(3)]
    stacked = stack_forms(forms)
    xs, fs, vs = solve_scenarios(stacked, 16, jax.random.PRNGKey(0),
                                 num_iters=100)
    assert xs.shape == (3, 6)
    for i, form in enumerate(forms):
        assert float(vs[i]) < 1e-2
        # scenario result matches a direct single-instance solve quality-wise
        np.testing.assert_allclose(
            float(core.eval_objective(form, xs[i])), float(fs[i]), rtol=1e-9)


@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_scenarios_from_bank(tmp_path):
    forms = [boolean_ls_form(n=5, m=7, seed=s)[0] for s in range(4)]
    stacked = stack_forms(forms)
    path = str(tmp_path / "bank.qcqp")
    native.bank_write(path, np.asarray(stacked.P), np.asarray(stacked.q),
                      np.asarray(stacked.r), np.asarray(stacked.is_eq))
    loaded = forms_from_bank(path, start=1, batch=2)
    np.testing.assert_array_equal(np.asarray(loaded.P),
                                  np.asarray(stacked.P[1:3]))
    xs, fs, vs = solve_scenarios(loaded, 8, jax.random.PRNGKey(1),
                                 num_iters=50)
    assert xs.shape == (2, 5)


def test_cd_trace_monotone_violation():
    from qcqp_tpu.diagnostics import cd_trace
    form, _, _ = boolean_ls_form(n=6, m=9, seed=2)
    rng = np.random.default_rng(0)
    out = cd_trace(form, jnp.asarray(rng.standard_normal(6)), sweeps=20)
    v = np.asarray(out["violation"])
    assert v[-1] < 1e-2
    assert v[-1] <= v[0] + 1e-12


def test_admm_trace_shapes():
    from qcqp_tpu.diagnostics import admm_trace
    form, _, _ = boolean_ls_form(n=5, m=7, seed=3)
    out = admm_trace(form, jnp.zeros(5, jnp.float64), iters=50)
    assert out["violation"].shape == (50,)
    assert np.isfinite(np.asarray(out["objective"])).all()


def test_sdp_trace_residual_decreases():
    from qcqp_tpu.diagnostics import sdp_trace
    form, _, _ = boolean_ls_form(n=6, m=9, seed=4)
    out = sdp_trace(form, iters=1500)
    rp = np.asarray(out["primal_residual"])
    assert rp[-1] < 1e-4
    assert rp[-1] < rp[10]


def test_sdp_status_gate_raises_on_impossible_budget():
    from qcqp_tpu.solvers.sdp import solve_sdr
    form, _, _ = boolean_ls_form(n=8, m=12, seed=5)
    with pytest.raises(RuntimeError, match="Relaxation problem status"):
        solve_sdr(form, max_iters=3, tol=1e-10)


def test_handler_checkpoint_roundtrip(tmp_path):
    prob_data = []
    n, m = 8, 12
    np.random.seed(1)
    A = np.random.randn(m, n)
    b = np.random.randn(m)
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    q1 = qt.QCQP(prob)
    q1.suggest(qt.SDR)
    bound = q1.sdr_bound
    path = str(tmp_path / "state.npz")
    q1.save_state(path)

    q2 = qt.QCQP(prob)
    q2.load_state(path)
    assert q2.sdr_bound == bound
    # suggest must reuse the cached solution, not re-solve
    f, v = q2.suggest(qt.SDR)
    assert q2.sdr_bound == bound
    f2, v2 = q2.improve(qt.COORD_DESCENT)
    assert v2 < 1e-2


def test_solve_scenarios_sharded_matches_replicated():
    """The 2-D (scenario x restart) sharded path returns the same best
    points as the replicated-scenario path."""
    from jax.sharding import Mesh
    from qcqp_tpu.parallel.scenarios import solve_scenarios_sharded

    forms = [boolean_ls_form(n=6, m=8, seed=s)[0] for s in range(4)]
    stacked = stack_forms(forms)
    key = jax.random.PRNGKey(3)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("s", "r"))
    x0, f0, v0 = solve_scenarios(stacked, 16, key, num_iters=60)
    x1, f1, v1 = solve_scenarios_sharded(stacked, 16, key, mesh,
                                         num_iters=60)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), atol=1e-10)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0), atol=1e-10)


def test_solve_scenarios_sharded_validates_axes():
    from jax.sharding import Mesh
    from qcqp_tpu.parallel.scenarios import solve_scenarios_sharded
    forms = [boolean_ls_form(n=5, m=6, seed=s)[0] for s in range(3)]
    stacked = stack_forms(forms)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("s", "r"))
    with pytest.raises(ValueError):
        solve_scenarios_sharded(stacked, 8, jax.random.PRNGKey(0), mesh)


def test_ccp_trace_shapes_and_tau_schedule():
    from qcqp_tpu.diagnostics import ccp_trace
    rng = np.random.default_rng(1)
    form = core.random_form(rng, n=5, m=3, eq_frac=0.5)
    x0 = jnp.asarray(rng.standard_normal(5))
    tr = ccp_trace(form, x0, outers=8, tau=0.01, mu=2.0)
    assert tr["tau"].shape == (8,)
    np.testing.assert_allclose(np.asarray(tr["tau"]),
                               0.01 * 2.0 ** np.arange(8), rtol=1e-6)
    # each step folds through `better` (bucketized at 1e-4): violations
    # never increase beyond one bucket
    v = np.asarray(tr["violation"])
    assert (np.diff(v) <= 1e-4 + 1e-9).all()
