import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qcqp_tpu as qt
from qcqp_tpu import core
from qcqp_tpu.parallel import (
    make_mesh, best_point, suggest_batch, improve_chain, solve_restarts,
    admm_phase1_sharded,
)
from .test_cd import boolean_ls_form


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_best_point_lexicographic():
    form, _, _ = boolean_ls_form(n=5, m=7, seed=0)
    rng = np.random.default_rng(0)
    xs = np.concatenate([
        rng.standard_normal((6, form.n)),            # infeasible-ish
        np.sign(rng.standard_normal((2, form.n))),   # feasible
    ])
    x, f, v = best_point(form, jnp.asarray(xs))
    # winner must be one of the feasible rows with smaller objective
    f6 = float(core.eval_objective(form, jnp.asarray(xs[6])))
    f7 = float(core.eval_objective(form, jnp.asarray(xs[7])))
    expect = xs[6] if f6 <= f7 else xs[7]
    np.testing.assert_array_equal(np.asarray(x), expect)
    assert float(v) < 1e-9


def test_suggest_batch_shapes_and_stats():
    form, _, _ = boolean_ls_form(n=6, m=8, seed=1)
    key = jax.random.PRNGKey(0)
    xs = suggest_batch(form, 512, key, qt.RANDOM)
    assert xs.shape == (512, 6)
    assert abs(float(xs.mean())) < 0.1
    assert abs(float(xs.std()) - 1.0) < 0.1


def test_solve_restarts_unsharded():
    form, A, b = boolean_ls_form(n=8, m=12, seed=3)
    best = np.inf
    for bits in range(1 << 8):
        s = np.array([1.0 if bits >> i & 1 else -1.0 for i in range(8)])
        best = min(best, float(np.sum((A @ s - b) ** 2)))
    x, f, v = solve_restarts(form, 64, jax.random.PRNGKey(0))
    assert float(v) < 1e-2
    assert float(f) <= best * 1.05 + 1e-9


def test_solve_restarts_fused_path():
    """use_fused routes CD through the sweep kernel (interpret on CPU) and
    still reaches the boolean-LS optimum region."""
    form, A, b = boolean_ls_form(n=8, m=12, seed=3)
    form32 = core.QCQPForm(form.P.astype(jnp.float32),
                           form.q.astype(jnp.float32),
                           form.r.astype(jnp.float32), form.is_eq)
    eq_idx = tuple(int(i) for i in np.nonzero(np.asarray(form.is_eq))[0])
    x, f, v = solve_restarts(form32, 128, jax.random.PRNGKey(0),
                             use_fused=True, eq_idx=eq_idx, interpret=True,
                             num_iters=30)
    assert float(v) < 1e-2
    x_ref, f_ref, v_ref = solve_restarts(form32, 128, jax.random.PRNGKey(0),
                                         use_fused=False, num_iters=30)
    assert float(f) <= float(f_ref) * 1.1 + 1e-6


def test_solve_restarts_fused_sharded():
    """Mesh + use_fused maps the kernel chain per shard (shard_map) and
    matches the unsharded fused run's best point quality."""
    form, A, b = boolean_ls_form(n=8, m=12, seed=3)
    form32 = core.QCQPForm(form.P.astype(jnp.float32),
                           form.q.astype(jnp.float32),
                           form.r.astype(jnp.float32), form.is_eq)
    eq_idx = tuple(int(i) for i in np.nonzero(np.asarray(form.is_eq))[0])
    kw = dict(use_fused=True, eq_idx=eq_idx, interpret=True, num_iters=30)
    key = jax.random.PRNGKey(2)
    x0, f0, v0 = solve_restarts(form32, 256, key, **kw)
    x1, f1, v1 = solve_restarts(form32, 256, key, mesh=make_mesh(), **kw)
    assert float(v1) < 1e-2
    # same suggest keys; sharding must not change the best point
    np.testing.assert_allclose(np.asarray(x0), np.asarray(x1), atol=1e-6)


def test_fused_auto_on_under_mesh(monkeypatch):
    """When the router sees a GPU, solve_restarts(mesh=...) engages the CD
    sweep kernel automatically (no explicit use_fused=True), mapped per
    shard."""
    from qcqp_tpu.parallel import restarts as rmod
    form, _, _ = boolean_ls_form(n=8, m=12, seed=3)
    form32 = core.QCQPForm(form.P.astype(jnp.float32),
                           form.q.astype(jnp.float32),
                           form.r.astype(jnp.float32), form.is_eq)
    monkeypatch.setattr(rmod.jax, "default_backend", lambda: "gpu")

    import qcqp_tpu.solvers.coord_descent_fused as cdf
    calls = []
    orig = cdf.improve_coord_descent_fused

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(cdf, "improve_coord_descent_fused", spy)
    x, f, v = solve_restarts(form32, 128, jax.random.PRNGKey(0),
                             mesh=make_mesh(), interpret=True, num_iters=10)
    assert calls, "the CD kernel was not engaged under the mesh"
    assert float(v) < 1e-2


def test_fused_sharded_padding_edges(monkeypatch):
    """Restart counts that are neither device- nor lane-multiples pad
    correctly through the shard_map + in-kernel padding layers."""
    form, _, _ = boolean_ls_form(n=6, m=9, seed=7)
    form32 = core.QCQPForm(form.P.astype(jnp.float32),
                           form.q.astype(jnp.float32),
                           form.r.astype(jnp.float32), form.is_eq)
    eq_idx = tuple(int(i) for i in np.nonzero(np.asarray(form.is_eq))[0])
    kw = dict(use_fused=True, eq_idx=eq_idx, interpret=True, num_iters=5)
    for R in (1, 7, 130):   # 1 restart; sub-device; over one lane tile
        x, f, v = solve_restarts(form32, R, jax.random.PRNGKey(R),
                                 mesh=make_mesh(), **kw)
        assert np.asarray(x).shape == (form.n,)
        assert np.isfinite(float(f))


def _count_chain_traces(monkeypatch):
    from qcqp_tpu.parallel import restarts as rmod
    traces = []
    orig = rmod.improve_chain

    def spy(*a, **k):
        traces.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(rmod, "improve_chain", spy)
    rmod._restart_step.cache_clear()
    return traces


def test_solve_restarts_reuses_its_compiled_step(monkeypatch):
    """A repeated call with the same configuration runs the cached jitted
    step (the improve chain is traced once); a new option builds a new
    step; results do not depend on the cache."""
    traces = _count_chain_traces(monkeypatch)
    form, _, _ = boolean_ls_form(n=5, m=6, seed=11)
    x1, f1, _ = solve_restarts(form, 24, jax.random.PRNGKey(0), num_iters=7)
    solve_restarts(form, 24, jax.random.PRNGKey(1), num_iters=7)
    assert len(traces) == 1
    solve_restarts(form, 24, jax.random.PRNGKey(0), num_iters=8)
    assert len(traces) == 2
    x3, f3, _ = solve_restarts(form, 24, jax.random.PRNGKey(0), num_iters=7)
    assert len(traces) == 2
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x3))
    assert float(f1) == float(f3)


def test_solve_restarts_array_option_is_traced(monkeypatch):
    """An array-valued option (rho) is an argument of the cached step, so
    a new value reuses it and still takes effect."""
    import qcqp_tpu as qt
    traces = _count_chain_traces(monkeypatch)
    form, _, _ = boolean_ls_form(n=5, m=6, seed=12)
    kw = dict(improve=qt.ADMM, num_iters=3, phase1=False)
    key = jax.random.PRNGKey(0)
    a = solve_restarts(form, 8, key, rho=jnp.asarray(2.0), **kw)
    b = solve_restarts(form, 8, key, rho=jnp.asarray(9.0), **kw)
    assert len(traces) == 1
    assert not np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    for rho, got in ((2.0, a), (9.0, b)):      # same as a static rho
        ref = solve_restarts(form, 8, key, rho=rho, **kw)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   atol=1e-12)


def test_improve_chain_forwards_stage_kwargs(monkeypatch):
    """Chained improve forwards the filtered kwargs to the DCCP and IPOPT
    stages like QCQP._improve_one does."""
    form, _, _ = boolean_ls_form(n=4, m=6, seed=9)
    xs = jnp.asarray(np.random.default_rng(0).standard_normal((2, form.n)))

    seen = {}

    import qcqp_tpu.solvers.ccp as ccp_mod
    import qcqp_tpu.solvers.nlp as nlp_mod

    def fake_ccp(form, x, **kw):
        seen.setdefault("ccp", kw)
        return x

    def fake_nlp(form, x, **kw):
        seen.setdefault("nlp", kw)
        return x

    monkeypatch.setattr(ccp_mod, "improve_ccp", fake_ccp)
    monkeypatch.setattr(nlp_mod, "improve_nlp", fake_nlp)
    improve_chain(form, xs, [qt.DCCP, qt.IPOPT],
                  max_iter=7, tau=0.1, inner_iters=11,
                  num_outer=3, mu0=2.0, rho=99.0)
    assert seen["ccp"]["max_iter"] == 7
    assert seen["ccp"]["tau"] == 0.1
    assert seen["ccp"]["inner_iters"] == 11
    assert "rho" not in seen["ccp"]          # foreign kwargs filtered out
    assert seen["nlp"]["num_outer"] == 3
    assert seen["nlp"]["mu0"] == 2.0
    assert "tau" not in seen["nlp"]


def test_solve_restarts_sharded_matches_unsharded():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=4)
    mesh = make_mesh()
    key = jax.random.PRNGKey(1)
    x0, f0, v0 = solve_restarts(form, 32, key)
    x1, f1, v1 = solve_restarts(form, 32, key, mesh=mesh)
    np.testing.assert_allclose(np.asarray(x0), np.asarray(x1), atol=1e-10)
    assert float(f0) == pytest.approx(float(f1), abs=1e-10)


def test_improve_chain_composition():
    form, _, _ = boolean_ls_form(n=5, m=7, seed=5)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.standard_normal((4, form.n)))
    out = improve_chain(form, xs, [qt.COORD_DESCENT, qt.ADMM],
                        num_iters=100)
    assert out.shape == xs.shape
    # chain must not be worse than CD alone under `better`
    cd = improve_chain(form, xs, qt.COORD_DESCENT, num_iters=100)
    for i in range(4):
        chained = np.asarray(core.better(form, out[i], cd[i]))
        # chained result wins or ties (better returns second arg on tie)
        assert np.array_equal(chained, np.asarray(out[i])) or \
            np.array_equal(chained, np.asarray(cd[i]))


def test_constraint_sharded_admm_matches_replicated():
    n = 4
    a = np.full(n, 0.5)
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x)),
                      [qt.sum_squares(x) <= 1, qt.sum_squares(x - a) <= 1,
                       qt.square(x) <= 4])
    form, _, _ = qt.canonicalize(prob)
    from qcqp_tpu.kernels.projection import precompute_eigh
    from qcqp_tpu.solvers.admm import admm_phase1
    x0 = jnp.asarray(np.full(n, 3.0))
    mesh = make_mesh(axis="c")
    z_sharded = np.asarray(admm_phase1_sharded(form, x0, mesh, num_iters=300))
    z_ref = np.asarray(admm_phase1(form, precompute_eigh(form), x0,
                                   1e-2, 300))
    v = float(core.max_violation(form, jnp.asarray(z_sharded)))
    assert v < 1e-2
    np.testing.assert_allclose(z_sharded, z_ref, atol=1e-6)
