import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qcqp_tpu.kernels.onevar import OneVarConstraints, phase1_feasible_point
from qcqp_tpu.kernels.onevar_batch import phase1_coordinate_update


def _reference_bisect(con, xk, viol, tol=1e-4, viol_tol=1e-2, n_bisect=40):
    """jnp reference of the phase-1 per-coordinate bisection (f32).

    Returns (v, accepted_slack).  Bitwise witness equality with the batched
    update is not expected — the two compile the same float expressions
    separately (FMA contraction moves boundary roots by ~1 ulp), so
    comparisons are on achieved slack / violation, not on x.
    """
    ss, es = jnp.float32(-tol), viol - viol_tol
    bx, bs, found = xk, viol, False
    it = 0
    while bool((es - ss) > tol) and it < n_bisect:
        sm = 0.5 * (ss + es)
        xi, ex = phase1_feasible_point(con, sm, xk, tol)
        if bool(ex):
            es, bx, bs, found = sm, xi, sm, True
        else:
            ss = sm
        it += 1
    accept = found and float(bs) < float(viol) and np.isfinite(float(bx))
    return (float(bx), float(bs)) if accept else (float(xk), float(viol))


def _viol_of(p, q, r, eq, act, x):
    val = p * x ** 2 + q * x + r
    vi = np.where(eq, np.abs(val), np.maximum(val, 0.0))
    return np.where(act, vi, 0.0).max(axis=0)


@pytest.mark.parametrize("seed", range(6))
def test_pallas_phase1_matches_reference_quality(seed):
    rng = np.random.default_rng(seed)
    m, R = 7, 256
    p = rng.standard_normal((m, R)).astype(np.float32)
    q = rng.standard_normal((m, R)).astype(np.float32)
    r = rng.standard_normal((m, R)).astype(np.float32)
    eq = (rng.random((m, R)) < 0.5)
    act = (rng.random((m, R)) < 0.9)
    xk = rng.standard_normal(R).astype(np.float32)
    viol = _viol_of(p, q, r, eq, act, xk).astype(np.float32)

    v = np.asarray(phase1_coordinate_update(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(r), jnp.asarray(eq),
        jnp.asarray(act), jnp.asarray(xk), jnp.asarray(viol)))

    new_viol = _viol_of(p, q, r, eq, act, v)
    # 1) never worse than the starting violation (up to boundary slop)
    assert (new_viol <= viol + 1e-3).all()

    # 2) as good as the sequential reference within the kernel's documented
    # termination: the bracket stops at es - ss <= tol + REL_SLACK_TOL *
    # max(ss, 0) (onevar_batch._bisect_accept), so the achieved slack can
    # sit up to a (1 + rel) factor above the absolute-tol reference's.
    from qcqp_tpu.kernels.onevar_batch import REL_SLACK_TOL
    for lane in range(0, R, 19):
        con = OneVarConstraints(
            jnp.asarray(p[:, lane]), jnp.asarray(q[:, lane]),
            jnp.asarray(r[:, lane]), jnp.asarray(eq[:, lane]),
            jnp.asarray(act[:, lane]))
        _, ref_slack = _reference_bisect(con, jnp.float32(xk[lane]),
                                         jnp.float32(viol[lane]))
        assert (new_viol[lane]
                <= (1.0 + REL_SLACK_TOL) * ref_slack + 3e-3), lane


@pytest.mark.parametrize("eq_frac", [0.0, 0.4, 1.0])
def test_pallas_phase1_static_eq_idx_matches_generic(eq_frac):
    """The eq_idx-specialized kernel must agree with the generic kernel
    bitwise for row-constant equality masks (same canonical rows, same
    bisection — only the neutralized reversed rows are skipped)."""
    rng = np.random.default_rng(hash(eq_frac) % 2**31)
    m, R = 9, 128
    p = rng.standard_normal((m, R)).astype(np.float32)
    q = rng.standard_normal((m, R)).astype(np.float32)
    r = rng.standard_normal((m, R)).astype(np.float32)
    eq_row = rng.random(m) < eq_frac
    eq = np.broadcast_to(eq_row[:, None], (m, R))
    act = (rng.random((m, R)) < 0.9)
    xk = rng.standard_normal(R).astype(np.float32)
    viol = _viol_of(p, q, r, eq, act, xk).astype(np.float32)

    args = (jnp.asarray(p), jnp.asarray(q), jnp.asarray(r), jnp.asarray(eq),
            jnp.asarray(act), jnp.asarray(xk), jnp.asarray(viol))
    v_gen = np.asarray(phase1_coordinate_update(*args))
    v_split = np.asarray(phase1_coordinate_update(
        *args,
        eq_idx=tuple(int(i) for i in np.nonzero(eq_row)[0])))

    # identical candidate set => identical bisection trajectory; allow the
    # documented ~ulp boundary slop in case compilation differs per variant
    new_gen = _viol_of(p, q, r, eq, act, v_gen)
    new_split = _viol_of(p, q, r, eq, act, v_split)
    assert np.allclose(v_split, v_gen, rtol=1e-5, atol=1e-5) or \
        np.allclose(new_split, new_gen, rtol=1e-4, atol=1e-4)
    assert (new_split <= viol + 1e-3).all()


def test_pallas_phase1_accepts_only_improvements():
    rng = np.random.default_rng(42)
    m, R = 5, 128
    p = np.abs(rng.standard_normal((m, R))).astype(np.float32)
    q = rng.standard_normal((m, R)).astype(np.float32)
    r = (-np.abs(rng.standard_normal((m, R))) - 0.5).astype(np.float32)
    eq = np.zeros((m, R), bool)
    act = np.ones((m, R), bool)
    xk = (5.0 * rng.standard_normal(R)).astype(np.float32)
    viol = _viol_of(p, q, r, eq, act, xk).astype(np.float32)

    v = np.asarray(phase1_coordinate_update(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(r), jnp.asarray(eq),
        jnp.asarray(act), jnp.asarray(xk), jnp.asarray(viol)))
    new_viol = _viol_of(p, q, r, eq, act, v)
    assert (new_viol <= viol + 1e-3).all()
    # convex feasible constraints from a far start: most lanes must improve a lot
    improved = (new_viol < 0.5 * viol + 1e-3) | (viol < 1e-2)
    assert improved.mean() > 0.9
