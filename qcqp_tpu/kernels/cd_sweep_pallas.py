"""Two-phase coordinate descent over a block of restarts, with no gradient cache.

The batched XLA improve (solvers/coord_descent.py) carries the (R, m+1, n)
gradient cache G = P x through device memory and rewrites it on every
coordinate step, and it launches a few kernels per bisection trip of every
coordinate.  Here the *entire* improve — sweep while-loop, Gauss-Seidel
coordinate loop, slack bisection (phase 1, reference: qcqp/qcqp.py:101-148)
and candidate argmin (phase 2, qcqp/qcqp.py:152-178, with the feasibility
gate of qcqp.py:189-190 applied per restart) — is one body over a block of
restarts:

  * there is no gradient cache: the restriction of every f_i to coordinate k
    comes from one product Gk = x @ PT[k] (PT[k, j, i] = P[i, k, j]; the
    symmetry of P lets the same slab serve both uses), and F = f_i(x) is
    refreshed from scratch once per sweep and updated in closed form per
    coordinate move;
  * rows are masked, never gathered: row 0 (the objective) and padded rows
    are switched off by a constraint mask, and the reversed rows of
    equalities by an equality mask;
  * each coordinate's resolved slack bracket is carried across sweeps
    (the warm start of onevar_batch._bisect_accept).

One Pallas program (backend="triton") runs the body for a block of
BLOCK_R = 32 restarts (16 and 64 measured slower; PERF.md): x, F and the warm brackets are loop values, the PT slab
of each coordinate is read from device memory (the padded PT is 4 MB at
n=100, m=50, so it stays in L2), and the candidate sweeps stream over the
rows.  Every product runs in full float32 (precision=HIGHEST, IEEE on this
route): the slack bisection works at tol=1e-4 and TF32 would add errors of
about 1e-3.  (The same body traced by XLA over the whole batch measured
1.45x slower at the bench shape; PERF.md.)

Layout: restarts on axis 0; coordinates and constraint rows on axis 1,
zero-padded to powers of two (at least 16): n=100 -> 128, m+1=51 -> 64.
Padded coordinates are never visited and padded rows are inactive.  Sweep
termination is per block.  float32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .onevar_batch import _bisect_accept, _canon_leq, _g_form

_HP = jax.lax.Precision.HIGHEST
_F32_MAX = 3.0e38
BLOCK_R = 32


def _pow2(k: int) -> int:
    return max(16, 1 << (int(k) - 1).bit_length())


def _col(A, sel):
    """A[:, j] for the one-hot column mask sel (1, J), as an (R,) vector."""
    return jnp.sum(jnp.where(sel, A, 0.0), axis=1)


def _make_ctx(PT, qk3, dg, rr, cm, eqm, *, n: int):
    """Per-body helpers over arrays or refs: F refresh, row violations and
    the coordinate restriction (t2, t1, t0) of every f_i (reference:
    qcqp/utilities.py:99-105, in closed form from the carried F)."""
    f32 = jnp.float32
    n_p, k_p = PT.shape[0], PT.shape[2]
    QT = qk3[...].reshape(n_p, k_p)                  # QT[j, i] = q[i, j]
    r = rr[...]                                      # (1, k_p)
    cmask = cm[...] > 0.5                            # constraint rows
    eqmask = eqm[...] > 0.5                          # equality rows
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, n_p), 1)

    def dot(a, b):
        return jnp.dot(a, b, precision=_HP, preferred_element_type=f32)

    def refresh_F(x):                                # (R, n_p) -> (R, k_p)
        def body(k, F):
            return F + _col(x, iota_n == k)[:, None] * dot(x, PT[k])
        return jax.lax.fori_loop(0, n, body, dot(x, QT) + r)

    def viol_rows(F):
        v = jnp.where(eqmask, jnp.abs(F), jnp.maximum(F, 0.0))
        return jnp.where(cmask, v, 0.0)

    def restriction(k, x, F):
        sel = iota_n == k
        xk = _col(x, sel)                            # (R,)
        Gk = dot(x, PT[k])                           # (R, k_p) = (P_i x)_k
        qk = qk3[k]                                  # (1, k_p) = q[:, k]
        xc = xk[:, None]
        t1 = 2.0 * (Gk - dg[k] * xc) + qk
        t2 = jnp.broadcast_to(dg[k], t1.shape)       # P[:, k, k]
        t0 = F - xc * (2.0 * Gk + qk) + t2 * xc ** 2
        act = ((t2 != 0.0) | (t1 != 0.0)) & cmask
        return sel, xk, t2, t1, t0, act, act & eqmask

    return refresh_F, viol_rows, restriction, k_p


def _block(p, q, c, act, tol):
    """Canonical rows of p x^2 + q x + c <= 0 (see onevar_batch._canon_leq)
    with inactive rows neutralized: (s, a2, b2) in the signed-gap form, the
    left-endpoint candidates, and the raw bounds for phase 2."""
    base, sgn, a, b, es, cand = _canon_leq(p, q, c, tol)
    s, a2, b2 = _g_form(jnp.where(act, base, 1.0), jnp.where(act, sgn, 0.0),
                        a, b)
    return s, a2, b2, jnp.where(act, cand, jnp.nan), a, b, es, act


def _gap(blk, cf):
    s, a2, b2 = blk[:3]
    return s * jnp.maximum(a2 - cf, cf - b2)


def _feas_of(blocks, c):
    """Feasibility (R,) of one candidate per restart against every row."""
    cf = jnp.clip(c, -_F32_MAX, _F32_MAX)[:, None]
    g = _gap(blocks[0], cf)
    for blk in blocks[1:]:
        g = jnp.maximum(g, _gap(blk, cf))
    return (jnp.max(g, axis=1) <= 0.0) & ~jnp.isnan(c)


def _stream(tiles, visit, st):
    """Visit the candidates of each (R, J) tile row by row, in order."""
    J = tiles[0].shape[1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, J), 1)
    for T in tiles:
        st = jax.lax.fori_loop(
            0, J, lambda j, st, T=T: visit(_col(T, iota == j), st), st)
    return st


def _witness(blocks, xk):
    """Phase-1 probe: the feasible left-endpoint candidate nearest xk, else
    the first feasible one (same order and tie-break as
    onevar_batch._feasible_point_from_canon).  Returns (witness, exists)."""
    R = xk.shape[0]
    f32 = jnp.float32
    inf = float("inf")

    def visit(c, st):
        bd, bx, fx, ex = st
        f = _feas_of(blocks, c)
        d = jnp.where(f, jnp.abs(c - xk), inf)
        d = jnp.where(jnp.isnan(d), inf, d)
        better = d < bd
        return (jnp.where(better, d, bd), jnp.where(better, c, bx),
                jnp.where(f & (ex < 0.5), c, fx),
                jnp.maximum(ex, f.astype(f32)))

    nan = jnp.full((R,), jnp.nan, f32)
    st = (jnp.full((R,), inf, f32), nan, nan, jnp.zeros((R,), f32))
    st = _stream([b[3] for b in blocks], visit, st)
    bd, bx, fx, ex = visit(jnp.full((R,), -inf, f32), st)
    return jnp.where(bd < inf, bx, fx), ex > 0.5


def _phase1_loop(x0, ctx, *, n: int, num_iters: int, tol: float,
                 viol_tol: float, n_bisect: int):
    """Full phase-1 CD (reference: qcqp/qcqp.py:101-148) on an (R, n_p)
    block, with each coordinate's bracket (certified-infeasible floor,
    accepted slack) warm-starting its next sweep's bisection."""
    f32 = jnp.float32
    refresh_F, viol_rows, restriction, k_p = ctx
    R, n_p = x0.shape

    def coord_body(k, carry):
        x, F, wlo, whi, alive, changed = carry
        sel, xk, t2, t1, t0, act, act2 = restriction(k, x, F)
        viol = jnp.max(jnp.where(act, viol_rows(F), 0.0), axis=1)

        def feasible_point(s):
            sb = s[:, None]
            return _witness([_block(t2, t1, t0 - sb, act, tol),
                             _block(-t2, -t1, -t0 - sb, act2, tol)], xk)

        def viol_of(v):
            vb = v[:, None]
            val = (t2 * vb + t1) * vb + t0
            w = jnp.where(act, jnp.maximum(val, 0.0), 0.0)
            w2 = jnp.where(act2, jnp.maximum(-val, 0.0), 0.0)
            return jnp.max(jnp.maximum(w, w2), axis=1)

        v, (nlo, nhi) = _bisect_accept(
            feasible_point, xk, viol, tol, viol_tol, n_bisect,
            viol_of=viol_of, warm=(_col(wlo, sel), _col(whi, sel)))
        upd = sel & (alive[:, None] > 0.5)
        wlo = jnp.where(upd, nlo[:, None], wlo)
        whi = jnp.where(upd, nhi[:, None], whi)
        v = jnp.where(alive > 0.5, v, xk)
        accept = (v != xk).astype(f32)
        vc = v[:, None]
        F = t2 * vc ** 2 + t1 * vc + t0
        x = jnp.where(sel, vc, x)
        return x, F, wlo, whi, alive, jnp.maximum(changed, accept)

    def sweep_cond(c):
        x, F, wlo, whi, t, viol_last, changed = c
        alive = (viol_last >= viol_tol).astype(f32) * changed
        return (t < num_iters) & (jnp.max(alive) > 0.5)

    def sweep_body(c):
        x, F, wlo, whi, t, viol_last, changed = c
        F = refresh_F(x)                             # drift control
        alive = (viol_last >= viol_tol).astype(f32) * changed
        x, F, wlo, whi, _, changed_new = jax.lax.fori_loop(
            0, n, coord_body, (x, F, wlo, whi, alive, jnp.zeros((R,), f32)))
        viol = jnp.max(viol_rows(F), axis=1)
        changed = jnp.where(alive > 0.5, changed_new, changed)
        return x, F, wlo, whi, t + 1, viol, changed

    inf_np = jnp.full((R, n_p), jnp.inf, f32)
    init = (x0, jnp.zeros((R, k_p), f32), inf_np, inf_np, jnp.int32(0),
            jnp.full((R,), jnp.inf, f32), jnp.ones((R,), f32))
    return jax.lax.while_loop(sweep_cond, sweep_body, init)[0]


def _phase2_select(blocks, xk, p0, q0, r0):
    """Argmin of the restricted objective p0 x^2 + q0 x + r0 over the
    candidate boundary points of the canonical rows, the unconstrained
    vertex, and +-inf (reference: qcqp/utilities.py:241-288, candidate-point
    formulation of kernels/onevar.onevar_qcqp_impl with proximal tie-break:
    the lowest value, then the nearest to xk, then the first in order).
    Returns (v (R,), any_feas (R,))."""
    f32 = jnp.float32
    R = xk.shape[0]
    inf = float("inf")
    safe_p0 = jnp.where(p0 > 0.0, p0, 1.0)
    vertex = jnp.where(p0 > 0.0, -q0 / (2.0 * safe_p0), jnp.nan)
    tiles = []
    for (_, _, _, _, a, b, es, act) in blocks:
        # _canon_leq folds the tangency slop into a/b for the membership
        # test; candidate POSITIONS must sit on the true boundary (an
        # eps-shifted candidate is outside the set and its violation
        # compounds over sweeps) — un-shift to O(eps^2).
        a_t = a + es * 5e-7 * (1.0 + jnp.abs(a))
        b_t = b - es * 5e-7 * (1.0 + jnp.abs(b))
        tiles.append(jnp.where(act & (jnp.abs(a) < inf), a_t, jnp.nan))
        tiles.append(jnp.where(act & (jnp.abs(b) < inf), b_t, jnp.nan))
    ends = [jnp.full((R,), -inf, f32), jnp.full((R,), inf, f32)]

    def values(c, feas):
        finite = (p0 * c + q0) * c + r0
        sgn_c = jnp.where(c > 0.0, 1.0, -1.0)
        infv = jnp.where(p0 != 0.0, jnp.where(p0 > 0.0, inf, -inf),
                         jnp.where(q0 != 0.0,
                                   jnp.where(q0 > 0.0, sgn_c, -sgn_c) * inf,
                                   r0))
        vals = jnp.where(jnp.abs(c) == inf, infv, finite)
        vals = jnp.where(feas & ~jnp.isnan(vals), vals, inf)
        dist = jnp.abs(c - xk)
        return vals, jnp.where(jnp.isnan(dist), inf, dist)

    def visit(c, st):
        bv, bd, bx, anyf = st
        f = _feas_of(blocks, c)
        val, d = values(c, f)
        better = (val < bv) | ((val == bv) & (d < bd))
        return (jnp.where(better, val, bv), jnp.where(better, d, bd),
                jnp.where(better, c, bx), jnp.maximum(anyf, f.astype(f32)))

    st = (jnp.full((R,), inf, f32), jnp.full((R,), inf, f32),
          jnp.full((R,), jnp.nan, f32), jnp.zeros((R,), f32))
    st = _stream(tiles, visit, visit(vertex, st))
    for e in ends:
        st = visit(e, st)
    return st[2], st[3] > 0.5


def _phase2_loop(x0, ctx, *, n: int, num_iters: int, tol: float,
                 viol_tol: float):
    """Full phase-2 CD (reference: qcqp/qcqp.py:152-178) on an (R, n_p)
    block.  The feasibility gate (qcqp.py:189-190) is per restart: restarts
    entering above viol_tol start with a saturated no-move counter and never
    move.  The slack is fixed at each restart's entry violation
    (qcqp.py:157,167); a restart stops after n consecutive non-moves."""
    f32 = jnp.float32
    refresh_F, viol_rows, restriction, _ = ctx
    n_f = jnp.float32(n)

    F0 = refresh_F(x0)
    slack = jnp.max(viol_rows(F0), axis=1)                       # (R,)
    counter0 = jnp.where(slack < viol_tol, 0.0, n_f)
    row0 = jax.lax.broadcasted_iota(jnp.int32, (1, F0.shape[1]), 1) == 0

    def coord_body(k, carry):
        x, F, counter = carry
        sel, xk, t2, t1, t0, act, act2 = restriction(k, x, F)
        sb = slack[:, None]
        blocks = [_block(t2, t1, t0 - sb, act, tol),
                  _block(-t2, -t1, -t0 - sb, act2, tol)]
        v, any_feas = _phase2_select(blocks, xk, _col(t2, row0),
                                     _col(t1, row0), _col(t0, row0))
        accept = (any_feas & (jnp.abs(v - xk) > tol)
                  & (jnp.abs(v) < jnp.inf) & ~jnp.isnan(v)
                  & (counter < n_f))
        counter = jnp.where(accept, 0.0, counter + 1.0)
        vc = jnp.where(accept, v, xk)[:, None]
        F = t2 * vc ** 2 + t1 * vc + t0
        x = jnp.where(sel, vc, x)
        return x, F, counter

    def sweep_cond(c):
        x, F, t, counter = c
        return (t < num_iters) & (jnp.min(counter) < n_f)

    def sweep_body(c):
        x, F, t, counter = c
        F = refresh_F(x)                             # drift control
        x, F, counter = jax.lax.fori_loop(0, n, coord_body, (x, F, counter))
        return x, F, t + 1, counter

    return jax.lax.while_loop(sweep_cond, sweep_body,
                              (x0, F0, jnp.int32(0), counter0))[0]


def _body(PT, qk3, dg, rr, cm, eqm, x, *, n, num_iters, tol, viol_tol,
          n_bisect, phase1, phase2):
    ctx = _make_ctx(PT, qk3, dg, rr, cm, eqm, n=n)
    kw = dict(n=n, num_iters=num_iters, tol=tol, viol_tol=viol_tol)
    if phase1:
        x = _phase1_loop(x, ctx, n_bisect=n_bisect, **kw)
    if phase2:
        x = _phase2_loop(x, ctx, **kw)
    return x


def _kernel(PT, qk3, dg, rr, cm, eqm, x_ref, o_ref, **kw):
    o_ref[...] = _body(PT, qk3, dg, rr, cm, eqm, x_ref[...], **kw)


def _whole(shape):
    nd = len(shape)
    return pl.BlockSpec(shape, lambda i: (0,) * nd)


def pad_problem(P, q, r, eq_idx):
    """Zero-padded float32 operands of the body: PT (n_p, n_p, k_p),
    qk3 / dg (n_p, 1, k_p), rr / cm / eqm (1, k_p)."""
    f32 = jnp.float32
    k1, n = P.shape[0], P.shape[-1]
    n_p, k_p = _pow2(n), _pow2(k1)
    Pp = jnp.pad(P.astype(f32), ((0, k_p - k1), (0, n_p - n), (0, n_p - n)))
    qp = jnp.pad(q.astype(f32), ((0, k_p - k1), (0, n_p - n)))
    PT = jnp.transpose(Pp, (1, 2, 0))            # PT[k, j, i] = P[i, k, j]
    dg = jnp.diagonal(Pp, axis1=1, axis2=2).T[:, None, :]
    qk3 = qp.T[:, None, :]
    rr = jnp.pad(r.astype(f32), (0, k_p - k1))[None, :]
    cm = np.zeros((1, k_p), np.float32)
    cm[0, 1:k1] = 1.0
    eqm = np.zeros((1, k_p), np.float32)
    eqm[0, [1 + int(i) for i in eq_idx]] = 1.0
    return PT, qk3, dg, rr, jnp.asarray(cm), jnp.asarray(eqm)


def _sweeps(P, q, r, eq_idx, xs, *, num_iters, viol_tol, tol, n_bisect,
            phase1, phase2, interpret, block_r):
    n = P.shape[-1]
    R = xs.shape[0]
    assert xs.shape[1] == n
    kw = dict(n=n, num_iters=int(num_iters), tol=float(tol),
              viol_tol=float(viol_tol), n_bisect=int(n_bisect),
              phase1=bool(phase1), phase2=bool(phase2))
    with jax.enable_x64(False):
        ops = pad_problem(P, q, r, eq_idx)
        n_p = ops[0].shape[0]
        R_pad = -(-R // block_r) * block_r
        x = jnp.pad(xs.astype(jnp.float32), ((0, R_pad - R), (0, n_p - n)))
        tile = pl.BlockSpec((block_r, n_p), lambda i: (i, 0))
        out = pl.pallas_call(
            functools.partial(_kernel, **kw),
            grid=(R_pad // block_r,),
            in_specs=[_whole(o.shape) for o in ops] + [tile],
            out_specs=tile,
            out_shape=jax.ShapeDtypeStruct((R_pad, n_p), jnp.float32),
            backend="triton",
            compiler_params=pltriton.CompilerParams(num_warps=4,
                                                    num_stages=1),
            interpret=interpret,
            name="cd_two_phase_sweeps",
        )(*ops, x)
    return out[:R, :n]


def phase1_sweeps(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                  tol=1e-4, n_bisect=40, interpret=False):
    """Run full phase-1 CD for a restart batch.

    P (m+1, n, n) symmetric, q (m+1, n), r (m+1,); eq_idx static tuple of
    equality rows; xs (R, n), padded internally to a multiple of BLOCK_R.
    Returns xs' (R, n) in float32.
    """
    return _sweeps(P, q, r, eq_idx, xs, num_iters=num_iters,
                   viol_tol=viol_tol, tol=tol, n_bisect=n_bisect,
                   phase1=True, phase2=False, interpret=interpret,
                   block_r=BLOCK_R)


def two_phase_sweeps(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                     tol=1e-4, n_bisect=40, phase1=True, interpret=False,
                     block_r=BLOCK_R):
    """Run the full two-phase CD improve for a restart batch (reference:
    qcqp/qcqp.py:181-192; phase-2 gate of qcqp.py:189-190 applied per
    restart).

    Same tensor contract as phase1_sweeps; phase1=False skips straight to
    the objective-descent phase (the reference improve's phase1 kwarg).
    block_r restarts per program (benchmarks/cd_paths.py compares sizes).
    """
    return _sweeps(P, q, r, eq_idx, xs, num_iters=num_iters,
                   viol_tol=viol_tol, tol=tol, n_bisect=n_bisect,
                   phase1=phase1, phase2=True, interpret=interpret,
                   block_r=block_r)
