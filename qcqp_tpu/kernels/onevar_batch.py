"""Batched phase-1 coordinate update: the slack bisection over a restart batch.

The coordinate-descent phase-1 step solves, per coordinate and restart,

    min s  s.t.  exists x: viol_i(x) <= s  for all i     (slack bisection)

by a few halvings, each evaluating the candidate left endpoints of the
constraints' solution sets against every constraint.  Here the whole
bisection of a coordinate step runs over the batch at once, as plain JAX.

Layout: restarts on the last axis, constraints on the first.
    p, q, r   (m, R)   restriction coefficients of the m constraints
    is_eq     (m, R)   equality flags
    xk, viol  (R,)     current coordinate value / current violation
Output:
    v         (R,)     accepted new coordinate value (xk where not accepted)

Semantics identical to solvers.coord_descent phase-1 + kernels.onevar
phase1_feasible_point (left-endpoint candidates, proximal tie-break,
`new_viol < viol` acceptance); validated against that path in
tests/test_onevar_pallas.py.  The elementwise helpers here (`_canon_leq`,
`_g_form`, `_bisect_accept`) are shared with the two-phase sweep kernel
(kernels/cd_sweep_pallas.py), which works in a (restarts, rows) layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_TOL = 1e-4


def _canon_leq(p, q, c, tol):
    """Canonicalize the solution set of p x^2 + q x + c <= 0 into the single
    membership form

        feas(x) = base + sgn * [ x >= a - es*eps(x) and x <= b + es*eps(x) ]

    with per-constraint (base, sgn, a, b, es) — candidate-independent, so the
    quadratic-formula work (D, roots) runs once per constraint instead of
    once per (constraint, candidate) pair.  Cases:
      p > tol, D >= 0 : interval [lo, hi]        base 0, sgn +1, es +1
      p > tol, D < 0  : empty                    base 0, sgn  0
      p < -tol, D >= 0: complement of (hi, lo)   base 1, sgn -1, es -1
      p < -tol, D < 0 : full line                base 1, sgn  0
      |p| <= tol      : linear / full per sign(q)
    Also returns the left-endpoint candidate of the set (reference:
    qcqp/utilities.py:210-231 left endpoints; NaN when none).

    eps(x) is the caller's per-candidate ~4-ulp relative slop: candidates are
    these very boundary points recomputed by a separately compiled
    expression, and FMA contraction can move a root by 1 ulp.
    """
    f32 = jnp.float32
    D = q * q - 4.0 * p * c
    rD = jnp.sqrt(jnp.maximum(D, 0.0))
    two_p = jnp.where(jnp.abs(p) > tol, 2.0 * p, 1.0)
    lo = (-q - rD) / two_p
    hi = (-q + rD) / two_p
    xlin = -c / jnp.where(jnp.abs(q) > tol, q, 1.0)
    ninf = jnp.full_like(p, -jnp.inf)
    pinf = jnp.full_like(p, jnp.inf)
    nan = jnp.full_like(p, jnp.nan)

    pos, neg = p > tol, p < -tol
    Dge = D >= 0
    qpos, qneg = q > tol, q < -tol
    lin = ~pos & ~neg

    base = (neg | (lin & ~qpos & ~qneg)).astype(f32)
    # interval rows: pos&Dge (a=lo,b=hi) | lin&qpos ((-inf, xlin)) |
    #                lin&qneg ((xlin, inf))
    interval = (pos & Dge) | (lin & (qpos | qneg))
    complement = neg & Dge
    sgn = jnp.where(interval, 1.0, jnp.where(complement, -1.0, 0.0))
    es = jnp.where(complement, -1.0, 1.0)
    a = jnp.where(pos & Dge, lo,
                  jnp.where(lin & qneg, xlin,
                            jnp.where(complement, hi, ninf)))
    b = jnp.where(pos & Dge, hi,
                  jnp.where(lin & qpos, xlin,
                            jnp.where(complement, lo, pinf)))
    # Fold the ~4-ulp tangency slop into the bounds HERE (per row) instead
    # of per (row, candidate) in the membership sweep: candidates are these
    # very boundary values recomputed by separately compiled expressions, so
    # eps(boundary) == eps(candidate) to O(eps^2) and the guard is
    # unchanged, while the inner check drops from ~9 to ~7 elementwise ops
    # (the candidate sweep is the CD improve's dominant cost).
    a = jnp.where(jnp.isfinite(a), a - es * 5e-7 * (1.0 + jnp.abs(a)), a)
    b = jnp.where(jnp.isfinite(b), b + es * 5e-7 * (1.0 + jnp.abs(b)), b)
    # left-endpoint candidate (matches the old _left_ep_rows selection)
    cand = jnp.where(pos & Dge, lo,
                     jnp.where(neg & Dge, lo,
                               jnp.where(lin & qneg, xlin, nan)))
    return base, sgn, a, b, es, cand


def _g_form(base, sgn, a, b):
    """Derive the signed-gap encoding of a canonical row block: feasibility
    of x against row j becomes  s_j * max(a'_j - x, x - b'_j) <= 0.

      interval  (base 0, sgn +1): s +1, bounds as-is
      empty     (base 0, sgn  0): s +1, a' = +inf, b' = -inf
      complement(base 1, sgn -1): s -1, bounds as-is (already swapped hi/lo
                                  with the slop folded outward by _canon_leq)
      full      (base 1, sgn  0): s +1, a' = -inf, b' = +inf (as-is)

    Candidate-independent — one O(rows) pass per bisection trip — and it
    buys the candidate sweep's inner check down from ~7 elementwise ops
    (compare/compare/convert/mul/add/mul fold) to 5 (sub/sub/max/mul/max
    fold)."""
    s = jnp.where(sgn < -0.5, -1.0, 1.0)
    nosgn = jnp.abs(sgn) < 0.5
    empty = (base < 0.5) & nosgn
    # full rows — including rows NEUTRALIZED by the caller (base 1, sgn 0
    # with their original finite bounds left in place) — must accept
    # everything
    full = (base > 0.5) & nosgn
    a2 = jnp.where(empty, jnp.inf, jnp.where(full, -jnp.inf, a))
    b2 = jnp.where(empty, -jnp.inf, jnp.where(full, jnp.inf, b))
    return s, a2, b2


def feas_matrix_from_canon(blocks, cands):
    """Feasibility (f32 0/1, same shape as cands) of each candidate against
    every canonical row.  blocks is a list of canonical-row tuples
    (base, sgn, a, b, es, _), each (k_i, R), already neutralized for
    inactive rows; cands is (C, R) with NaN marking 'no candidate'.

    The inner fold is the signed-gap form (see _g_form): the max over rows
    of s_j * max(a_j - x, x - b_j) is <= 0 exactly when every row accepts
    x.  All infinity cases ride the IEEE semantics (inf - x = inf,
    max(-inf, -inf) = -inf); NaN candidates produce NaN gaps and are
    masked by the epilogue."""
    # +-inf candidates (phase 2's unbounded-argmin probes) would produce
    # inf - inf = NaN gaps against same-signed infinite bounds; clamping to
    # the f32 max keeps every comparison's outcome identical (bounds are
    # either infinite — strictly beyond the clamp — or O(1) finite).
    cf = jnp.clip(cands, -3.0e38, 3.0e38)
    g = jnp.full(cands.shape, -jnp.inf, jnp.float32)
    # Static unroll over the canonical rows (trace-time constant counts).
    for (base, sgn, a, b, es, _) in blocks:
        s, a2, b2 = _g_form(base, sgn, a, b)
        for j in range(base.shape[0]):
            gj = s[j:j + 1] * jnp.maximum(a2[j:j + 1] - cf,
                                          cf - b2[j:j + 1])
            g = jnp.maximum(g, gj)

    return ((g <= 0.0) & ~jnp.isnan(cands)
            & ~jnp.isnan(g)).astype(jnp.float32)


def _feasible_point_from_canon(blocks, xk):
    """Shared candidate-sweep tail: blocks is a list of canonical-row tuples
    (base, sgn, a, b, es, cand), each (k_i, R), already neutralized for
    inactive rows.  Returns (witness (R,), exists (R,))."""
    big = jnp.float32(jnp.inf)
    f32 = jnp.float32
    R = xk.shape[0]

    ninf = jnp.full((1, R), -jnp.inf, f32)
    cands = jnp.concatenate([blk[5] for blk in blocks] + [ninf], axis=0)
    feas = feas_matrix_from_canon(blocks, cands)
    exists = jnp.max(feas, axis=0) > 0.5
    dist = jnp.where(feas > 0.5, jnp.abs(cands - xk[None, :]), big)
    dist = jnp.where(jnp.isnan(dist), big, dist)
    any_fin = jnp.min(dist, axis=0) < big
    # first minimal distance; else the first feasible candidate
    best_prox = jnp.argmin(dist, axis=0)
    first_feas = jnp.argmin(1.0 - feas, axis=0)
    idx = jnp.where(any_fin, best_prox, first_feas)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, cands.shape, 0)
    onehot = (row_ids == idx[None, :].astype(jnp.int32)).astype(f32)
    witness = jnp.sum(jnp.where(onehot > 0.5, cands, 0.0), axis=0)
    return witness, exists


def feasible_point_rows(p, q, r, eq, act, xk, s, tol):
    """(witness (R,), exists (R,)) at slack row s (R,), block layout (m, R).

    Identical semantics to kernels.onevar.phase1_feasible_point, restructured
    for restart-major tiles.
    The per-constraint interval bounds are hoisted out of the candidate loop
    (the old form recomputed the quadratic formula once per (constraint,
    candidate) pair — 4x more elementwise work at the bench shape).
    """
    one = jnp.ones_like(p)
    sb = s[None, :]

    base1, sgn1, a1, b1, es1, cand1 = _canon_leq(p, q, r - sb, tol)
    base2, sgn2, a2, b2, es2, cand2 = _canon_leq(-p, -q, -r - sb, tol)
    # the reversed row only exists for equalities; neutralize it elsewhere
    base2 = jnp.where(eq > 0, base2, one)
    sgn2 = jnp.where(eq > 0, sgn2, 0.0 * one)
    cand2 = jnp.where(eq > 0, cand2, jnp.nan)
    # inactive constraints contribute nothing (old `act` mask semantics)
    base1 = jnp.where(act > 0, base1, one)
    sgn1 = jnp.where(act > 0, sgn1, 0.0 * one)
    base2 = jnp.where(act > 0, base2, one)
    sgn2 = jnp.where(act > 0, sgn2, 0.0 * one)

    return _feasible_point_from_canon(
        [(base1, sgn1, a1, b1, es1, cand1),
         (base2, sgn2, a2, b2, es2, cand2)], xk)


def feasible_point_rows_split(p, q, r, act, p2, q2, r2, act2, xk, s, tol):
    """Static-equality-pattern variant of feasible_point_rows.

    The caller has already gathered the E equality rows into the second
    block (p2, q2, r2, act2: (E, R)), so the reversed rows of inequality
    constraints — neutralized no-ops in the generic kernel — are skipped
    structurally: the candidate sweep runs over m+E rows x (m+E+1)
    candidates instead of 2m x (2m+1) (~1.77x less inner-loop work at the
    bench's 50% equality mix)."""
    one = jnp.ones_like(p)
    sb = s[None, :]

    base1, sgn1, a1, b1, es1, cand1 = _canon_leq(p, q, r - sb, tol)
    base1 = jnp.where(act > 0, base1, one)
    sgn1 = jnp.where(act > 0, sgn1, 0.0 * one)
    blocks = [(base1, sgn1, a1, b1, es1, cand1)]

    if p2 is not None:
        one2 = jnp.ones_like(p2)
        base2, sgn2, a2, b2, es2, cand2 = _canon_leq(-p2, -q2, -r2 - sb, tol)
        base2 = jnp.where(act2 > 0, base2, one2)
        sgn2 = jnp.where(act2 > 0, sgn2, 0.0 * one2)
        blocks.append((base2, sgn2, a2, b2, es2, cand2))

    return _feasible_point_from_canon(blocks, xk)


REL_SLACK_TOL = 1.0 / 16.0


def _bisect_accept(feasible_point, xk, viol, tol, viol_tol, n_bisect,
                   viol_of=None, rel=REL_SLACK_TOL, warm=None):
    """Shared slack-bisection tail of the batched phase-1 paths (reference:
    qcqp/qcqp.py:122-135).  Returns (v, warm_out): v is the accepted
    coordinate value (xk where not accepted); warm_out is the accepted
    witness's slack for cross-sweep warm starting (+inf where not
    accepted).

    Three trip-count optimizations over the reference's uniform halving to
    an absolute tol (each ~17 trips from a bracket of width ~viol), all
    leaving the acceptance semantics intact (accept iff the witness's
    violation strictly drops):

    * viol_of (optional): v (R,) -> max restriction violation (R,).  A
      feasible probe shrinks the upper bracket to the witness's ACTUAL
      violation instead of the probed slack — a valid upper bound usually far
      below the midpoint.  One O(m) row sweep per trip (~1% of the candidate
      sweep) buys the skipped trips; bs becomes the witness's true violation,
      a tighter value than the probed slack.
    * relative termination: a lane stops once es - ss <= tol + rel*max(ss,0).
      When the minimal slack is large, resolving it to the absolute tol buys
      no quality (the accept only needs strict improvement, and later sweeps
      re-refine); this caps the infeasible-heavy lanes that otherwise gate
      the whole batch at the worst case.  Deviation from the reference's
      absolute-tol bisection (qcqp.py:122-131), quality-pinned by the golden
      example and parity tests.
    * warm (optional): per-lane (wlo, whi) bracket
      carried from this coordinate's bisection LAST sweep — wlo the final
      certified-infeasible slack, whi the accepted witness slack (+inf if
      none).  The bracket starts at the narrow window [wlo*(1-rel)-tol,
      whi*(1+rel)+tol] (clipped to the cold bracket, widened to guarantee
      at least one probe) instead of the full [-tol, viol-viol_tol]: the
      minimal slack drifts slowly between sweeps, so 1-2 probes usually
      resolve it — and the coordinates with NO improving move (which used
      to re-pay the full cold bisection every sweep, the dominant trip
      cost on infeasible-heavy batches) re-certify in one probe.  Lanes
      whose window exhausts with NO feasible probe escalate the upper end
      to the cold top and keep bisecting (no separate fallback pass); a
      feasible witness's viol_of shrink recovers optima BELOW the window;
      and the (1-rel)-per-sweep decay of the carried wlo re-probes lower
      slacks over time, so a stale warm value costs trips, not moves.
    """
    es_cold = viol - viol_tol

    def gap_tgt(ss):
        return tol + rel * jnp.maximum(ss, 0.0)

    if warm is None:
        ss0 = jnp.full_like(xk, -tol)
        es0 = es_cold
    else:
        # Only the HOPELESS lanes warm-start (previous sweep certified
        # infeasibility up to wlo and accepted nothing: whi == +inf).
        # They re-certify in ~1 probe instead of the full cold bisection —
        # the dominant trip cost on infeasible-heavy batches — while every
        # lane that moved last sweep keeps the exact cold window, so the
        # accepted points (where quality is made) are bit-identical to the
        # cold bisection.  (A variant that also warmed the accepting lanes'
        # window around their last slack took fewer trips but degraded the
        # bench best point (f, v) from (-6.78, 3.24) to (18.5, 3.42) —
        # rejected; quality gates the throughput metric.)
        wlo, whi = warm
        # Accepting lanes: warm only the UPPER end — the bracket still
        # covers [-tol, whi(1+rel)] fully (no blocked downward refinement,
        # which is what degraded quality in the rejected two-sided cut)
        # and the escalation path covers s* drifting above the window.
        hi_ok = jnp.isfinite(whi) & (whi < es_cold)
        es0 = jnp.where(hi_ok, jnp.minimum(es_cold, whi * (1.0 + rel) + tol),
                        es_cold)
        lo_ok = jnp.isfinite(wlo) & (wlo > 0.0) & ~jnp.isfinite(whi)
        ss0 = jnp.where(lo_ok, jnp.maximum(-tol, wlo * (1.0 - rel) - tol),
                        -tol)
        # Guarantee >= 1 probe, landing at es0 - 0.5*gap — exactly the
        # deepest probe the cold bisection makes before certifying
        # no-accept — so the warm re-certification misses (almost) no
        # accept the cold path would have found.  (The first cut used
        # es0 - 1.5*gap: its probe at es0 - 0.75*gap left a 0.25*gap
        # blind band at the top and measurably degraded the bench median
        # violation by ~4%.)
        ss0 = jnp.maximum(-tol, jnp.minimum(ss0, es0 - 1.0 * gap_tgt(ss0)))

    # Lanes riding a warm floor: if a probe lands FEASIBLE the hopeless
    # assumption broke (the coordinate became improvable since last
    # sweep) — the stale floor would block downward refinement and the
    # lane would accept a coarse high-slack witness (measured: bench best
    # point degraded to (-5.62, 3.44)).  Drop the floor back to -tol and
    # keep bisecting: the rare newly-improvable lane pays the cold trip
    # count, everyone else keeps the 1-probe re-certification.
    warm0 = jnp.where(ss0 > -tol, 1.0, 0.0) if warm is not None else None

    def live_score(ss, es, found):
        # > 0 while a lane still has work: bracket wider than its gap
        # target, or a warm window that exhausted without a feasible probe
        # and can still escalate to the cold top.
        gap = es - ss - gap_tgt(ss)
        esc = jnp.where((found < 0.5) & (es < es_cold), 1.0, -1.0)
        return jnp.maximum(gap, esc)

    def bis_cond(c):
        ss, es, bx, bs, found, wflag, it = c
        return (jnp.max(live_score(ss, es, found)) > 0.0) & (it < n_bisect)

    def bis_body(c):
        ss, es, bx, bs, found, wflag, it = c
        # escalate exhausted warm windows before probing
        need_esc = ((es - ss) <= gap_tgt(ss)) & (found < 0.5) & \
            (es < es_cold)
        es = jnp.where(need_esc, es_cold, es)
        do = (es - ss) > gap_tgt(ss)
        # The probe sits 0.1% of the bracket below the midpoint.  The value
        # is empirical, not derived: outcomes are chaotic in the probe
        # trajectory, and with the exact midpoint the best restart of
        # tests/test_bisect_quality.py at scale 1 lands in violation
        # bucket 4 instead of 2 (CPU).  The acceptance rule is unchanged
        # either way.
        sm = 0.501 * ss + 0.499 * es
        xi, exists = feasible_point(sm)
        take = do & exists
        if viol_of is None:
            s_up = sm
        else:
            g = viol_of(xi)
            # guard non-finite witnesses (e.g. -inf when the set is
            # unbounded below): fall back to the probed slack
            s_up = jnp.where(jnp.isfinite(xi) & ~jnp.isnan(g),
                             jnp.minimum(g, sm), sm)
        ss = jnp.where(do & ~exists, sm, ss)
        # stale-floor reset (see warm0 above)
        reset = take & (wflag > 0.5)
        ss = jnp.where(reset, -tol, ss)
        wflag = jnp.where(reset, 0.0, wflag)
        es = jnp.where(take, s_up, es)
        bx = jnp.where(take, xi, bx)
        bs = jnp.where(take, s_up, bs)
        # found carried as f32 0/1 (float loop carries only)
        found = jnp.maximum(found, take.astype(jnp.float32))
        return ss, es, bx, bs, found, wflag, it + 1

    R = xk.shape[0]
    wflag0 = warm0 if warm is not None else jnp.zeros_like(xk)
    init = (ss0, es0, xk, viol,
            jnp.zeros((R,), jnp.float32), wflag0, jnp.int32(0))
    ss_f, _, bx, bs, found, _, _ = jax.lax.while_loop(bis_cond, bis_body,
                                                      init)

    accept = (found > 0.5) & (bs < viol) & jnp.isfinite(bx)
    wlo_out = ss_f
    whi_out = jnp.where(accept, bs, jnp.inf)
    return jnp.where(accept, bx, xk), (wlo_out, whi_out)


def _phase1_update(p, q, r, eq, act, xk, viol, tol, viol_tol, n_bisect):
    def feasible_point(s):
        return feasible_point_rows(p, q, r, eq, act, xk, s, tol)

    def viol_of(v):
        vb = v[None, :]
        val = (p * vb + q) * vb + r
        vv = jnp.where(eq > 0.5, jnp.abs(val), jnp.maximum(val, 0.0))
        return jnp.max(jnp.where(act > 0.5, vv, 0.0), axis=0)

    return _bisect_accept(feasible_point, xk, viol, tol, viol_tol,
                          n_bisect, viol_of=viol_of)[0]


def _phase1_update_split(p, q, r, act, p2, q2, r2, act2, xk, viol, tol,
                         viol_tol, n_bisect):
    """Static equality pattern: inequality rows appear once, the E equality
    rows (pre-gathered by the caller) carry their reversed block."""
    def feasible_point(s):
        return feasible_point_rows_split(p, q, r, act, p2, q2, r2, act2,
                                         xk, s, tol)

    def viol_of(v):
        # the positive side of every row lives in block 1; the eq rows'
        # negative side (|val| = max(val, -val)) in block 2
        vb = v[None, :]
        val = (p * vb + q) * vb + r
        w = jnp.max(jnp.where(act > 0.5, jnp.maximum(val, 0.0), 0.0), axis=0)
        if p2 is not None:
            val2 = (p2 * vb + q2) * vb + r2
            w2 = jnp.max(jnp.where(act2 > 0.5, jnp.maximum(-val2, 0.0), 0.0),
                         axis=0)
            w = jnp.maximum(w, w2)
        return w

    return _bisect_accept(feasible_point, xk, viol, tol, viol_tol,
                          n_bisect, viol_of=viol_of)[0]


def phase1_coordinate_update(p, q, r, is_eq, active, xk, viol,
                             tol=DEFAULT_TOL, viol_tol=1e-2, n_bisect=40,
                             eq_idx=None):
    """Phase-1 coordinate solve for a restart batch, in float32.

    p, q, r, is_eq, active: (m, R); xk, viol: (R,).  Returns v (R,).

    eq_idx: optional static tuple of the equality-constraint row indices.
    When given, the reversed rows of inequality constraints (neutralized
    no-ops in the generic form) are skipped structurally and `is_eq` is
    ignored.  Semantics are identical for row-constant equality masks;
    `eq_idx=None` keeps the fully data-dependent form.
    """
    f32 = jnp.float32
    p, q, r = p.astype(f32), q.astype(f32), r.astype(f32)
    act = active.astype(f32)
    xk, viol = xk.astype(f32), viol.astype(f32)
    with jax.enable_x64(False):
        if eq_idx is None:
            return _phase1_update(p, q, r, is_eq.astype(f32), act, xk, viol,
                                  tol, viol_tol, n_bisect)
        if eq_idx:
            idx = jnp.asarray(eq_idx, jnp.int32)
            blk2 = (p[idx], q[idx], r[idx], act[idx])
        else:
            blk2 = (None,) * 4
        return _phase1_update_split(p, q, r, act, *blk2, xk, viol, tol,
                                    viol_tol, n_bisect)
