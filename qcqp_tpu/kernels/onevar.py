"""One-variable QCQP kernel: minimize a scalar quadratic over the feasible set
of m scalar quadratic constraints with slack s.

Fixed-shape redesign of the reference's interval machinery
(reference: qcqp/utilities.py:198-288).  The reference builds Python lists of
feasible intervals per constraint, sweeps sorted endpoints with a counter dict,
then scans interval endpoints for the best objective value.  None of that is
expressible as fixed-shape compiled code, so this kernel uses the equivalent
*candidate-point* formulation:

  The minimizer of a quadratic over a finite union/intersection of closed
  intervals is either the unconstrained vertex x0 = -q0/(2 p0) (p0 > 0), an
  endpoint of some constraint's feasible interval, or +-inf.  All interval
  endpoints are roots of p x^2 + q x + (r -+ s), so evaluating feasibility of
  the O(m) candidate roots against all m constraints (a fixed-shape (4m+3, m)
  masked broadcast) recovers the exact sweep-line answer.

Branch semantics (|p| <= tol handling, closed intervals, +-inf behavior) follow
the reference exactly (qcqp/utilities.py:209-231), including its quirk that a
constraint with |p|,|q| <= tol is "always feasible" regardless of r.

Deviations from the reference (documented per SURVEY.md section 2d):
  * ties and the degenerate constant-objective case are resolved
    deterministically (first candidate in order: vertex, finite roots, +-inf)
    instead of by `np.random.choice` (reference: qcqp/utilities.py:267,288);
    the parity contract is statistical, not bitwise.
  * `OneVarQuadraticFunction.eval` at +-inf with p=q=0 hits a NameError in the
    reference (utilities.py:119); here it correctly returns r.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

DEFAULT_TOL = 1e-4  # interval branch tolerance (reference: utilities.py:198)


class OneVarConstraints(NamedTuple):
    """m scalar quadratic constraints p x^2 + q x + r (relop) 0."""
    p: jax.Array       # (m,)
    q: jax.Array       # (m,)
    r: jax.Array       # (m,)
    is_eq: jax.Array   # (m,) bool
    active: jax.Array  # (m,) bool; inactive constraints are always feasible


def qeval_ext(p, q, r, x):
    """Evaluate p x^2 + q x + r with IEEE-safe +-inf handling.

    At x = +-inf the dominant term decides the sign (reference:
    qcqp/utilities.py:115-120, with the bare-`r` NameError fixed).
    """
    p, q, r, x = map(jnp.asarray, (p, q, r, x))
    finite = x * (p * x + q) + r
    inf = jnp.asarray(jnp.inf, dtype=finite.dtype)
    infval = jnp.where(
        p != 0,
        jnp.sign(p) * inf,
        jnp.where(q != 0, jnp.sign(q) * jnp.sign(x) * inf, r),
    )
    return jnp.where(jnp.isinf(x), infval, finite)


def feasible_ineq(x, p, q, c, tol=DEFAULT_TOL):
    """Is x in the solution set of p x^2 + q x + c <= 0?

    Mirrors the interval case split of the reference
    (qcqp/utilities.py:209-231) as masked arithmetic, including closed
    endpoints and the always-feasible |p|,|q| <= tol branch.
    """
    p, q, c, x = map(jnp.asarray, (p, q, c, x))
    D = q * q - 4.0 * p * c
    rD = jnp.sqrt(jnp.maximum(D, 0.0))
    two_p = 2.0 * p
    lo = (-q - rD) / two_p
    hi = (-q + rD) / two_p
    # p > tol: single interval [lo, hi] (empty if D < 0).
    feas_pos = (D >= 0) & (x >= lo) & (x <= hi)
    # p < -tol: complement-ish pair (-inf, hi] u [lo, +inf) (note 2p < 0 flips
    # the root order so `hi` is the smaller); always feasible if D < 0.
    feas_neg = (D < 0) | (x <= hi) | (x >= lo)
    # |p| <= tol: linear or constant.
    xlin = -c / q
    feas_lin = jnp.where(
        q > tol, x <= xlin, jnp.where(q < -tol, x >= xlin, True)
    )
    return jnp.where(p > tol, feas_pos, jnp.where(p < -tol, feas_neg, feas_lin))


def branch_roots(p, q, c, tol=DEFAULT_TOL):
    """Boundary points of {p x^2 + q x + c <= 0} under the same branch rules.

    Returns two candidates (NaN where the branch yields none).
    """
    p, q, c = map(jnp.asarray, (p, q, c))
    D = q * q - 4.0 * p * c
    rD = jnp.sqrt(jnp.maximum(D, 0.0))
    r1 = (-q - rD) / (2.0 * p)
    r2 = (-q + rD) / (2.0 * p)
    quad_ok = (jnp.abs(p) > tol) & (D >= 0)
    rlin = -c / q
    lin_ok = (jnp.abs(p) <= tol) & (jnp.abs(q) > tol)
    nan = jnp.full_like(p, jnp.nan)
    c1 = jnp.where(quad_ok, r1, jnp.where(lin_ok, rlin, nan))
    c2 = jnp.where(quad_ok, r2, jnp.where(lin_ok, rlin, nan))
    return c1, c2


def _feasible_all(x, con: OneVarConstraints, s, tol):
    """Feasibility of scalar points x (...,) against all m constraints -> (...)."""
    xx = x[..., None]
    f_le = feasible_ineq(xx, con.p, con.q, con.r - s, tol)
    f_hi = feasible_ineq(xx, -con.p, -con.q, -con.r - s, tol)
    feas_i = jnp.where(con.is_eq, f_le & f_hi, f_le)
    feas_i = jnp.where(con.active, feas_i, True)
    return jnp.all(feas_i, axis=-1)


def onevar_qcqp_impl(p0, q0, r0, con: OneVarConstraints, s, tol=DEFAULT_TOL,
                     x_cur=None):
    """Solve  min p0 x^2 + q0 x + r0  s.t.  p_i x^2 + q_i x + r_i (relop_i) s.

    ('==' means |.| <= s, as in the reference onevar_qcqp,
    qcqp/utilities.py:235-288.)

    `x_cur` (optional) breaks exact objective ties by proximity to the current
    coordinate value.  This matters for the degenerate constant objective of
    coordinate-descent phase 1, where every feasible candidate ties: the
    reference samples a random feasible point (utilities.py:267), which keeps
    restart diversity; a fixed-order tie-break would collapse all restarts to
    the same point.  Proximal tie-breaking is the deterministic equivalent.

    Returns (x_star, feasible): feasible=False means the constraint set is
    empty (the reference returns None); x_star is then meaningless.
    """
    # Unconstrained vertex — exact p0 > 0 test as in the reference (:270).
    x0 = jnp.where(p0 > 0, -q0 / (2.0 * p0), jnp.nan)

    lo_roots = branch_roots(con.p, con.q, con.r - s, tol)     # level set f = s
    hi_roots = branch_roots(con.p, con.q, con.r + s, tol)     # level set f = -s (eq only)
    hi_roots = tuple(jnp.where(con.is_eq, c, jnp.nan) for c in hi_roots)
    dt = jnp.result_type(p0, con.p)
    inf = jnp.asarray([jnp.inf], dtype=dt)
    cands = jnp.concatenate(
        [x0[None], lo_roots[0], lo_roots[1], hi_roots[0], hi_roots[1], -inf, inf]
    )

    feas = _feasible_all(cands, con, s, tol) & ~jnp.isnan(cands)
    any_feas = jnp.any(feas)

    vals = qeval_ext(p0, q0, r0, cands)
    vals = jnp.where(feas & ~jnp.isnan(vals), vals, jnp.inf)
    if x_cur is None:
        best = jnp.argmin(vals)  # ties -> earliest: vertex first, +-inf last
    else:
        vmin = jnp.min(vals)
        tied = vals == vmin
        dist = jnp.where(tied, jnp.abs(cands - x_cur), jnp.inf)
        # NaN distances (inf - inf) lose; an all-inf row falls back to argmin.
        dist = jnp.where(jnp.isnan(dist), jnp.inf, dist)
        best = jnp.where(jnp.isfinite(vmin) | jnp.any(jnp.isfinite(dist)),
                         jnp.argmin(dist), jnp.argmin(vals))
    return cands[best], any_feas


onevar_qcqp = jax.jit(onevar_qcqp_impl, static_argnames=("tol",))


def left_endpoints(p, q, c, tol=DEFAULT_TOL):
    """Finite left endpoints of {p x^2 + q x + c <= 0} under the branch rules.

    Each branch contributes at most one finite left endpoint:
      p > tol, D >= 0 : (-q - sqrt(D)) / (2p)        (the [lo, hi] interval)
      p < -tol, D >= 0: (-q - sqrt(D)) / (2p)        (the [b, +inf) branch)
      |p| <= tol, q < -tol : -c / q                  (the [x0, +inf) ray)
    Everything else has -inf as its only left endpoint.
    """
    p, q, c = map(jnp.asarray, (p, q, c))
    D = q * q - 4.0 * p * c
    rD = jnp.sqrt(jnp.maximum(D, 0.0))
    quad = (jnp.abs(p) > tol) & (D >= 0)
    lin = (jnp.abs(p) <= tol) & (q < -tol)
    nan = jnp.full_like(p, jnp.nan)
    return jnp.where(quad, (-q - rD) / (2.0 * p),
                     jnp.where(lin, -c / q, nan))


def phase1_feasible_point(con: OneVarConstraints, s, x_cur, tol=DEFAULT_TOL):
    """Feasible point at slack s for the degenerate-objective phase-1 case.

    A nonempty intersection either contains -inf or has its infimum at some
    constraint's finite left endpoint, so (2m+1) candidates suffice — half
    the work of the general onevar candidate set.  Ties break proximally to
    x_cur (same policy as onevar_qcqp_impl).

    Returns (x, exists).
    """
    lo1 = left_endpoints(con.p, con.q, con.r - s, tol)
    # the '==' second side is the *negated* set {-p x^2 - q x - r - s <= 0};
    # its left endpoints differ from the roots' natural order
    lo2 = left_endpoints(-con.p, -con.q, -con.r - s, tol)
    lo2 = jnp.where(con.is_eq, lo2, jnp.nan)
    ninf = jnp.full((1,), -jnp.inf, dtype=con.p.dtype)
    cands = jnp.concatenate([lo1, lo2, ninf])
    feas = _feasible_all(cands, con, s, tol) & ~jnp.isnan(cands)
    exists = jnp.any(feas)
    dist = jnp.where(feas, jnp.abs(cands - x_cur), jnp.inf)
    dist = jnp.where(jnp.isnan(dist), jnp.inf, dist)
    any_finite = jnp.any(jnp.isfinite(dist))
    best = jnp.where(any_finite, jnp.argmin(dist), jnp.argmax(feas))
    return cands[best], exists


def feasible_exists(con: OneVarConstraints, s, tol=DEFAULT_TOL):
    """Is the intersection of the m constraint sets at slack s nonempty?

    Used by the phase-1 slack bisection: the intersection is nonempty iff one
    of the candidate boundary points (or +-inf) is feasible.
    Returns (witness, exists).
    """
    lo_roots = branch_roots(con.p, con.q, con.r - s, tol)
    hi_roots = branch_roots(con.p, con.q, con.r + s, tol)
    hi_roots = tuple(jnp.where(con.is_eq, c, jnp.nan) for c in hi_roots)
    dt = con.p.dtype
    inf = jnp.asarray([jnp.inf], dtype=dt)
    cands = jnp.concatenate(
        [lo_roots[0], lo_roots[1], hi_roots[0], hi_roots[1], -inf, inf]
    )
    feas = _feasible_all(cands, con, s, tol) & ~jnp.isnan(cands)
    # Prefer finite witnesses (earliest feasible candidate).
    idx = jnp.argmax(feas)
    return cands[idx], jnp.any(feas)
