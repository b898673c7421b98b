"""Projection onto one (nonconvex) quadratic constraint set — the ADMM x-update.

Solves  argmin ||x - z||^2  s.t.  x^T P x + q^T x + r (relop) 0
exactly, via eigendecomposition + secular-equation bisection, batched over the
constraint axis (and vmappable over restarts) so the m per-iteration
projections the reference runs in a Python loop (reference: qcqp/qcqp.py:206-210,
235-238, author-marked `TODO: parallel` at qcqp.py:234) become two batched
matmuls plus lockstep elementwise iterations.

Method (reference: qcqp/utilities.py:149-196): rotate by the eigenbasis of P,
then the KKT stationarity gives xhat(nu) = (2 zhat - nu qhat) / (2 (1 + nu lmb))
and the scalar secular function phi(nu) = sum lmb xhat^2 + qhat xhat + r is
monotone decreasing on the bracket (-1/lmb_max, -1/lmb_min); bisection finds
its root.  Unbounded bracket sides use the reference's doubling search, here as
a capped masked while-loop.  `project_onecons_newton` replaces the bisection
with a fixed number of safeguarded Newton trips (the batched ADMM path on
the GPU; see its docstring).

The eigendecomposition of each P_i is computed once per problem
(`precompute_eigh`, the device-resident analog of the reference's `f.eigh`
cache, utilities.py:160-162) and reused across all ADMM iterations/restarts.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import QCQPForm

DEFAULT_TOL = 1e-6  # bisection tolerance (reference: utilities.py:149)
_MAX_DOUBLINGS = 60
NEWTON_TRIPS = 6     # trips of project_onecons_newton


class ConstraintEigh(NamedTuple):
    """Per-constraint eigendecompositions + rotated linear terms.

    lam:  (m, n) eigenvalues of P_i (ascending)
    Q:    (m, n, n) eigenvectors (columns)
    qhat: (m, n) Q_i^T q_i
    """
    lam: jax.Array
    Q: jax.Array
    qhat: jax.Array


def precompute_eigh(form: QCQPForm) -> ConstraintEigh:
    """Batched eigh of all constraint P_i — one-time setup, HBM-resident."""
    lam, Q = jnp.linalg.eigh(form.P[1:])
    qhat = jnp.einsum("mij,mi->mj", Q, form.q[1:])
    return ConstraintEigh(lam, Q, qhat)


def _phi(nu, lam, qhat, zhat, r):
    xhat = (2.0 * zhat - nu * qhat) / (2.0 * (1.0 + nu * lam))
    return jnp.sum(lam * xhat * xhat + qhat * xhat) + r, xhat


def _bracket(zhat, lam, qhat, r):
    """Root bracket (s, e) of the secular function, phi(s) >= 0 >= phi(e):
    the eigen-pole bounds, with unbounded sides found by the reference's
    doubling search (utilities.py:181-186) as a capped while-loop."""
    lmb_max = jnp.max(lam)
    lmb_min = jnp.min(lam)
    s_bounded = lmb_max > 0
    e_bounded = lmb_min < 0
    s0 = jnp.where(s_bounded, -1.0 / jnp.where(s_bounded, lmb_max, 1.0), -1.0)
    e0 = jnp.where(e_bounded, -1.0 / jnp.where(e_bounded, lmb_min, -1.0), 1.0)

    def dbl(carry):
        v, it = carry
        return v * 2.0, it + 1

    def dbl_s_cond(carry):
        s, it = carry
        p, _ = _phi(s, lam, qhat, zhat, r)
        return (~s_bounded) & (p <= 0) & (it < _MAX_DOUBLINGS)

    def dbl_e_cond(carry):
        e, it = carry
        p, _ = _phi(e, lam, qhat, zhat, r)
        return (~e_bounded) & (p >= 0) & (it < _MAX_DOUBLINGS)

    s0, _ = jax.lax.while_loop(dbl_s_cond, dbl, (s0, 0))
    e0, _ = jax.lax.while_loop(dbl_e_cond, dbl, (e0, 0))
    return s0, e0


@partial(jax.jit, static_argnames=("tol", "max_bisect"))
def project_onecons(z, lam, Q, qhat, r, is_eq, tol=DEFAULT_TOL, max_bisect=100):
    """Project point z onto {x : x^T P x + q^T x + r (relop) 0}.

    Single-constraint version; vmap over the leading constraint axis (and
    again over restarts) for the batched ADMM update.
    """
    zhat = Q.T @ z  # rotation; batched callers turn this into a matmul

    fz = jnp.sum(lam * zhat * zhat) + qhat @ zhat + r
    skip = (~is_eq) & (fz <= 0)  # fast path (reference: utilities.py:157-158)
    s0, e0 = _bracket(zhat, lam, qhat, r)

    def bisect(_, se):
        s, e = se
        do = (e - s) > tol  # reference stops at tol (utilities.py:187)
        mid = 0.5 * (s + e)
        p, _ = _phi(mid, lam, qhat, zhat, r)
        s = jnp.where(do & (p >= 0), mid, s)
        e = jnp.where(do & (p <= 0), mid, e)
        return s, e

    s, e = jax.lax.fori_loop(0, max_bisect, bisect, (s0, e0))
    nu = 0.5 * (s + e)
    _, xhat = _phi(nu, lam, qhat, zhat, r)
    x = Q @ xhat
    return jnp.where(skip, z, x)


@partial(jax.jit, static_argnames=("trips",))
def project_onecons_newton(z, lam, Q, qhat, r, is_eq, trips=NEWTON_TRIPS):
    """project_onecons with a fixed number of safeguarded Newton trips on
    the secular function in place of bisection to a tolerance.

    The bracket is first narrowed by nu = 0 (phi(0) = f(z) is already
    known).  Each trip evaluates phi and its closed-form derivative
    phi'(nu) = -2 sum (2 lam xhat + qhat) g / (2 (1 + nu lam))^2, with
    g = qhat + 2 lam zhat, narrows the bracket, and takes the Newton step
    when it stays inside, else the midpoint.  With few trips the projection
    is inexact where the root is far from the start; inside batched
    consensus ADMM from random starts that damps the overshoot on which
    exact projections limit-cycle (the x_i^2 = 1 rows of boolean least
    squares; PERF.md).
    """
    zhat = Q.T @ z
    fz = jnp.sum(lam * zhat * zhat) + qhat @ zhat + r
    skip = (~is_eq) & (fz <= 0)
    s0, e0 = _bracket(zhat, lam, qhat, r)
    s0 = jnp.where(fz > 0, jnp.maximum(s0, 0.0), s0)
    e0 = jnp.where(fz < 0, jnp.minimum(e0, 0.0), e0)
    g = qhat + 2.0 * lam * zhat

    def newton(_, carry):
        s, e, nu = carry
        den = 2.0 * (1.0 + nu * lam)
        inv = 1.0 / jnp.where(den == 0.0, 1e-30, den)
        xh = (2.0 * zhat - nu * qhat) * inv
        p = jnp.sum((lam * xh + qhat) * xh) + r
        dp = -2.0 * jnp.sum((2.0 * lam * xh + qhat) * g * inv * inv)
        s = jnp.where(p >= 0, nu, s)
        e = jnp.where(p <= 0, nu, e)
        cand = nu - p / dp
        inside = (cand > s) & (cand < e)          # False for NaN
        return s, e, jnp.where(inside, cand, 0.5 * (s + e))

    _, _, nu = jax.lax.fori_loop(0, trips, newton, (s0, e0, 0.5 * (s0 + e0)))
    _, xhat = _phi(nu, lam, qhat, zhat, r)
    return jnp.where(skip, z, Q @ xhat)


def project_all(zs, eigh: ConstraintEigh, r, is_eq, tol=DEFAULT_TOL):
    """Batched projection of zs (m, n) onto the m constraint sets."""
    return jax.vmap(
        lambda z, lam, Q, qhat, ri, ei: project_onecons(z, lam, Q, qhat, ri, ei, tol)
    )(zs, eigh.lam, eigh.Q, eigh.qhat, r, is_eq)
