"""Consensus ADMM improve method, fully batched and jitted.

Re-architecture of the reference driver (reference: qcqp/qcqp.py:195-285):
phase 1 runs feasibility-only consensus (z = mean of per-constraint copies);
phase 2 adds the objective through a pre-factorized z-update.  The m
per-constraint projections that the reference runs in a Python loop (the
author's `TODO: parallel x/u-updates`, qcqp.py:234) are one batched
eigh-rotate-bisect-rotate kernel here (kernels/projection.py), so each ADMM
iteration is two (m,n,n)x(m,n) batched matmuls plus lockstep scalar work —
matmul-shaped, and vmappable over restarts on top.

The z-update factorization of 2 (P0 + rho m I) is a dense Cholesky computed
once per rho (the device analog of the reference's cached SuperLU
factorization, qcqp.py:224-227), reused inside the jitted while-loop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core import QCQPForm, better, max_violation
from ..kernels.projection import (ConstraintEigh, precompute_eigh,
                                  project_onecons, project_onecons_newton)


def _project_batch(vs, eigh: ConstraintEigh, r, is_eq, tol, trips=None):
    """The m projections: bisection to `tol` (the reference's), or `trips`
    fixed safeguarded Newton trips when trips is not None."""
    if trips is None:
        proj = lambda v, lam, Q, qhat, ri, ei: project_onecons(
            v, lam, Q, qhat, ri, ei, tol)
    else:
        proj = lambda v, lam, Q, qhat, ri, ei: project_onecons_newton(
            v, lam, Q, qhat, ri, ei, trips)
    return jax.vmap(proj)(vs, eigh.lam, eigh.Q, eigh.qhat, r, is_eq)


def admm_phase1(form: QCQPForm, eigh: ConstraintEigh, x0, tol=1e-2, num_iters=1000,
                proj_tol=1e-6, proj_trips=None):
    """Feasibility consensus (reference: qcqp/qcqp.py:195-212)."""
    m = form.m
    xs0 = jnp.broadcast_to(x0, (m, form.n))
    us0 = jnp.zeros((m, form.n), x0.dtype)
    rcon, eqcon = form.r[1:], form.is_eq

    def cond(carry):
        z, xs, us, t = carry
        return (t < num_iters) & (max_violation(form, z) >= tol)

    def body(carry):
        z, xs, us, t = carry
        z = (jnp.sum(xs, 0) - jnp.sum(us, 0)) / m
        xs = _project_batch(z + us, eigh, rcon, eqcon, proj_tol, proj_trips)
        us = us + z - xs
        return z, xs, us, t + 1

    z, _, _, _ = jax.lax.while_loop(cond, body, (x0, xs0, us0, jnp.asarray(0)))
    return z


def admm_phase2(form: QCQPForm, eigh: ConstraintEigh, x0, rho, tol=1e-2,
                num_iters=1000, viol_lim=1e4, proj_tol=1e-6, better_tol=1e-4,
                proj_trips=None):
    """Objective consensus (reference: qcqp/qcqp.py:215-251).

    Iteration-ordering parity notes: the convergence / divergence breaks fire
    *before* the best-point tracker absorbs the current z (qcqp.py:241-250),
    so a converged final z is deliberately not folded into bestx.
    """
    m, n = form.m, form.n
    P0, q0 = form.P[0], form.q[0]
    lhs = 2.0 * (P0 + rho * m * jnp.eye(n, dtype=x0.dtype))
    chol = jax.scipy.linalg.cho_factor(lhs)
    rcon, eqcon = form.r[1:], form.is_eq

    xs0 = jnp.broadcast_to(x0, (m, n))
    us0 = jnp.zeros((m, n), x0.dtype)

    def cond(carry):
        z, xs, us, last_z, bestx, t, done = carry
        return (t < num_iters) & ~done

    def body(carry):
        z, xs, us, last_z, bestx, t, done = carry
        rhs = 2.0 * rho * (jnp.sum(xs, 0) - jnp.sum(us, 0)) - q0
        z = jax.scipy.linalg.cho_solve(chol, rhs)
        xs = _project_batch(z + us, eigh, rcon, eqcon, proj_tol, proj_trips)
        us = us + z - xs

        converged = (t > 0) & (jnp.linalg.norm(last_z - z) < tol)
        maxviol = max_violation(form, z)
        diverged = maxviol > viol_lim
        take = ~(converged | diverged)
        bestx = jnp.where(take, better(form, z, bestx, better_tol), bestx)
        return z, xs, us, z, bestx, t + 1, converged | diverged

    init = (x0, xs0, us0, x0, x0, jnp.asarray(0), jnp.asarray(False))
    _, _, _, _, bestx, _, _ = jax.lax.while_loop(cond, body, init)
    return bestx


def _unconstrained_improve(form: QCQPForm, x0):
    """ADMM degenerates for m == 0 (the reference divides by m and crashes,
    qcqp.py:205,277 — quirk not replicated): the consensus is vacuous, so
    return the closed-form unconstrained objective minimum when P0 is
    convex, else x0 unchanged (a nonconvex unconstrained objective is
    unbounded; mirroring the swallowed-failure convention)."""
    lmb, Q = jnp.linalg.eigh(form.P[0])
    ok = jnp.min(lmb) > 1e-10
    lam_safe = jnp.where(lmb > 1e-10, lmb, 1.0)
    xstar = -0.5 * (Q @ ((Q.T @ form.q[0]) / lam_safe))
    return jnp.where(ok, better(form, x0, xstar), x0)


def auto_rho(form: QCQPForm):
    """Reference auto-rho heuristic (qcqp/qcqp.py:270-278)."""
    lmb = jnp.linalg.eigvalsh(form.P[0])
    lmb_min = jnp.min(lmb)
    rho = jnp.where(lmb_min < 0, 2.0 * (1.0 - lmb_min) / form.m, 1.0 / form.m)
    return rho * 50.0


def min_valid_rho(form: QCQPForm):
    """Smallest rho keeping the z-update convex: lmb_min(P0) + m rho >= 0
    (reference validation: qcqp/qcqp.py:261-268)."""
    lmb_min = jnp.min(jnp.linalg.eigvalsh(form.P[0]))
    return -lmb_min / form.m


@partial(jax.jit, static_argnames=("num_iters", "viol_lim", "tol", "phase1",
                                   "proj_trips"))
def improve_admm(form: QCQPForm, x0, rho=None, num_iters=1000, viol_lim=1e4,
                 tol=1e-2, phase1=True, eigh: Optional[ConstraintEigh] = None,
                 proj_trips=None):
    """Full ADMM improve (reference: qcqp/qcqp.py:254-285).

    rho validation against min_valid_rho is the caller's (api layer's) job —
    it raises host-side, which has no place inside a jitted loop.
    proj_trips=None projects by bisection to 1e-6 (the reference); an int
    projects with that many Newton trips (routing.admm_proj_trips).
    """
    if form.m == 0:                      # static shape property
        return _unconstrained_improve(form, x0)
    if eigh is None:
        eigh = precompute_eigh(form)
    if rho is None:
        rho = auto_rho(form)
    if phase1:
        x1 = better(form, x0, admm_phase1(form, eigh, x0, tol, num_iters,
                                          proj_trips=proj_trips))
    else:
        x1 = x0
    x2 = better(form, x1, admm_phase2(form, eigh, x1, rho, tol, num_iters,
                                      viol_lim, proj_trips=proj_trips))
    return x2


@partial(jax.jit, static_argnames=("num_iters", "viol_lim", "tol", "phase1",
                                   "proj_trips"))
def improve_admm_batch(form: QCQPForm, xs, rho=None, num_iters=1000, viol_lim=1e4,
                       tol=1e-2, phase1=True, proj_trips=None):
    """vmap over a leading restart axis; the eigh precompute is shared."""
    if form.m == 0:
        return jax.vmap(lambda x: _unconstrained_improve(form, x))(xs)
    eigh = precompute_eigh(form)
    if rho is None:
        rho = auto_rho(form)
    return jax.vmap(
        lambda x: improve_admm(form, x, rho, num_iters, viol_lim, tol, phase1,
                               eigh=eigh, proj_trips=proj_trips)
    )(xs)
