"""Penalty convex-concave procedure — the device-native DCCP replacement.

The reference delegates this improve method to the external DCCP package,
which rebuilds a CVXPY problem per call and solves each convexified
subproblem with a native conic solver (reference: qcqp/qcqp.py:288-322).
Here the whole procedure is jitted JAX:

  * the difference-of-convex split f_i = f1_i - f2_i is closed form
    (core.dc_split, mirroring qcqp/utilities.py:72-92);
  * each CCP iteration linearizes the concave parts at x_k and solves the
    penalized convex subproblem

        minimize  fhat0(x) + tau * sum_b max(0, ghat_b(x))

    by consensus proximal splitting: the objective block is a closed-form
    quadratic prox in the eigenbasis of P1_0 (precomputed once), and each
    hinge block's prox is an exact 1-D multiplier bisection in the eigenbasis
    of its PSD quadratic — the same rotate/bisect machinery as the ADMM
    projection kernel, batched over blocks;
  * equality constraints follow the standard convex-concave treatment:
    f = 0 becomes the two hinge blocks (f1 - lin f2 <= 0) and
    (f2 - lin f1 <= 0).  For uniform (jit-static) shapes every constraint
    gets both direction blocks, with the negative block inert for
    inequalities;
  * tau grows by mu each iteration up to tau_max.  Defaults follow the DCCP
    package (tau=0.005, tau_max=1e8) except mu=1.4 instead of DCCP's 1.2 —
    a deliberate deviation: with the fixed 60-iteration jitted schedule the
    faster growth reaches the feasibility-enforcing tau range the package's
    unbounded Python loop reaches with mu=1.2 (pinned by the golden-example
    tests, tests/test_api_examples.py).

The result is folded in with `better` like the reference does on DCCP
convergence (qcqp.py:318-319).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import QCQPForm, better, dc_split, dc_split_eigen, max_violation


class CCPData(NamedTuple):
    """Static per-form data: DC splits + eigenbases of all PSD block matrices."""
    P1: jax.Array        # (m+1, n, n) convex parts
    P2: jax.Array        # (m+1, n, n) concave parts (as PSD matrices)
    lam1: jax.Array      # (m+1, n) eigvals of P1
    V1: jax.Array        # (m+1, n, n) eigvecs of P1
    lam2: jax.Array      # (m+1, n)
    V2: jax.Array        # (m+1, n, n)


def precompute_ccp(form: QCQPForm, use_eigen_split: bool = False) -> CCPData:
    P1, P2 = (dc_split_eigen(form) if use_eigen_split else dc_split(form))
    lam1, V1 = jnp.linalg.eigh(P1)
    lam2, V2 = jnp.linalg.eigh(P2)
    return CCPData(P1, P2, jnp.maximum(lam1, 0.0), V1,
                   jnp.maximum(lam2, 0.0), V2)


def _hinge_prox(v, lam, V, qb, rb, weight, rho, n_newton=15):
    """argmin_x  weight * max(0, g(x)) + rho/2 ||x - v||^2
    for convex g(x) = x' diag-form x + qb' x + rb given in eigenbasis (lam, V).

    The multiplier root g(x(nu)) = 0 on nu in (0, weight) is found by
    FIXED-count safeguarded Newton instead of a 60-trip bisection: each trip
    hauls (B, R, n)-shaped intermediates through device memory under the
    vmapped batch, so the trip count is the cost.  Newton uses the
    closed-form derivative dg/dnu = -rho sum (2 lam x + qt)(qt + 2 lam vt)
    / den^2 and falls back to the bracket midpoint when the step leaves
    (s, e) — worst case a bisection, typically f32-exact in ~6 trips.
    """
    vt = V.T @ v
    qt = V.T @ qb

    def g_of(xt):
        return jnp.sum(lam * xt * xt) + qt @ xt + rb

    def x_of(nu):
        return (rho * vt - nu * qt) / (rho + 2.0 * nu * lam)

    g_v = g_of(vt)
    x_full = x_of(weight)
    g_full = g_of(x_full)

    g0 = qt + 2.0 * lam * vt               # nu-independent derivative part

    def body(_, cr):
        s, e, nu = cr
        den = rho + 2.0 * nu * lam
        den = jnp.where(den == 0.0, 1e-30, den)
        x = (rho * vt - nu * qt) / den
        g = jnp.sum(lam * x * x) + qt @ x + rb
        dg = -rho * jnp.sum((2.0 * lam * x + qt) * g0 / (den * den))
        s = jnp.where(g > 0, nu, s)        # root right of nu
        e = jnp.where(g <= 0, nu, e)
        cand = nu - g / dg
        # CLOSED interval: at convergence cand == nu == s (or e) exactly,
        # and an open-interval test would reject the converged iterate and
        # kick it to the safeguard point (seen in traces).  False for NaN.
        inside = (cand >= s) & (cand <= e)
        # Safeguard: work in LOG space — the penalty weight spans up to
        # tau_max=1e8 while the root can sit at nu ~ 1e-2, and an
        # arithmetic midpoint needs ~60 halvings to cross that range (the
        # failure mode that made the plain-midpoint Newton drift on the
        # golden examples).  With a positive lower bound, step to the
        # geometric mean (halves the log gap); while s == 0, probe at
        # e/1024 (covers 2^150 of dynamic range within the trip budget).
        mid = jnp.where(s > 0.0, jnp.sqrt(s * e), e * (1.0 / 1024.0))
        nu = jnp.where(inside, cand, mid)
        return s, e, nu

    zero = jnp.zeros_like(weight)
    _, _, nu_f = jax.lax.fori_loop(0, n_newton, body,
                                   (zero, weight, 0.5 * weight))
    x_root = x_of(nu_f)

    xt = jnp.where(g_v <= 0, vt, jnp.where(g_full >= 0, x_full, x_root))
    return V @ xt


def _obj_prox(v, lam, V, qhat, rho):
    """argmin_x  x'P1_0 x + qhat'x + rho/2||x - v||^2 (eigenbasis closed form)."""
    vt = V.T @ v
    qt = V.T @ qhat
    xt = (rho * vt - qt) / (rho + 2.0 * lam)
    return V @ xt


@partial(jax.jit, static_argnames=("max_iter", "inner_iters", "use_eigen_split"))
def improve_ccp(form: QCQPForm, x0, tau=0.005, mu=1.4, tau_max=1e8,
                max_iter=60, inner_iters=200, rho=1.0,
                use_eigen_split=False, data: CCPData = None,
                stall_tol=1e-6, inner_tol=1e-7, viol_exit_tol=1e-4):
    """Penalty CCP improve (replaces reference DCCP, qcqp/qcqp.py:288-322).

    Early exit: the outer loop stops once the iterate
    stalls (|x_{k+1}-x_k| < stall_tol relative) AND the point is feasible to
    viol_exit_tol (or tau has saturated at tau_max, where growing the
    penalty can no longer move it); the inner splitting stops when the
    consensus residual max_b |x_b - z| drops below inner_tol relative.  Both
    are while_loops, so cost scales with the iterations actually used
    instead of the fixed 60 x 200 schedule (the DCCP package's Python loop
    also exits on convergence).  max_iter/inner_iters stay as caps."""
    if data is None:
        data = precompute_ccp(form, use_eigen_split)
    m, n = form.m, form.n
    dt = x0.dtype
    q_all, r_all = form.q, form.r
    is_eq = form.is_eq

    # Block layout (static shapes): 0 objective; 1..m positive-direction
    # hinges; m+1..2m negative-direction hinges (inert for inequalities).
    B = 2 * m + 1

    def ccp_iteration(carry):
        xk, tau_k, it, done = carry
        # Stiffness-matched coupling: as the hinge weight tau grows, the
        # consensus penalty must grow with it or the inner splitting stalls
        # (empirically sqrt(tau) balances the objective block's curvature).
        rho_k = rho * jnp.maximum(1.0, jnp.sqrt(tau_k))

        # Linearize concave parts at xk.
        P2x = jnp.einsum("kij,j->ki", data.P2, xk)       # (m+1, n)
        P1x = jnp.einsum("kij,j->ki", data.P1, xk)
        xP2x = P2x @ xk                                   # (m+1,)
        xP1x = P1x @ xk

        # objective block: fhat0 = x'P1_0 x + (q0 - 2 P2_0 xk)'x + const
        q0_hat = q_all[0] - 2.0 * P2x[0]

        # positive hinges (rows 1..m): g+ = x'P1 x + (q - 2 P2 xk)'x
        #                                   + (r + xk'P2 xk)
        qp = q_all[1:] - 2.0 * P2x[1:]
        rp = r_all[1:] + xP2x[1:]
        # negative hinges: g- = x'P2 x + (-q - 2 P1 xk)'x + (-r + xk'P1 xk)
        qm = -q_all[1:] - 2.0 * P1x[1:]
        rm = -r_all[1:] + xP1x[1:]
        # inert negative blocks for inequality rows: g- == -1 (never active)
        qm = jnp.where(is_eq[:, None], qm, 0.0)
        rm = jnp.where(is_eq, rm, -1.0)
        lam_m = jnp.where(is_eq[:, None], data.lam2[1:], 0.0)

        # consensus proximal splitting over B blocks, with a residual exit
        def inner_cond(carry):
            z, xs, us, t, res = carry
            return (t < inner_iters) & (res > inner_tol)

        def inner(carry):
            z_prev, xs, us, t, _ = carry
            z = z_prev
            vs = z[None, :] - us  # (B, n)
            x_obj = _obj_prox(vs[0], data.lam1[0], data.V1[0], q0_hat, rho_k)
            x_pos = jax.vmap(
                lambda v, lam, V, qb, rb: _hinge_prox(
                    v, lam, V, qb, rb, tau_k, rho_k)
            )(vs[1:m + 1], data.lam1[1:], data.V1[1:], qp, rp)
            x_neg = jax.vmap(
                lambda v, lam, V, qb, rb: _hinge_prox(
                    v, lam, V, qb, rb, tau_k, rho_k)
            )(vs[m + 1:], lam_m, data.V2[1:], qm, rm)
            xs = jnp.concatenate([x_obj[None], x_pos, x_neg])
            z = jnp.mean(xs + us, axis=0)
            us = us + xs - z[None, :]
            # ADMM convergence needs BOTH residuals: blocks agreeing with z
            # (primal) AND z itself stationary (dual ~ rho |z - z_prev|) —
            # primal alone goes tiny while z still drifts toward the
            # subproblem optimum at O(1/rho) per trip.
            scale = 1.0 + jnp.max(jnp.abs(z))
            res = jnp.maximum(jnp.max(jnp.abs(xs - z[None, :])),
                              jnp.max(jnp.abs(z - z_prev))) / scale
            return z, xs, us, t + 1, res

        xs0 = jnp.broadcast_to(xk, (B, n))
        us0 = jnp.zeros((B, n), dt)
        big = jnp.asarray(jnp.inf, dt)
        z, _, _, _, _ = jax.lax.while_loop(
            inner_cond, inner, (xk, xs0, us0, jnp.asarray(0), big))
        tau_next = jnp.minimum(tau_k * mu, tau_max)

        dx = jnp.linalg.norm(z - xk)
        stalled = dx < stall_tol * (1.0 + jnp.linalg.norm(xk))
        feas = max_violation(form, z) < viol_exit_tol
        finished = stalled & (feas | (tau_k >= 0.999 * tau_max))
        return z, tau_next, it + 1, finished

    def ccp_cond(carry):
        xk, tau_k, it, done = carry
        return (it < max_iter) & ~done

    x_fin, _, _, _ = jax.lax.while_loop(
        ccp_cond, ccp_iteration,
        (x0, jnp.asarray(tau, dt), jnp.asarray(0), jnp.asarray(False)))
    return better(form, x0, x_fin)
