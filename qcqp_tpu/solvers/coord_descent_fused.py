"""Batched float32 coordinate descent: the routed CD improve paths.

Two batched paths share the reference's two-phase improve (reference:
qcqp/qcqp.py:101-192) and differ in how a coordinate step is computed:

  * "kernel": the two-phase sweep kernel (kernels/cd_sweep_pallas.py,
    Pallas through Triton), one program per block of restarts;
  * "percoord": phase 1 at the batch level with the (R, m+1, n) gradient
    cache and the batched slack bisection of kernels/onevar_batch.py per
    coordinate, then the vmapped phase 2 of solvers/coord_descent.py.  It
    takes any n and a traced equality pattern.

Float behavior: boundary comparisons carry a ~1e-6 relative slop (see
onevar_batch._canon_leq) and the parity contract with the float64 path is
statistical — identical acceptance rules, occasionally different accepted
slacks at ulp-tangency oracles.  Quality is asserted in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import QCQPForm
from ..kernels.onevar_batch import phase1_coordinate_update
from .coord_descent import coord_descent_phase2

N_BISECT = 40


def _refresh_batch(form: QCQPForm, xs):
    k, n = form.P.shape[0], form.P.shape[-1]
    # Explicit 2-D matmul (not einsum "kij,rj->rki"): XLA sometimes lowers
    # the einsum via a materialized (R, m+1, n, n) broadcast — 23 GB at the
    # bench shape — instead of a dot_general.
    G = (form.P.reshape(k * n, n) @ xs.T).reshape(k, n, -1)
    G = jnp.moveaxis(G, -1, 0)                          # (R, m+1, n)
    F = jnp.sum(G * xs[:, None, :], axis=-1) + xs @ form.q.T + form.r
    return G, F


def _viols_batch(form: QCQPForm, F):
    vals = F[:, 1:]
    v = jnp.where(form.is_eq[None, :], jnp.abs(vals), jnp.maximum(vals, 0.0))
    return jnp.max(v, axis=1, initial=0.0)


def coord_descent_phase1_fused(form: QCQPForm, xs, num_iters=1000,
                               viol_tol=1e-2, tol=1e-4, eq_idx=None):
    """Batched phase 1 (reference: qcqp/qcqp.py:101-148) with the batched
    slack bisection per coordinate.  xs: (R, n)."""
    R, n = xs.shape
    m = form.m
    Pdiag = jnp.diagonal(form.P, axis1=1, axis2=2)      # (m+1, n)
    eq_rows = jnp.broadcast_to(form.is_eq[:, None], (m, R))

    def coord_body(k, carry):
        x, G, F, alive, changed = carry
        xk = x[:, k]                                    # (R,)
        t2 = Pdiag[:, k]                                # (m+1,)
        Gk = G[:, :, k]                                 # (R, m+1)
        qk = form.q[:, k]                               # (m+1,)
        t1 = 2.0 * (Gk - t2[None, :] * xk[:, None]) + qk[None, :]
        t0 = (F - xk[:, None] * (2.0 * Gk + qk[None, :])
              + t2[None, :] * xk[:, None] ** 2)

        t1c = t1[:, 1:].T                               # (m, R)
        t0c = t0[:, 1:].T
        t2c = jnp.broadcast_to(t2[1:, None], (m, R))
        active = (t2c != 0) | (t1c != 0)

        vals = F[:, 1:].T                               # (m, R)
        viol_i = jnp.where(eq_rows, jnp.abs(vals), jnp.maximum(vals, 0.0))
        viol = jnp.max(jnp.where(active, viol_i, 0.0), axis=0)   # (R,)

        v = phase1_coordinate_update(
            t2c, t1c, t0c, eq_rows, active, xk, viol,
            tol=tol, viol_tol=viol_tol, n_bisect=N_BISECT,
            eq_idx=eq_idx).astype(x.dtype)
        v = jnp.where(alive, v, xk)
        accept = v != xk

        delta = v - xk                                  # (R,)
        Pk = jnp.take(form.P, k, axis=2)                # (m+1, n)
        G = G + delta[:, None, None] * Pk[None, :, :]
        F = t2[None, :] * v[:, None] ** 2 + t1 * v[:, None] + t0
        x = x.at[:, k].set(v)
        return x, G, F, alive, changed | accept

    def cond(carry):
        x, G, F, t, viol_last, changed = carry
        alive = (viol_last >= viol_tol) & changed
        return (t < num_iters) & jnp.any(alive)

    def body(carry):
        x, G, F, t, viol_last, changed = carry
        G, F = _refresh_batch(form, x)                   # drift control
        alive = (viol_last >= viol_tol) & changed
        x, G, F, _, changed_new = jax.lax.fori_loop(
            0, n, coord_body,
            (x, G, F, alive, jnp.zeros_like(changed)))
        viol = _viols_batch(form, F)
        return x, G, F, t + 1, viol, jnp.where(alive, changed_new, changed)

    G0, F0 = _refresh_batch(form, xs)
    init = (xs, G0, F0, jnp.asarray(0),
            jnp.full((R,), jnp.inf, xs.dtype), jnp.ones((R,), bool))
    x, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)
    return x


def static_eq_idx(form: QCQPForm):
    """The equality pattern as a static tuple, or None when it is traced."""
    try:
        return tuple(int(i) for i in np.nonzero(np.asarray(form.is_eq))[0])
    except jax.errors.TracerArrayConversionError:
        return None


def improve_coord_descent_fused(form: QCQPForm, xs, num_iters=1000,
                                viol_tol=1e-2, tol=1e-4, phase1=True,
                                path="kernel", interpret=False, eq_idx=None):
    """Batched two-phase CD on a float32 path ("kernel" or "percoord"; see
    the module docstring).  xs (R, n).

    "kernel" needs a static equality pattern:
    `eq_idx`, or `form.is_eq` concrete (the form built on the host and
    closed over or passed in at top level).  interpret=True runs the kernel
    in the Pallas interpreter (CPU tests).
    """
    if eq_idx is None:
        eq_idx = static_eq_idx(form)
    if path == "kernel" and eq_idx is None:
        raise ValueError(f"CD path {path!r} needs a static equality pattern")
    return _improve_cd_fused(form, xs, num_iters=num_iters,
                             viol_tol=viol_tol, tol=tol, phase1=phase1,
                             path=path, interpret=interpret,
                             eq_idx=None if eq_idx is None else tuple(eq_idx))


@partial(jax.jit, static_argnames=("num_iters", "viol_tol", "tol", "phase1",
                                   "path", "interpret", "eq_idx"))
def _improve_cd_fused(form: QCQPForm, xs, num_iters=1000,
                      viol_tol=1e-2, tol=1e-4, phase1=True, path="kernel",
                      interpret=False, eq_idx=None):
    if path == "kernel":
        from ..kernels.cd_sweep_pallas import two_phase_sweeps
        return two_phase_sweeps(
            form.P, form.q, form.r, eq_idx, xs, num_iters=num_iters,
            viol_tol=viol_tol, tol=tol, phase1=phase1,
            interpret=interpret).astype(xs.dtype)
    if path != "percoord":
        raise ValueError(f"unknown CD path {path!r}")
    if phase1:
        xs = coord_descent_phase1_fused(form, xs, num_iters, viol_tol, tol,
                                        eq_idx)
    from ..core import max_violation

    # Phase 2 gate (reference: qcqp/qcqp.py:189-190), batched.  NOT a vmapped
    # lax.cond: batching a cond broadcasts branch-closure constants per
    # restart (form.P becomes a (R, m+1, n, n) while-loop carry — 23 GB at
    # the bench shape).  Both branches of a batched cond execute anyway, so
    # running phase 2 for every restart and selecting by the feasibility
    # mask is the same work without the broadcast.
    feas = jax.vmap(lambda x: max_violation(form, x))(xs) < viol_tol
    x2 = jax.vmap(
        lambda x: coord_descent_phase2(form, x, num_iters, viol_tol, tol)
    )(xs)
    return jnp.where(feas[:, None], x2, xs)
