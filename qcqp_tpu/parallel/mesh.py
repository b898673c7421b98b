"""Constraint-axis sharding: shard_map ADMM with explicit collectives.

The second parallel dimension the math exposes (SURVEY.md section 2c): the m
per-constraint ADMM projections are independent, so constraints shard across
devices and only the consensus z-update needs communication — one psum of the
local (sum x_i - sum u_i) partial sums per iteration.  This is the answer
to the reference's `TODO: parallel x/u-updates` (reference:
qcqp/qcqp.py:234) at the scale where one device is not enough (m in the
thousands).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import QCQPForm, max_violation
from ..kernels.projection import precompute_eigh, project_onecons


def _pad_constraints(form: QCQPForm, mult: int):
    """Pad the constraint axis to a multiple of `mult` with trivially
    satisfied dummy rows (||x||^2 <= 1e6 keeps the projection fast path)."""
    m, n = form.m, form.n
    m_pad = -(-m // mult) * mult
    if m_pad == m:
        return form, jnp.ones(m, bool)
    extra = m_pad - m
    Ppad = jnp.broadcast_to(jnp.eye(n, dtype=form.dtype), (extra, n, n))
    P_ = jnp.concatenate([form.P, Ppad])
    q_ = jnp.concatenate([form.q, jnp.zeros((extra, n), form.dtype)])
    r_ = jnp.concatenate([form.r, jnp.full((extra,), -1e6, form.dtype)])
    eq_ = jnp.concatenate([form.is_eq, jnp.zeros(extra, bool)])
    mask = jnp.concatenate([jnp.ones(m, bool), jnp.zeros(extra, bool)])
    return QCQPForm(P_, q_, r_, eq_), mask


def admm_phase1_sharded(form: QCQPForm, x0, mesh: Mesh, axis: str = "c",
                        tol: float = 1e-2, num_iters: int = 1000,
                        proj_tol: float = 1e-6):
    """Feasibility consensus ADMM with the constraint axis sharded over `axis`.

    Semantics match solvers.admm.admm_phase1; communication is one psum per
    iteration for the consensus mean (plus the violation check).
    """
    ndev = mesh.shape[axis]
    padded, mask = _pad_constraints(form, ndev)
    eigh = precompute_eigh(padded)
    m_true = form.m
    n = form.n

    lam, Q, qhat = eigh.lam, eigh.Q, eigh.qhat
    rcon, eqcon = padded.r[1:], padded.is_eq

    # violation check needs the unpadded form; keep it replicated (it is n^2
    # work, negligible vs the sharded projections)
    def local_step(lam_s, Q_s, qhat_s, r_s, eq_s, mask_s, x0):
        mloc = lam_s.shape[0]
        xs = jnp.broadcast_to(x0, (mloc, n))
        us = jnp.zeros((mloc, n), x0.dtype)
        z0 = x0

        def proj_all(vs):
            return jax.vmap(
                lambda v, l, Qi, qh, ri, ei: project_onecons(
                    v, l, Qi, qh, ri, ei, proj_tol)
            )(vs, lam_s, Q_s, qhat_s, r_s, eq_s)

        def cond(carry):
            z, xs, us, t = carry
            return (t < num_iters) & (max_violation(form, z) >= tol)

        def body(carry):
            z, xs, us, t = carry
            w = mask_s[:, None].astype(x0.dtype)
            local = jnp.sum(w * (xs - us), axis=0)
            z = jax.lax.psum(local, axis) / m_true
            proj = proj_all(z + us)
            xs = jnp.where(mask_s[:, None], proj, z[None, :])
            us = us + z - xs
            return z, xs, us, t + 1

        z, _, _, _ = jax.lax.while_loop(cond, body, (z0, xs, us, jnp.asarray(0)))
        return z

    from jax import shard_map
    spec_c = P(axis)
    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(spec_c, spec_c, spec_c, spec_c, spec_c, spec_c, P()),
        out_specs=P(),
        check_vma=False,
    )
    # `form` (closed over) is replicated; explicitly pass sharded operands.
    return fn(lam, Q, qhat, rcon, eqcon, mask[...,], x0)
