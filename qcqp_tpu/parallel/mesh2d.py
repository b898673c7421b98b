"""2-D mesh program: restarts x constraints sharded in one jitted step.

Combines the two parallel dimensions the math exposes (SURVEY.md section 2c):
the restart axis (each suggest->improve chain independent) shards over one
mesh axis, and the m per-constraint ADMM projections — the reference's
`TODO: parallel x/u-updates` (reference: qcqp/qcqp.py:234) — shard over the
other.  Per iteration the only cross-device traffic is one psum of the local
consensus partial sums over the constraint axis; restarts never
communicate until the final lexicographic best-point reduction.

Use when m is large enough that one chip's projection throughput is the
bottleneck (thousands of constraints) while restart fan-out is still wanted:
a (nr, nc) mesh gives each device R/nr restarts x m/nc constraints.

Semantics match solvers.admm.improve_admm (phase 1 feasibility consensus,
phase 2 objective consensus with best-point tracking, reference:
qcqp/qcqp.py:195-285) batched over local restarts with per-restart
convergence freezing.
"""

from __future__ import annotations

from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import settings as s
from ..core import QCQPForm, better, max_violation
from ..kernels.projection import precompute_eigh, project_onecons
from ..solvers.admm import auto_rho
from .mesh import _pad_constraints
from .restarts import best_point, suggest_batch


def make_mesh_2d(nr: int, nc: int, devices: Optional[list] = None,
                 r_axis: str = "r", c_axis: str = "c") -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if nr * nc > len(devs):
        raise ValueError(f"need {nr * nc} devices, have {len(devs)}")
    grid = np.array(devs[: nr * nc]).reshape(nr, nc)
    return Mesh(grid, (r_axis, c_axis))


def improve_admm_2d(form: QCQPForm, xs: jax.Array, mesh: Mesh,
                    r_axis: str = "r", c_axis: str = "c",
                    rho=None, num_iters: int = 1000, viol_lim: float = 1e4,
                    tol: float = 1e-2, phase1: bool = True,
                    proj_tol: float = 1e-6, better_tol: float = 1e-4):
    """ADMM improve for a restart batch on a 2-D mesh.

    xs: (R, n) starting points; R must divide by mesh.shape[r_axis] (the
    caller pads).  Returns improved points (R, n), sharded over r_axis.
    """
    nr, nc = mesh.shape[r_axis], mesh.shape[c_axis]
    R, n = xs.shape
    if R % nr:
        raise ValueError(f"R={R} not a multiple of the restart mesh axis {nr}")
    padded, mask = _pad_constraints(form, nc)
    eigh = precompute_eigh(padded)
    if rho is None:
        rho = auto_rho(form)
    rho = jnp.asarray(rho, form.dtype)
    m_true = form.m
    P0, q0 = form.P[0], form.q[0]

    def local(lam, Q, qhat, rcon, eqcon, w, xs_blk):
        """One device's shard: lam (ml, n), Q (ml, n, n), qhat (ml, n),
        rcon/eqcon/w (ml,), xs_blk (Rl, n)."""
        ml = lam.shape[0]
        Rl = xs_blk.shape[0]
        wcol = w.astype(xs_blk.dtype)[None, :, None]        # (1, ml, 1)

        def proj_all(vs):
            """vs (Rl, ml, n) -> projections, padded rows pass through."""
            proj = jax.vmap(jax.vmap(
                lambda v, l, Qi, qh, ri, ei: project_onecons(
                    v, l, Qi, qh, ri, ei, proj_tol),
                in_axes=(0, 0, 0, 0, 0, 0)),
                in_axes=(0, None, None, None, None, None))(
                    vs, lam, Q, qhat, rcon, eqcon)
            return jnp.where(w[None, :, None] > 0, proj, vs)

        def consensus(xs_c, us_c):
            local_sum = jnp.sum(wcol * (xs_c - us_c), axis=1)   # (Rl, n)
            return jax.lax.psum(local_sum, c_axis) / m_true

        viol_b = jax.vmap(lambda z: max_violation(form, z))

        # ---- phase 1: feasibility consensus (qcqp/qcqp.py:195-212) --------
        def run_phase1(z0):
            xs_c = jnp.broadcast_to(z0[:, None, :], (Rl, ml, n))
            us_c = jnp.zeros((Rl, ml, n), z0.dtype)

            def cond(carry):
                z, xs_c, us_c, t = carry
                return (t < num_iters) & (jnp.max(viol_b(z)) >= tol)

            def body(carry):
                z, xs_c, us_c, t = carry
                alive = (viol_b(z) >= tol)[:, None]             # (Rl, 1)
                zn = consensus(xs_c, us_c)
                proj = proj_all(zn[:, None, :] + us_c)
                usn = us_c + zn[:, None, :] - proj
                z = jnp.where(alive, zn, z)
                xs_c = jnp.where(alive[:, :, None], proj, xs_c)
                us_c = jnp.where(alive[:, :, None], usn, us_c)
                return z, xs_c, us_c, t + 1

            z, _, _, _ = jax.lax.while_loop(
                cond, body, (z0, xs_c, us_c, jnp.asarray(0)))
            return z

        # ---- phase 2: objective consensus (qcqp/qcqp.py:215-251) ----------
        def run_phase2(z0):
            lhs = 2.0 * (P0 + rho * m_true * jnp.eye(n, dtype=z0.dtype))
            chol = jax.scipy.linalg.cho_factor(lhs)
            xs_c = jnp.broadcast_to(z0[:, None, :], (Rl, ml, n))
            us_c = jnp.zeros((Rl, ml, n), z0.dtype)

            def cond(carry):
                z, xs_c, us_c, last_z, bestx, t, done = carry
                return (t < num_iters) & ~jnp.all(done)

            def body(carry):
                z, xs_c, us_c, last_z, bestx, t, done = carry
                local_sum = jnp.sum(wcol * (xs_c - us_c), axis=1)
                rhs = (2.0 * rho * jax.lax.psum(local_sum, c_axis)
                       - q0[None, :])
                zn = jax.scipy.linalg.cho_solve(chol, rhs.T).T     # (Rl, n)
                proj = proj_all(zn[:, None, :] + us_c)
                usn = us_c + zn[:, None, :] - proj

                converged = (t > 0) & (
                    jnp.linalg.norm(last_z - zn, axis=1) < tol)
                maxviol = viol_b(zn)
                diverged = maxviol > viol_lim
                take = ~(converged | diverged) & ~done
                bestx = jnp.where(
                    take[:, None],
                    jax.vmap(lambda a, b: better(form, a, b, better_tol))(
                        zn, bestx),
                    bestx)
                upd = (~done)[:, None]
                z = jnp.where(upd, zn, z)
                xs_c = jnp.where(upd[:, :, None], proj, xs_c)
                us_c = jnp.where(upd[:, :, None], usn, us_c)
                last_z = jnp.where(upd, zn, last_z)
                done = done | converged | diverged
                return z, xs_c, us_c, last_z, bestx, t + 1, done

            init = (z0, xs_c, us_c, z0, z0, jnp.asarray(0),
                    jnp.zeros(Rl, bool))
            _, _, _, _, bestx, _, _ = jax.lax.while_loop(cond, body, init)
            return bestx

        z = xs_blk
        if phase1:
            z1 = run_phase1(z)
            z = jax.vmap(lambda a, b: better(form, a, b, better_tol))(z, z1)
        z2 = run_phase2(z)
        return jax.vmap(lambda a, b: better(form, a, b, better_tol))(z, z2)

    spec_c = P(c_axis)
    spec_r = P(r_axis, None)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec_c, spec_c, spec_c, spec_c, spec_c, spec_c, spec_r),
        out_specs=spec_r,
        check_vma=False,
    )
    return fn(eigh.lam, eigh.Q, eigh.qhat, padded.r[1:], padded.is_eq,
              mask, xs)


def solve_restarts_2d(form: QCQPForm, num_restarts: int, key: jax.Array,
                      mesh: Mesh, r_axis: str = "r", c_axis: str = "c",
                      suggest: str = s.RANDOM, better_tol: float = 1e-4,
                      **kwargs):
    """Full 2-D pipeline: suggest -> 2-D sharded ADMM -> best-point reduction.

    Returns (x_best, f_best, viol_best) replicated on all devices.
    """
    nr = mesh.shape[r_axis]
    num_padded = -(-num_restarts // nr) * nr
    replicated = NamedSharding(mesh, P())

    def step(key):
        xs = suggest_batch(form, num_padded, key, suggest)
        xs = jax.lax.with_sharding_constraint(
            xs, NamedSharding(mesh, P(r_axis, None)))
        xs = improve_admm_2d(form, xs, mesh, r_axis, c_axis,
                             better_tol=better_tol, **kwargs)
        return best_point(form, xs, better_tol)

    fn = jax.jit(step, out_shardings=(replicated, replicated, replicated))
    return fn(key)
