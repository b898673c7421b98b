"""Restart parallelism: vmapped suggest->improve chains over a device mesh.

The reference runs suggest/improve chains strictly one at a time
(reference: examples/boolean_least_squares.py:19-38); the math is
embarrassingly parallel over restarts (SURVEY.md section 2c).  Here the whole
chain is one jitted program over a batch axis: thousands of restarts per
device via vmap, sharded across devices/hosts with
`jax.sharding.NamedSharding` so XLA inserts the collectives for the final
best-point reduction.

The reduction implements the reference's lexicographic `better` order
(violation bucket, then objective — qcqp/utilities.py:135-146) as two
collective-friendly stages: global min of the bucket, then argmin of the
objective masked to argmin-bucket restarts.  This is order-insensitive and
deterministic across shardings (ties broken by lowest restart index).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import routing
from .. import settings as s
from ..core import QCQPForm, eval_objective, max_violation
from ..solvers.admm import improve_admm, auto_rho
from ..kernels.projection import precompute_eigh


def make_mesh(devices: Optional[Sequence] = None, axis: str = "r") -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis,))


def best_point(form: QCQPForm, xs: jax.Array, tol: float = 1e-4):
    """Lexicographic (viol bucket, objective) argmin over the restart axis.

    Returns (x_best, f_best, viol_best).  Compiles to cross-device
    reductions when xs is sharded over restarts.  The winner row is
    extracted by a one-hot masked SUM over the restart axis (a reduction
    XLA lowers to an (n,)-sized all-reduce) — indexing `xs[i]` instead
    makes XLA all-gather the whole (R, n) batch to every device, which is
    the dominant collective at large R (verified via the compiled-HLO
    inventory in benchmarks/scaling.py).
    """
    viols = jax.vmap(lambda x: max_violation(form, x))(xs)
    buckets = jnp.floor(viols / tol)
    fs = jax.vmap(lambda x: eval_objective(form, x))(xs)
    bmin = jnp.min(buckets)
    fs_masked = jnp.where(buckets == bmin, fs, jnp.inf)
    i = jnp.argmin(fs_masked)           # first minimal index (tie-break)
    onehot = (jnp.arange(xs.shape[0]) == i)
    x = jnp.sum(jnp.where(onehot[:, None], xs, 0), axis=0)
    f = jnp.sum(jnp.where(onehot, fs, 0))
    v = jnp.sum(jnp.where(onehot, viols, 0))
    return x, f, v


def suggest_batch(form: QCQPForm, num: int, key: jax.Array,
                  method: str = s.RANDOM, sdr_sampler=None,
                  spectral_sol=None) -> jax.Array:
    """Batched suggest: (num, n) starting points.

    RANDOM: iid standard normal (reference: qcqp/qcqp.py:381-382).
    SDR: x ~ N(mu, Sigma) via the cached Cholesky factor
         (reference: qcqp/qcqp.py:394-396); pass sdr_sampler=(mu, L).
    SPECTRAL: the deterministic relaxation point, broadcast.
    """
    n = form.n
    if method == s.RANDOM:
        return jax.random.normal(key, (num, n), form.dtype)
    if method == s.SDR:
        if sdr_sampler is None:
            raise ValueError("SDR suggest_batch needs sdr_sampler=(mu, L)")
        mu, L = sdr_sampler
        xi = jax.random.normal(key, (num, n), form.dtype)
        return mu[None, :] + xi @ L.T
    if method == s.SPECTRAL:
        if spectral_sol is None:
            raise ValueError("SPECTRAL suggest_batch needs spectral_sol")
        return jnp.broadcast_to(spectral_sol, (num, n))
    raise ValueError(f"Unknown suggest method: {method}")


def _paths(form: QCQPForm, kwargs) -> dict:
    """Improve paths: `paths` if given (solve_restarts decides them once,
    where the form is concrete), else the router's choice.  use_fused=False
    forces the CPU's paths (XLA, the reference's semantics); use_fused=True
    forces the paths of a float32 problem on the GPU (tests use it with
    interpret=True to run the kernel on the CPU)."""
    if "paths" in kwargs:
        return dict(kwargs["paths"])
    from ..solvers.coord_descent_fused import static_eq_idx
    eq_static = (kwargs.get("eq_idx", None) is not None
                 or static_eq_idx(form) is not None)
    platform, dtype = jax.default_backend(), form.dtype
    use_fused = kwargs.get("use_fused", None)
    if use_fused is not None:
        platform, dtype = ("gpu", jnp.float32) if use_fused else ("cpu", dtype)
    return routing.improve_paths(platform, dtype, form.n, form.m, eq_static)


def improve_chain(form: QCQPForm, xs: jax.Array,
                  methods: Union[str, List[str]], **kwargs) -> jax.Array:
    """Apply improve methods in sequence to every restart (vmapped).

    Like the reference's improve(method_list), the same kwargs are forwarded
    to every stage (reference: qcqp/qcqp.py:430-431).
    """
    if isinstance(methods, str):
        methods = [methods]
    eigh = None
    paths = _paths(form, kwargs)
    for method in methods:
        path = paths.get(method)
        if method == s.COORD_DESCENT:
            if path == routing.XLA:
                # batched (not vmap of the single-restart improve): vmapping
                # its phase-2 lax.cond broadcasts form.P per restart
                from ..solvers.coord_descent import improve_coord_descent_batch
                xs = improve_coord_descent_batch(
                    form, xs,
                    num_iters=kwargs.get("num_iters", 1000),
                    viol_tol=kwargs.get("viol_tol", 1e-2),
                    tol=kwargs.get("tol", 1e-4),
                    phase1=kwargs.get("phase1", True))
            else:
                # float32 batched paths.  Under a mesh, solve_restarts wraps
                # the kernel in shard_map (a pallas_call has no SPMD
                # partitioning rule), so here xs is the local shard.
                from ..solvers.coord_descent_fused import (
                    improve_coord_descent_fused)
                xs = improve_coord_descent_fused(
                    form, xs,
                    num_iters=kwargs.get("num_iters", 1000),
                    viol_tol=kwargs.get("viol_tol", 1e-2),
                    tol=kwargs.get("tol", 1e-4),
                    phase1=kwargs.get("phase1", True),
                    path=path, eq_idx=kwargs.get("eq_idx", None),
                    interpret=kwargs.get("interpret", False)
                ).astype(xs.dtype)
        elif method == s.ADMM:
            if eigh is None:
                eigh = precompute_eigh(form)
            rho = kwargs.get("rho", None)
            if rho is None:
                rho = auto_rho(form)
            rho = jnp.asarray(rho, form.dtype)
            fn = lambda x: improve_admm(
                form, x, rho,
                num_iters=kwargs.get("num_iters", 1000),
                viol_lim=kwargs.get("viol_lim", 1e4),
                tol=kwargs.get("admm_tol", kwargs.get("tol", 1e-2)),
                phase1=kwargs.get("phase1", True),
                eigh=eigh, proj_trips=routing.admm_proj_trips(path))
            xs = jax.vmap(fn)(xs)
        elif method == s.DCCP:
            from ..solvers.ccp import improve_ccp
            # Same filtered forwarding as QCQP._improve_one: a chained
            # solve(improve=[DCCP, ...], max_iter=...) must reach the CCP
            # stage, not silently drop.
            ccp_kw = {k: v for k, v in kwargs.items()
                      if k in ("max_iter", "mu", "tau_max",
                               "inner_iters", "use_eigen_split")}
            fn = lambda x: improve_ccp(
                form, x, tau=kwargs.get("tau", 0.005), **ccp_kw)
            xs = jax.vmap(fn)(xs)
        elif method == s.IPOPT:
            from ..solvers.nlp import improve_nlp
            nlp_kw = {k: v for k, v in kwargs.items()
                      if k in ("num_outer", "num_inner", "mu0")}
            fn = lambda x: improve_nlp(form, x, **nlp_kw)
            xs = jax.vmap(fn)(xs)
        else:
            raise ValueError(f"Unknown improve method: {method}")
    return xs


def solve_restarts(form: QCQPForm, num_restarts: int, key: jax.Array,
                   suggest: str = s.RANDOM,
                   improve: Union[str, List[str]] = s.COORD_DESCENT,
                   mesh: Optional[Mesh] = None,
                   handler=None, better_tol: float = 1e-4, **kwargs):
    """Full parallel pipeline: suggest -> improve chain -> best-of reduction.

    With a mesh, the restart axis is sharded across its devices; XLA inserts
    the reduction collectives (psum/pmin-equivalent).
    Returns (x_best, f_best, viol_best) replicated on all devices.
    """
    sdr_sampler = None
    spectral_sol = None
    if suggest == s.SDR:
        if handler is not None and getattr(handler, "mu", None) is not None:
            sdr_sampler = (handler.mu, handler._sigma_chol)
        else:
            from ..solvers.sdp import solve_sdr
            X, _ = solve_sdr(form)
            mu = X[:-1, -1]
            Sigma = X[:-1, :-1] - jnp.outer(mu, mu)
            Sigma = Sigma + 1e-8 * jnp.eye(form.n, dtype=X.dtype)
            lam, Q = jnp.linalg.eigh(Sigma)
            sdr_sampler = (mu, Q * jnp.sqrt(jnp.maximum(lam, 0.0)))
    elif suggest == s.SPECTRAL:
        if handler is not None and getattr(handler, "spectral_sol", None) is not None:
            spectral_sol = handler.spectral_sol
        else:
            from ..solvers.sdp import solve_spectral
            spectral_sol, _ = solve_spectral(form)

    ndev = 1
    if mesh is not None:
        ndev = int(np.prod(list(mesh.shape.values())))
    # pad restarts to a multiple of the device count
    num_padded = -(-num_restarts // ndev) * ndev

    # The paths are decided here, where the form is still concrete (the
    # static equality pattern is lifted for the kernel); single device AND
    # mesh runs (the mesh path maps the kernel per shard via shard_map).
    from ..solvers.coord_descent_fused import static_eq_idx
    if kwargs.get("eq_idx", None) is None:
        kwargs["eq_idx"] = static_eq_idx(form)
    kwargs["paths"] = _paths(form, kwargs)
    # array-valued options (rho) are traced arguments; the rest are part of
    # the compiled step's cache key
    dyn = {k: v for k, v in kwargs.items()
           if isinstance(v, (jax.Array, np.ndarray))}
    static = tuple(sorted((k, _freeze(v)) for k, v in kwargs.items()
                          if k not in dyn))
    improve = improve if isinstance(improve, str) else tuple(improve)
    fn = _restart_step(num_padded, suggest, improve, mesh, better_tol, static)
    return fn(form, key, sdr_sampler, spectral_sol, dyn)


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


@functools.lru_cache(maxsize=64)
def _restart_step(num_padded, suggest, improve, mesh, better_tol, static):
    """The jitted suggest -> improve -> best-point step of solve_restarts,
    built once per configuration so that a repeated call with the same
    shapes runs the compiled executable instead of tracing again."""
    kwargs = dict(static)
    kwargs["paths"] = dict(kwargs["paths"])
    if mesh is not None:
        axis = list(mesh.shape.keys())[0]
        restart_sharding = NamedSharding(mesh, P(axis))
        replicated = NamedSharding(mesh, P())

    def step(form, key, sdr_sampler, spectral_sol, dyn):
        kw = dict(kwargs, **dyn)
        xs = suggest_batch(form, num_padded, key, suggest,
                           sdr_sampler=sdr_sampler, spectral_sol=spectral_sol)
        if mesh is not None:
            # Shard the restart axis; the best_point reduction then lowers to
            # cross-device collectives.
            xs = jax.lax.with_sharding_constraint(xs, restart_sharding)
        if (mesh is not None
                and kw["paths"][s.COORD_DESCENT] == routing.KERNEL):
            # pallas_call has no SPMD partitioning rule, so the kernel is
            # mapped per shard: each device runs its own pallas_call on its
            # local restarts (restarts are independent; no collectives
            # inside the chain).
            from jax import shard_map
            local = lambda f, xs_l: improve_chain(f, xs_l, improve, **kw)
            # check_vma=False: pallas_call out_shapes carry no varying-mesh
            # annotation, so the vma checker rejects them.
            xs = shard_map(local, mesh=mesh,
                           in_specs=(P(), P(axis)),
                           out_specs=P(axis), check_vma=False)(form, xs)
        else:
            xs = improve_chain(form, xs, improve, **kw)
        return best_point(form, xs, better_tol)

    if mesh is None:
        return jax.jit(step)
    return jax.jit(step, out_shardings=(replicated, replicated, replicated))
