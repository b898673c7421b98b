"""One routing decision for the improve paths, from what the code can observe.

Every caller that picks an improve implementation (the restart driver,
the handler, bench.py) asks `improve_paths`, which decides from the
platform, the dtype, the problem size and whether the equality pattern is
static.  A platform without a route raises instead of falling back.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import settings as s

XLA = "xla"            # the plain XLA paths (solvers/*.py)
KERNEL = "kernel"      # two-phase CD sweep kernel (kernels/cd_sweep_pallas.py)
PERCOORD = "percoord"  # batched per-coordinate CD (solvers/coord_descent_fused)
NEWTON = "newton"      # XLA ADMM with fixed-trip Newton projections

# The sweep kernel keeps (block_r, n_p) and (block_r, k_p) tiles in
# registers, with n and m+1 padded to powers of two.
KERNEL_MAX_N = 128
KERNEL_MAX_ROWS = 128

PLATFORMS = ("cpu", "gpu")


def _check(platform: str) -> None:
    if platform not in PLATFORMS:
        raise ValueError(f"no improve route for platform {platform!r}; "
                         f"supported: {PLATFORMS}")


def default_dtype(platform: str):
    """float64 parity on the CPU; float32 throughput on the GPU."""
    _check(platform)
    return np.float64 if platform == "cpu" else np.float32


def improve_paths(platform: str, dtype, n: int, m: int,
                  eq_static: bool) -> dict:
    """The path of each improve method for one problem on one platform.

    The CPU keeps the reference's semantics everywhere (ADMM projections
    bisected to 1e-6).  The GPU's batched ADMM projects with a few Newton
    trips, which damps the consensus overshoot that makes exact projections
    limit-cycle from random starts (kernels/projection.py).
    """
    _check(platform)
    cd, admm = XLA, XLA
    if platform == "gpu":
        admm = NEWTON
        if jnp.dtype(dtype) == jnp.float32:
            fits = n <= KERNEL_MAX_N and m + 1 <= KERNEL_MAX_ROWS
            cd = KERNEL if fits and eq_static else PERCOORD
    return {s.COORD_DESCENT: cd, s.ADMM: admm, s.DCCP: XLA, s.IPOPT: XLA}


def admm_proj_trips(path: str):
    """improve_admm's proj_trips for an ADMM path (None: bisection)."""
    from .kernels.projection import NEWTON_TRIPS
    return NEWTON_TRIPS if path == NEWTON else None


def form_paths(form, platform: str = None) -> dict:
    """improve_paths for a QCQPForm on the default backend."""
    from .solvers.coord_descent_fused import static_eq_idx
    return improve_paths(platform or jax.default_backend(), form.dtype,
                         form.n, form.m, static_eq_idx(form) is not None)
