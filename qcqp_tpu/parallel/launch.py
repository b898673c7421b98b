"""Multi-process distributed runtime: jax.distributed bootstrap + global mesh.

The reference is single-process, single-threaded (SURVEY.md section 2c; the
closest marker is the author's `# TODO: parallel` at qcqp/qcqp.py:234).  This
module is the multi-host plumbing needed to scale the restart axis past one
host: each host process calls `initialize(...)`, builds the global device
mesh spanning every process's devices, and runs the same jitted
`solve_restarts` program — GSPMD partitions it, XLA inserts the collectives
(NCCL within and across hosts on GPUs), and the replicated best-point result
is addressable on every process.

No custom transport is written (SURVEY.md section 5 "distributed comm
backend"): `jax.distributed.initialize` brings up the coordination service
and PJRT handles the rest.  The entire path is testable without accelerators
by spawning N localhost CPU processes, each with
`--xla_force_host_platform_device_count=K` (tests/test_distributed.py).

Typical multi-host usage (one command per host)::

    # host 0                                   # host 1
    initialize("10.0.0.1:8476", 2, 0)          initialize("10.0.0.1:8476", 2, 1)
    mesh = global_mesh()                       mesh = global_mesh()
    x, f, v = solve_restarts_distributed(form, 10**5, key)
    if is_coordinator(): report(f, v)
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


# Tracks whether this process brought up the jax.distributed runtime via
# initialize() below — the public-API way to answer is_initialized() without
# reaching into jax._src internals (which silently break across versions).
_initialized = False


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_count: Optional[int] = None) -> None:
    """Bring up the jax.distributed runtime for one process of a multi-host
    run.

    coordinator_address: "host:port" of process 0 (all processes pass the
        same value; process 0 binds it).
    local_device_count: for CPU-backend testing only — forces this process to
        expose that many virtual host devices.  Must be set before the first
        device op; on accelerator hosts leave it None (PJRT discovers the
        local devices).
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags +
                f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    global _initialized
    _initialized = True


def is_initialized() -> bool:
    """True if this module's initialize() brought up jax.distributed (or the
    process is already part of a multi-process run)."""
    if _initialized:
        return True
    import jax
    return jax.process_count() > 1


def is_coordinator() -> bool:
    """True on process 0 — the conventional reporting process."""
    import jax
    return jax.process_index() == 0


def global_mesh(axis: str = "r", devices: Optional[Sequence] = None):
    """1-D mesh over every device of every process (the restart axis)."""
    import jax
    from jax.sharding import Mesh
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis,))


def solve_restarts_distributed(form, num_restarts: int, key,
                               mesh=None, **kwargs):
    """`solve_restarts` over the global multi-process mesh.

    Every process calls this with identical (form, num_restarts, key,
    kwargs); the restart axis is sharded over all devices of all processes
    and the (x, f, v) result is replicated, so each process can read it.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from .restarts import solve_restarts
    if mesh is None:
        mesh = global_mesh()
    # Lift host-local inputs to global replicated arrays: every process holds
    # the same values (same seed/problem), so replication is metadata only.
    rep = NamedSharding(mesh, PartitionSpec())
    form = jax.tree.map(lambda a: jax.device_put(np.asarray(a), rep), form)
    key = jax.device_put(np.asarray(key), rep)
    return solve_restarts(form, num_restarts, key, mesh=mesh, **kwargs)


def shutdown() -> None:
    import jax
    jax.distributed.shutdown()
    global _initialized
    _initialized = False
