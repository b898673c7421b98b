"""Worker process for the multi-process jax.distributed test.

Run as:  python distributed_worker.py <coordinator> <num_processes> <pid>

Each process exposes 2 virtual CPU devices, joins the coordination service,
builds the same seeded boolean-LS problem, and runs the sharded
solve_restarts over the GLOBAL mesh (spanning all processes).  The replicated
best point is printed as one JSON line for the parent test to compare.

This file must be runnable standalone (no pytest/conftest): the platform
switch happens here, before any device op.
"""

import json
import os
import sys

# Platform must be pinned before jax initializes a backend: the workers are
# CPU-only processes.
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_form():
    import qcqp_tpu as qt
    from qcqp_tpu.expressions import canonicalize
    rng = np.random.RandomState(1)
    A = rng.randn(12, 8)
    b = rng.randn(12)
    x = qt.Variable(8)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    form, _, _ = canonicalize(prob)
    return form


def main():
    coordinator, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from qcqp_tpu.parallel.launch import (
        initialize, global_mesh, solve_restarts_distributed, is_coordinator)
    initialize(coordinator, nproc, pid, local_device_count=2)

    import jax
    assert jax.process_count() == nproc
    mesh = global_mesh()

    form = build_form()
    x, f, v = solve_restarts_distributed(
        form, 64, jax.random.PRNGKey(0), mesh=mesh, num_iters=50)
    out = {
        "pid": pid,
        "nproc": nproc,
        "ndev": len(jax.devices()),
        "coordinator": is_coordinator(),
        "f": float(f),
        "v": float(v),
        "x": np.round(np.asarray(x), 8).tolist(),
    }
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
