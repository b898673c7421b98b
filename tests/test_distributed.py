"""Multi-process jax.distributed runtime test.

Spawns real localhost processes — the same bootstrap a multi-host run uses,
minus the accelerators: each process exposes 2 virtual CPU devices, joins the
coordination service at 127.0.0.1:<port>, and runs the sharded
solve_restarts over the 4-device GLOBAL mesh.  The replicated best points
must agree bit-for-bit across processes and match a single-process run of
the identical program.

The reference has no distributed runtime at all (SURVEY.md section 2c).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env():
    env = dict(os.environ)
    # Fresh CPU-only processes: drop any inherited device-count flags (the
    # worker sets its own).
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_workers(nproc: int, timeout: float = 420.0):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(nproc), str(pid)],
            env=_worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)
    ]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            assert line, f"no RESULT line:\n{out[-1000:]}\n{err[-1000:]}"
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


def test_two_process_matches_single_process():
    two = _run_workers(2)
    assert {r["pid"] for r in two} == {0, 1}
    # global mesh spans both processes' devices
    assert all(r["ndev"] == 4 for r in two)
    assert two[0]["coordinator"] and not two[1]["coordinator"]
    # the replicated best point agrees across processes bit-for-bit
    np.testing.assert_array_equal(two[0]["x"], two[1]["x"])
    assert two[0]["f"] == two[1]["f"]
    assert two[0]["v"] < 1e-2

    one = _run_workers(1)
    # same program, same keys: single-process run finds the same best point
    np.testing.assert_allclose(one[0]["x"], two[0]["x"], atol=1e-8)
    assert one[0]["f"] == pytest.approx(two[0]["f"], abs=1e-9)
