#!/usr/bin/env python
"""Restart-throughput scaling across a virtual device mesh.

This measures the *structural* scaling of the sharded restart pipeline on N
virtual CPU devices (the same GSPMD program that runs across GPUs; only the
interconnect differs).  It is not a device measurement.  Run:

    python benchmarks/scaling.py

Prints restarts/s and parallel efficiency per mesh size.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from qcqp_tpu.core import random_form  # noqa: E402
from qcqp_tpu.parallel.restarts import solve_restarts  # noqa: E402

N = int(os.environ.get("SCALE_N", 40))
M = int(os.environ.get("SCALE_M", 20))
R = int(os.environ.get("SCALE_R", 256))
SWEEPS = int(os.environ.get("SCALE_SWEEPS", 5))


def run(mesh_devices):
    rng = np.random.default_rng(0)
    form = random_form(rng, n=N, m=M)
    mesh = Mesh(np.array(mesh_devices), ("r",)) if mesh_devices else None
    key = jax.random.PRNGKey(0)
    # warm-up / compile
    out = solve_restarts(form, R, key, mesh=mesh, num_iters=SWEEPS)
    jax.block_until_ready(out)
    t0 = time.time()
    out = solve_restarts(form, R, jax.random.PRNGKey(1), mesh=mesh,
                         num_iters=SWEEPS)
    jax.block_until_ready(out)
    return R / (time.time() - t0)


def collective_report(n_devices=8):
    """Compile the sharded restart pipeline and the constraint-sharded ADMM
    step, and inventory the collectives XLA inserted (op kind + shape +
    bytes).  The restart axis is embarrassingly parallel, so the entire
    cross-device traffic of a solve is the final best-point reduction —
    this makes that claim checkable from the compiled HLO instead of
    asserted (multi-device de-risking; the byte counts are interconnect-
    independent).
    """
    import re
    from jax.sharding import NamedSharding, PartitionSpec as P
    from qcqp_tpu.parallel.restarts import (suggest_batch, improve_chain,
                                            best_point)
    from qcqp_tpu.parallel.mesh import admm_phase1_sharded

    devs = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devs), ("r",))
    rng = np.random.default_rng(0)
    form = random_form(rng, n=N, m=M)
    rep = NamedSharding(mesh, P())

    def step(form, key):
        xs = suggest_batch(form, R, key, "random")
        xs = jax.lax.with_sharding_constraint(
            xs, NamedSharding(mesh, P("r")))
        xs = improve_chain(form, xs, "coord-descent", num_iters=SWEEPS)
        return best_point(form, xs)

    def _bytes(shape_str):
        m_ = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
        if not m_:
            return 0
        dt, dims = m_.groups()
        size = {"f64": 8, "f32": 4, "s64": 8, "s32": 4, "u64": 8, "u32": 4,
                "pred": 1, "bf16": 2}.get(dt, 4)
        for d in dims.split(","):
            if d:
                size *= int(d)
        return size

    hlo = jax.jit(step, out_shardings=(rep, rep, rep)).lower(
        form, jax.random.PRNGKey(0)).compile().as_text()

    print(f"\n== collectives in the compiled {n_devices}-device restart "
          f"pipeline (R={R}, n={N}, m={M}) ==")
    total = 0
    for line in hlo.splitlines():
        m_ = re.search(r"\b(all-reduce|all-gather|reduce-scatter|"
                       r"collective-permute|all-to-all)\b", line)
        if m_ and "=" in line:
            sh = re.search(r"=\s*\(?(\w+\[[\d,]*\])", line)
            b = _bytes(sh.group(1)) if sh else 0
            total += b
            print(f"  {m_.group(1):20s} {sh.group(1) if sh else '?':24s}"
                  f" {b:8d} B")
    print(f"  TOTAL per solve: {total} bytes over {n_devices} devices "
          f"(restarts communicate only in the best-point reduction)")
    print("  constraint-sharded ADMM: one psum of the consensus z per "
          f"iteration = n*8 = {form.n * 8} B/iteration (parallel/mesh.py)")


def collective_report_2d(m_big=512):
    """Compiled-HLO collective inventory of the 2-D (restarts x
    constraints) ADMM step at a large m (the
    constraint-axis psum traffic had no measured byte count).  The
    collectives live inside the phase while_loops, so the inventory is
    per-ITERATION traffic; a throughput point on the virtual mesh is
    printed alongside (virtual-mesh wall clock is host-core-bound — the
    bytes, not the speedup, are the multi-device evidence)."""
    import re
    from qcqp_tpu.parallel.mesh2d import make_mesh_2d, improve_admm_2d

    rng = np.random.default_rng(0)
    A = rng.standard_normal((m_big + 1, 16, 16)) / 4.0
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m_big + 1, 16)) / 4.0
    r = rng.standard_normal(m_big + 1) - 1.0
    from qcqp_tpu.core import QCQPForm
    form = QCQPForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                    jnp.asarray(np.zeros(m_big, bool)))
    mesh = make_mesh_2d(2, 4)
    R = 8
    xs = jax.random.normal(jax.random.PRNGKey(0), (R, 16), form.dtype)

    fn = jax.jit(lambda xs: improve_admm_2d(form, xs, mesh, num_iters=30))
    hlo = fn.lower(xs).compile().as_text()

    def _bytes(shape_str):
        m_ = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
        if not m_:
            return 0
        dt, dims = m_.groups()
        size = {"f64": 8, "f32": 4, "s64": 8, "s32": 4, "pred": 1,
                "bf16": 2}.get(dt, 4)
        for d in dims.split(","):
            if d:
                size *= int(d)
        return size

    print(f"\n== collectives in the compiled 2x4-mesh 2-D ADMM step "
          f"(R={R}, n=16, m={m_big}) ==")
    rows = {}
    for line in hlo.splitlines():
        m_ = re.search(r"\b(all-reduce|all-gather|reduce-scatter|"
                       r"collective-permute|all-to-all)\b", line)
        if m_ and "=" in line and "start" not in line.split("=")[0]:
            sh = re.search(r"=\s*\(?(\w+\[[\d,]*\])", line)
            b = _bytes(sh.group(1)) if sh else 0
            key = (m_.group(1), sh.group(1) if sh else "?")
            rows[key] = rows.get(key, 0) + 1
    for (kind, sh), cnt in sorted(rows.items()):
        print(f"  {kind:16s} {sh:20s} x{cnt}  ({_bytes(sh)} B each; "
              f"while-loop body ops execute per iteration)")
    # the consensus psum is the (Rl, n) all-reduce over the c axis
    t0 = time.time()
    out = improve_admm_2d(form, xs, mesh, num_iters=30)
    jax.block_until_ready(out)
    print(f"  m={m_big} virtual-mesh throughput: "
          f"{R / (time.time() - t0):.2f} restarts/s (30 iters, 2x4 mesh)")


def main():
    devs = jax.devices()
    base = run(devs[:1])
    print(f"1 device : {base:9.1f} restarts/s  (eff 100.0%)")
    for nd in (2, 4, 8):
        if nd > len(devs):
            break
        rate = run(devs[:nd])
        eff = rate / (base * nd) * 100
        print(f"{nd} devices: {rate:9.1f} restarts/s  (eff {eff:5.1f}%)")
    collective_report(min(8, len(devs)))
    collective_report_2d()


if __name__ == "__main__":
    main()
