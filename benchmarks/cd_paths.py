#!/usr/bin/env python
"""Time the batched coordinate-descent paths against each other, in turns.

Paths (solvers/coord_descent_fused.py, solvers/coord_descent.py):
  xla       improve_coord_descent_batch: the (R, m+1, n) gradient cache
  kernelB   the two-phase sweep kernel (Pallas through Triton), B restarts
            per program
  kernelBtf32  the same kernel with its products at TF32 (a control for
            the quality gate, not a route)
  percoord  batched phase 1 with the per-coordinate slack bisection

Workload: bench.py's dense n=100, m=50 float32 QCQP, R random starts (the
same starts for every path), `sweeps` outer sweeps.  Each path is compiled
and timed once at R/10 first; a path whose projected full-size time exceeds
--max-s is skipped.  Then every path runs --reps times at full size in
alternating order (A B C .. C B A), each run ending in block_until_ready.

Runs on the GPU; elsewhere only with JAX_PLATFORMS=cpu set explicitly.
Prints one JSON line per path: compile seconds, the full-size times,
restarts/s from their median, and the quality reached on the same starts
(feasible fraction, median violation, best feasible objective).  With
--seeds k, each path also runs on k sets of starts (keys 1..k) and prints
the quality of each.

    python benchmarks/cd_paths.py --r 10240 --sweeps 10 \
        --paths xla,kernel16,kernel32,kernel64,percoord
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def path_fn(name, form, sweeps):
    import jax
    from qcqp_tpu.kernels.cd_sweep_pallas import BLOCK_R, two_phase_sweeps
    from qcqp_tpu.solvers.coord_descent import improve_coord_descent_batch
    from qcqp_tpu.solvers.coord_descent_fused import (
        improve_coord_descent_fused, static_eq_idx)
    if name == "xla":
        return lambda xs: improve_coord_descent_batch(form, xs,
                                                      num_iters=sweeps)
    if name.startswith("kernel"):
        from qcqp_tpu.kernels import cd_sweep_pallas as ks
        tf32 = name.endswith("tf32")
        block = int(name[len("kernel"):len(name) - 4 * tf32] or BLOCK_R)

        def fn(xs):
            hp = ks._HP                   # read when the kernel is traced
            ks._HP = jax.lax.Precision.DEFAULT if tf32 else hp
            try:
                return two_phase_sweeps(
                    form.P, form.q, form.r, static_eq_idx(form), xs,
                    num_iters=sweeps, block_r=block)
            finally:
                ks._HP = hp
        return fn
    return lambda xs: improve_coord_descent_fused(form, xs, num_iters=sweeps,
                                                  path=name)


def viol_stats(form, out):
    """quality() plus the 10th and 90th percentile and the minimum of the
    restarts' violations."""
    import jax
    from chip_smoke import quality
    from qcqp_tpu.core import max_violation
    v = np.asarray(jax.vmap(lambda x: max_violation(form, x))(out))
    return dict(quality(form, out), p10_viol=float(np.percentile(v, 10)),
                p90_viol=float(np.percentile(v, 90)), min_viol=float(v.min()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--r", type=int, default=10240)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--max-s", type=float, default=60.0)
    ap.add_argument("--paths", default="xla,kernel32,percoord")
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args()

    import jax
    from chip_smoke import bench_form, gpu_info
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"cd_paths.py: needs a GPU, JAX found {dev.platform!r} "
                 "(set JAX_PLATFORMS=cpu to run on the CPU on purpose)")
    print(json.dumps({"gpu": gpu_info(), "platform": dev.platform,
                      "device_kind": dev.device_kind}), flush=True)
    form = bench_form(args.n, args.m)
    xs = jax.random.normal(jax.random.PRNGKey(1), (args.r, args.n),
                           form.dtype)
    small = xs[: max(args.r // 10, 16)]

    fns, rec = {}, {}
    for name in args.paths.split(","):
        fn = jax.jit(path_fn(name, form, args.sweeps))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(small))
        t1 = time.perf_counter()
        jax.block_until_ready(fn(small))
        t2 = time.perf_counter()
        proj = (t2 - t1) * args.r / small.shape[0]
        rec[name] = {"path": name, "compile_small_s": t1 - t0,
                     "small_s": t2 - t1, "projected_s": proj, "times": []}
        if proj <= args.max_s:
            fns[name] = fn
        else:
            rec[name]["skipped"] = "projected time above --max-s"
        print(json.dumps(rec[name]), flush=True)

    order = list(fns)
    outs = {}
    for rep in range(args.reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            fn = fns[name]
            if name not in outs:          # full-size compile
                t0 = time.perf_counter()
                outs[name] = jax.block_until_ready(fn(xs))
                rec[name]["compile_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs[name] = jax.block_until_ready(fn(xs))
            rec[name]["times"].append(time.perf_counter() - t0)
    for name in order:
        r = rec[name]
        r["restarts_per_s"] = args.r / float(np.median(r["times"]))
        r.update(viol_stats(form, outs[name]))
        print(json.dumps(r), flush=True)
    for seed in range(2, args.seeds + 1):
        xs = jax.random.normal(jax.random.PRNGKey(seed), (args.r, args.n),
                               form.dtype)
        for name in order:
            q = viol_stats(form, jax.block_until_ready(fns[name](xs)))
            print(json.dumps(dict(path=name, seed=seed, **q)), flush=True)


if __name__ == "__main__":
    main()
