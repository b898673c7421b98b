#!/usr/bin/env python
"""Time the batched ADMM improve with its two projections, in turns.

Paths (solvers/admm.py, kernels/projection.py):
  xla      projections bisected to 1e-6 (the reference's; the CPU route)
  newton   six safeguarded Newton trips per projection (the GPU route)

Workload: bench.py's dense n=100, m=50 float32 QCQP, R random starts (the
same for both paths), --iters ADMM iterations.  Each path is compiled
first, then timed --reps times in alternating order, each run ending in
block_until_ready.  Also the boolean-LS bucket of chip_smoke.py: best
violation of 128 random starts after 300 iterations.

Runs on the GPU; elsewhere only with JAX_PLATFORMS=cpu set explicitly.

    python benchmarks/admm_paths.py --r 1024 --iters 50
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRIPS = {"xla": None, "newton": 6}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax
    from chip_smoke import bench_form, boolean_ls_form, gpu_info, quality
    from qcqp_tpu.core import max_violation
    from qcqp_tpu.solvers.admm import improve_admm_batch
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"admm_paths.py: needs a GPU, JAX found {dev.platform!r} "
                 "(set JAX_PLATFORMS=cpu to run on the CPU on purpose)")
    print(json.dumps({"gpu": gpu_info(), "platform": dev.platform,
                      "device_kind": dev.device_kind}), flush=True)
    form = bench_form()
    xs = jax.random.normal(jax.random.PRNGKey(0), (args.r, form.n),
                           form.dtype)
    run = {p: (lambda t=t: improve_admm_batch(form, xs, num_iters=args.iters,
                                              proj_trips=t))
           for p, t in TRIPS.items()}
    rec = {}
    for p, fn in run.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        rec[p] = {"path": p, "compile_s": time.perf_counter() - t0,
                  "times": []}
    for rep in range(args.reps):
        for p in (list(run) if rep % 2 == 0 else list(run)[::-1]):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run[p]())
            rec[p]["times"].append(time.perf_counter() - t0)
            rec[p].update(quality(form, out))

    bls, _ = boolean_ls_form()
    starts = jax.random.normal(jax.random.PRNGKey(1), (128, bls.n), bls.dtype)
    viol = jax.vmap(lambda x: max_violation(bls, x))
    for p, t in TRIPS.items():
        out = improve_admm_batch(bls, starts, num_iters=300, proj_trips=t)
        r = rec[p]
        r["restarts_per_s"] = args.r / float(np.median(r["times"]))
        r["boolean_ls_best_violation"] = float(np.min(viol(out)))
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
