#!/usr/bin/env python
"""Headline benchmark: parallel-restart throughput of the CD improve path.

Workload: n=100, m=50 dense random QCQP (float32), RANDOM suggest + two-phase
coordinate descent capped at SWEEPS outer sweeps, R restarts in one jitted
batch on the routed CD path (qcqp_tpu/routing.py), followed by the
lexicographic best-point reduction.  Metric: restarts/second on one device.
Secondary: ADMM, CCP and NLP restarts/s, single and batched SDR times, and
the golden gate (chip_smoke.py's phases), reported as `smoke_ok`.

Baseline: the reference implementation is single-threaded Python+numpy
(SURVEY.md section 2c: no parallelism of any kind), so the comparison point is
a faithful reference-style scalar-loop coordinate descent on one restart of
the same workload, timed on the host CPU (`baseline_host_restarts_per_sec`).

Runs on the GPU.  It refuses to run on any other platform unless
JAX_PLATFORMS=cpu is set explicitly (then the figures are CPU figures), and
exits non-zero when the golden gate fails.  Every timed region ends in
block_until_ready.

    python bench.py

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "restarts/s", "vs_baseline": N,
   "device": {...}, "extra": {...}}
"""

import json
import os
import sys
import time

import numpy as np

N = int(os.environ.get("BENCH_N", 100))
M = int(os.environ.get("BENCH_M", 50))
R = int(os.environ.get("BENCH_R", 10240))
SWEEPS = int(os.environ.get("BENCH_SWEEPS", 10))
SEED = 0


def make_problem(n=N, m=M, seed=SEED):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < 0.5
    return P, q, r, is_eq


# ---------------------------------------------------------------------------
# Reference-style baseline: scalar Python loops, one restart (what the
# reference's pure-Python CD costs per chain; see qcqp/qcqp.py:101-192).
# ---------------------------------------------------------------------------

def _intervals_leq(p, q, c, tol=1e-4):
    """Solution set of p x^2 + q x + c <= 0 as a list of closed intervals."""
    if p > tol:
        D = q * q - 4 * p * c
        if D < 0:
            return []
        rD = D ** 0.5
        return [((-q - rD) / (2 * p), (-q + rD) / (2 * p))]
    if p < -tol:
        D = q * q - 4 * p * c
        if D < 0:
            return [(-np.inf, np.inf)]
        rD = D ** 0.5
        return [(-np.inf, (-q + rD) / (2 * p)), ((-q - rD) / (2 * p), np.inf)]
    if q > tol:
        return [(-np.inf, -c / q)]
    if q < -tol:
        return [(-c / q, np.inf)]
    return [(-np.inf, np.inf)]


def _feasible_pt(cons, s):
    """A point satisfying every (p,q,r,eq) within slack s, or None."""
    events = []
    lists = []
    for (p, q, r, eq) in cons:
        I = _intervals_leq(p, q, r - s)
        if eq:
            I2 = _intervals_leq(-p, -q, -r - s)
            I = [(max(a, c2), min(b, d2)) for a, b in I for c2, d2 in I2
                 if max(a, c2) <= min(b, d2)]
        if not I:
            return None
        lists.append(I)
    lo = max(min(a for a, _ in I) for I in lists)
    # candidate left endpoints
    cands = [a for I in lists for a, _ in I] + [0.0]
    for x in cands:
        ok = True
        for I in lists:
            if not any(a - 1e-12 <= x <= b + 1e-12 for a, b in I):
                ok = False
                break
        if ok:
            return x
    return None


def baseline_one_restart(P, q, r, is_eq, sweeps, viol_tol=1e-2, tol=1e-4,
                         seed=1):
    n = P.shape[-1]
    m = len(is_eq)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    for t in range(sweeps):
        viols = []
        for i in range(m):
            v = x @ P[1 + i] @ x + q[1 + i] @ x + r[1 + i]
            viols.append(abs(v) if is_eq[i] else max(0.0, v))
        if max(viols) < viol_tol:
            break
        for k in range(n):
            cons = []
            vmax = 0.0
            for i in range(1, m + 1):
                t2 = P[i][k, k]
                z = x.copy(); z[k] = 0.0
                t1 = 2 * (P[i][k] @ z) + q[i][k]
                t0 = z @ P[i] @ z + q[i] @ z + r[i]
                if t2 == 0 and t1 == 0:
                    continue
                val = t2 * x[k] ** 2 + t1 * x[k] + t0
                viol = abs(val) if is_eq[i - 1] else max(0.0, val)
                vmax = max(vmax, viol)
                cons.append((t2, t1, t0, bool(is_eq[i - 1])))
            ss, es = -tol, vmax - viol_tol
            best = None
            while es - ss > tol:
                sm = 0.5 * (ss + es)
                pt = _feasible_pt(cons, sm)
                if pt is None:
                    ss = sm
                else:
                    best, es = pt, sm
            if best is not None and es < vmax:
                x[k] = best
    return x


def run_baseline(P, q, r, is_eq, sweeps):
    """Single-thread reference-style rate on the host CPU, averaged over
    BENCH_BASE_REPS restarts (a one-restart extrapolation swings with
    host noise).  Methodology: BASELINE.md ("vs_baseline methodology")."""
    reps = int(os.environ.get("BENCH_BASE_REPS", 5))
    t0 = time.time()
    for i in range(reps):
        baseline_one_restart(P, q, r, is_eq, sweeps, seed=1 + i)
    dt = (time.time() - t0) / reps
    return 1.0 / dt


# ---------------------------------------------------------------------------
# Device benchmark
# ---------------------------------------------------------------------------

def _form(P, q, r, is_eq, dt):
    import jax.numpy as jnp
    from qcqp_tpu.core import QCQPForm
    return QCQPForm(jnp.asarray(P, dt), jnp.asarray(q, dt),
                    jnp.asarray(r, dt), jnp.asarray(is_eq))


def _time(fn, reps=1):
    """(compile+first-run seconds, steady seconds per run); every region
    ends in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return out, t1 - t0, (time.perf_counter() - t1) / reps


def run_device(P, q, r, is_eq):
    """Headline CD throughput on the routed path."""
    import jax
    import jax.numpy as jnp
    from qcqp_tpu import routing
    from qcqp_tpu import settings as s
    from qcqp_tpu.parallel.restarts import best_point, improve_chain

    dt = jnp.float32
    form = _form(P, q, r, is_eq, dt)
    paths = routing.form_paths(form)

    @jax.jit
    def step(key):
        xs = jax.random.normal(key, (R, N), dt)
        xs = improve_chain(form, xs, s.COORD_DESCENT, num_iters=SWEEPS,
                           paths=paths)
        return best_point(form, xs)

    reps = int(os.environ.get("BENCH_REPS", 1))
    out, compile_s, dt_s = _time(lambda: step(jax.random.PRNGKey(1)), reps)
    return R / dt_s, out, paths[s.COORD_DESCENT], compile_s


def run_admm(P, q, r, is_eq):
    """Secondary metric: batched ADMM improve throughput on the routed
    path at BENCH_ADMM_ITERS iterations, BENCH_ADMM_R restarts."""
    import jax
    import jax.numpy as jnp
    from qcqp_tpu import routing
    from qcqp_tpu import settings as s
    from qcqp_tpu.solvers.admm import improve_admm_batch

    R_admm = int(os.environ.get("BENCH_ADMM_R", 1024))
    iters = int(os.environ.get("BENCH_ADMM_ITERS", 50))
    form = _form(P, q, r, is_eq, jnp.float32)
    path = routing.form_paths(form)[s.ADMM]
    xs = jax.random.normal(jax.random.PRNGKey(0), (R_admm, N), jnp.float32)
    _, _, dt_s = _time(lambda: improve_admm_batch(
        form, xs, num_iters=iters, proj_trips=routing.admm_proj_trips(path)))
    return R_admm / dt_s, iters, path


def run_ccp_nlp(P, q, r, is_eq):
    """Per-restart throughput of the remaining two improve methods
    (reference: qcqp/qcqp.py:288-364), vmapped over a restart batch."""
    import jax
    import jax.numpy as jnp
    from qcqp_tpu.solvers.ccp import improve_ccp, precompute_ccp
    from qcqp_tpu.solvers.nlp import improve_nlp

    R_b = int(os.environ.get("BENCH_CCP_R", 128))
    form = _form(P, q, r, is_eq, jnp.float32)
    xs = jax.random.normal(jax.random.PRNGKey(3), (R_b, N), jnp.float32)
    data = precompute_ccp(form)
    ccp = jax.jit(jax.vmap(lambda x: improve_ccp(form, x, data=data)))
    nlp = jax.jit(jax.vmap(lambda x: improve_nlp(form, x)))
    _, _, ccp_s = _time(lambda: ccp(xs))
    _, _, nlp_s = _time(lambda: nlp(xs))
    return R_b / ccp_s, R_b / nlp_s


def run_sdr():
    """Single-instance SDR time to tolerance on the device (f32) and on the
    host CPU (f64), plus the scenario-batched SDR serving rate.

    Measured on an n=N boolean-least-squares instance (x_i^2 = 1): the
    bench's random dense QCQP has an unbounded Shor relaxation, so its
    splitting iterations never converge and time nothing meaningful."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import sdr_boolean_ls_form
    from qcqp_tpu.core import QCQPForm
    from qcqp_tpu.solvers.sdp import solve_sdr, solve_sdr_batch

    iters = int(os.environ.get("BENCH_SDR_ITERS", 3000))
    form32 = sdr_boolean_ls_form(N, np.float32)
    form64 = sdr_boolean_ls_form(N, np.float64)

    # Time to tolerance, not a fixed iteration budget: each path runs to
    # its dtype-appropriate tolerance (f32 device: the 3e-5 floor; f64
    # host: 1e-6) and reports ms + iterations.
    out = {}
    dev, _, dev_s = _time(lambda: solve_sdr(
        form32, device="device", check=False, full=True,
        max_iters=2 * iters))
    out["sdr_single_ms_device"] = dev_s * 1e3
    out["sdr_single_iters_device"] = int(dev.iterations)
    host, _, host_s = _time(lambda: solve_sdr(
        form64, device="host", check=False, full=True, max_iters=20000,
        tol=1e-6))
    out["sdr_single_ms_host"] = host_s * 1e3
    out["sdr_single_iters_host"] = int(host.iterations)

    # Scenario-batched serving path: S drifted boolean-LS instances,
    # bounded relaxations with a per-instance acceptance gate and f64
    # re-solve.  The metric is solves/s TO TOLERANCE with the acceptance
    # rate.
    S, ns = 16, 24
    rng = np.random.default_rng(5)
    base_A = rng.standard_normal((ns + 8, ns))
    Ps = np.zeros((S, ns + 1, ns, ns))
    qs = np.zeros((S, ns + 1, ns))
    rs = np.zeros((S, ns + 1))
    for si in range(S):
        A_s = base_A + 0.05 * rng.standard_normal((ns + 8, ns))
        b_s = rng.standard_normal(ns + 8)
        Ps[si, 0] = A_s.T @ A_s
        for i in range(ns):
            Ps[si, 1 + i, i, i] = 1.0
        qs[si, 0] = -2.0 * A_s.T @ b_s
        rs[si, 0] = float(b_s @ b_s)
        rs[si, 1:] = -1.0
    stacked = QCQPForm(jnp.asarray(Ps, jnp.float32),
                       jnp.asarray(qs, jnp.float32),
                       jnp.asarray(rs, jnp.float32),
                       jnp.asarray(np.ones((S, ns), bool)))
    kw = dict(max_iters=6000, tol=3e-5, return_accept=True)
    res, _, batch_s = _time(lambda: solve_sdr_batch(stacked, **kw))
    out["sdr_batch_to_tol_solves_per_sec"] = S / batch_s
    out["sdr_batch_accept_rate"] = float(np.mean(res[-1]))
    return out


def run_smoke():
    """Golden gate: chip_smoke.py's one-device phases.  BENCH_SMOKE=0
    skips it."""
    if os.environ.get("BENCH_SMOKE", "1") == "0":
        return {}
    import chip_smoke
    failed = []
    for fn in (chip_smoke.phase_sdr, chip_smoke.phase_examples,
               chip_smoke.phase_cd, chip_smoke.phase_improve,
               chip_smoke.phase_precheck):
        try:
            ok = fn().ok
        except Exception:  # noqa: BLE001 — a crashed phase fails the gate
            ok = False
        if not ok:
            failed.append(fn.__name__)
    return {"smoke_ok": not failed, "smoke_failed": failed}


def device_info():
    import jax
    from chip_smoke import gpu_info
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": gpu_info()}


def main():
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"bench.py: needs a GPU, JAX found {platform!r} "
              "(set JAX_PLATFORMS=cpu to run on the CPU on purpose)",
              file=sys.stderr)
        return 2
    P, q, r, is_eq = make_problem()
    rate, out, path, compile_s = run_device(P, q, r, is_eq)
    admm_rate, admm_iters, admm_path = run_admm(P, q, r, is_eq)
    ccp_rate, nlp_rate = run_ccp_nlp(P, q, r, is_eq)
    extras = {
        "cd_path": path,
        "cd_compile_s": compile_s,
        "cd_best": [float(out[1]), float(out[2])],
        f"admm_restarts_per_sec_n{N}_m{M}_it{admm_iters}": admm_rate,
        "admm_path": admm_path,
        "ccp_restarts_per_sec": ccp_rate,
        "nlp_restarts_per_sec": nlp_rate,
    }
    extras.update(run_sdr())
    extras.update(run_smoke())
    base_rate = run_baseline(P, q, r, is_eq, SWEEPS)
    extras["baseline_host_restarts_per_sec"] = base_rate
    print(json.dumps({
        "metric": f"restarts_per_sec_n{N}_m{M}_cd{SWEEPS}",
        "value": rate,
        "unit": "restarts/s",
        "vs_baseline": rate / base_rate,
        "device": device_info(),
        "extra": extras,
    }))
    return 0 if extras.get("smoke_ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
