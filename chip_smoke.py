#!/usr/bin/env python
"""Smoke test of the main path on one GPU, at the sizes the benchmark uses.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # restart and constraint sharding, 4 GPUs

Phases (golden values from BASELINE.md):
  1. SDR on the device in float32: boolean LS 28.750, maxcut 57.207,
     circle packing 5.000, each accepted by the residual gate (or reported
     as re-solved in float64), plus the n=100 boolean-LS SDR to tolerance;
  2. the four reference examples' method chains through the QCQP handler;
  3. batched CD at n=100, m=50 through solve_restarts on the routed path,
     compared with improve_coord_descent_batch and the percoord path on
     the same starts, and the boolean-LS best of 256 against its
     brute-force optimum;
  4. ADMM, CCP and NLP batched through the restart driver, at the bench
     shape and on boolean LS;
  5. the infeasibility pre-check.
The first output line is each card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them
(read in a child process that never imports JAX); the next names the jax
version and the devices.  Each phase prints one JSON line with its checks,
its compile time and its steady-state wall time (each timed region ends in
block_until_ready); the SDRs report whether the float32 device result was
accepted or re-solved in float64.  The last line is
{"ok": true, "device": {...}}; any failed phase exits non-zero.
The script never falls back to the CPU: it exits non-zero unless JAX's
default platform is "gpu".  The phase functions take their sizes as
arguments, and the CPU tests call them at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import subprocess
import sys
import time

import numpy as np

GOLDEN = {"boolean_ls": 28.750, "maxcut": 57.207, "circle": 5.000,
          "beamforming": 1.970}

# Bench-shape CD quality limits (phase_cd).  Readings over four sets of
# starts, n=100, m=50, R=10,240, 10 sweeps (H100 80GB HBM3, 400 W): the
# routed kernel's median violation was 1.289-1.304x
# improve_coord_descent_batch's and 1.004-1.008x the percoord path's (same
# bisection), no restart feasible.  The same kernel with TF32 products
# gave 1.292-1.300x and 1.004-1.010x, so these limits cannot see TF32;
# tests/test_cd_sweep_pallas.py checks the products' precision instead.
MED_VS_XLA = 1.35
MED_VS_PERCOORD = 1.02
FEAS_MARGIN = 0.02      # 205 of 10,240 restarts; none was feasible there


def gpu_info() -> str:
    """name, power.limit of each card, read by nvidia-smi in a child process
    that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def _ready(x):
    import jax
    return jax.block_until_ready(x)


class _F64Resolves(logging.Handler):
    """Counts the float32 device SDR results that the acceptance gate
    rejected and solvers.sdp re-solved in float64 (its debug record)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.count = 0

    def emit(self, record):
        if "re-solving in f64" in record.getMessage():
            self.count += 1


@contextlib.contextmanager
def counting_f64_resolves():
    log = logging.getLogger("qcqp_tpu")
    handler, level = _F64Resolves(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def _timed(fn):
    """(result, compile_s, steady_s): the first call traces, compiles and
    runs; the second reuses the compiled executables (solve_restarts caches
    its jitted step) and is the steady-state run."""
    t0 = time.perf_counter()
    _ready(fn())
    t1 = time.perf_counter()
    out = _ready(fn())
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


class Phase:
    """Collects named checks; `line()` is the phase's JSON record."""

    def __init__(self, name):
        self.name = name
        self.checks = {}
        self.ok = True
        self.compile_s = 0.0
        self.steady_s = 0.0

    def check(self, name, cond, **info):
        self.checks[name] = dict(info, ok=bool(cond))
        self.ok = self.ok and bool(cond)

    def add_time(self, compile_s, steady_s):
        self.compile_s += compile_s
        self.steady_s += steady_s

    def line(self):
        return {"phase": self.name, "ok": self.ok,
                "compile_s": round(self.compile_s, 3),
                "steady_s": round(self.steady_s, 3), "checks": self.checks}


# ---------------------------------------------------------------------------
# problem builders
# ---------------------------------------------------------------------------

def boolean_ls_form(n=10, m=15, dtype=np.float32):
    """The reference's boolean least-squares instance (seed 1) and, for
    n <= 16, its brute-force optimum over sign vectors."""
    import jax.numpy as jnp
    from qcqp_tpu.core import QCQPForm
    np.random.seed(1)
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1 + np.arange(n), np.arange(n), np.arange(n)] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.full(n + 1, -1.0)
    r[0] = float(b @ b)
    form = QCQPForm(jnp.asarray(P, dtype), jnp.asarray(q, dtype),
                    jnp.asarray(r, dtype), jnp.asarray(np.ones(n, bool)))
    brute = None
    if n <= 16:
        signs = 1.0 - 2.0 * ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1)
        brute = float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))
    return form, brute


def sdr_boolean_ls_form(n, dtype=np.float32):
    """bench.py's n-variable boolean-LS SDR instance (bounded relaxation)."""
    import jax.numpy as jnp
    from qcqp_tpu.core import QCQPForm
    rng = np.random.default_rng(2)
    A = rng.standard_normal((n + 20, n))
    b = rng.standard_normal(n + 20)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1 + np.arange(n), np.arange(n), np.arange(n)] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.full(n + 1, -1.0)
    r[0] = float(b @ b)
    return QCQPForm(jnp.asarray(P, dtype), jnp.asarray(q, dtype),
                    jnp.asarray(r, dtype), jnp.asarray(np.ones(n, bool)))


def maxcut_form(n=25, p=0.2, dtype=np.float32):
    import jax.numpy as jnp
    from qcqp_tpu.core import QCQPForm
    np.random.seed(1)
    W = np.random.uniform(0, 1, (n, n))
    W = np.triu(W, 1) + np.triu(W, 1).T + np.eye(n)
    W = (W < p).astype(float)
    P = np.zeros((n + 1, n, n))
    P[0] = 0.25 * W                      # minimize form (maximize negated)
    P[1 + np.arange(n), np.arange(n), np.arange(n)] = 1.0
    r = np.full(n + 1, -1.0)
    r[0] = -0.25 * W.sum()
    return QCQPForm(jnp.asarray(P, dtype), jnp.asarray(np.zeros((n + 1, n)),
                                                       dtype),
                    jnp.asarray(r, dtype), jnp.asarray(np.ones(n, bool)))


def circle_form(dtype=np.float32):
    import qcqp_tpu as qt
    nC, B = 5, 10.0
    X = qt.Variable(2, nC)
    r = qt.Variable()
    cons = [X >= r, X <= B - r, r >= 0]
    for i in range(nC):
        for j in range(i + 1, nC):
            cons.append(qt.square(2 * r) <= qt.sum_squares(X[:, i] - X[:, j]))
    return qt.canonicalize(qt.Problem(qt.Maximize(r), cons), dtype)[0]


def bench_form(n=100, m=50, dtype=np.float32):
    import jax.numpy as jnp
    from bench import make_problem
    from qcqp_tpu.core import QCQPForm
    P, q, r, is_eq = make_problem(n, m)
    return QCQPForm(jnp.asarray(P, dtype), jnp.asarray(q, dtype),
                    jnp.asarray(r, dtype), jnp.asarray(is_eq))


def quality(form, xs, viol_tol=1e-2):
    """Feasible fraction, median violation and best feasible objective."""
    import jax
    from qcqp_tpu.core import eval_objective, max_violation
    v = np.asarray(jax.vmap(lambda x: max_violation(form, x))(xs))
    f = np.asarray(jax.vmap(lambda x: eval_objective(form, x))(xs))
    feas = v < viol_tol
    best = float(f[feas].min()) if feas.any() else float("inf")
    return {"feasible": float(feas.mean()), "median_viol": float(np.median(v)),
            "best_obj": best, "finite": bool(np.isfinite(xs).all())}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_sdr(n_big=100, max_iters=6000):
    """SDR goldens in float32 on the default device, each either accepted
    by the gate or re-solved in float64; the n_big boolean-LS SDR to the
    f32 floor with its iterations and placement."""
    from qcqp_tpu.solvers import sdp
    ph = Phase("sdr")
    forms = (("boolean_ls", boolean_ls_form()[0], GOLDEN["boolean_ls"], 2e-2),
             ("maxcut", maxcut_form(), -GOLDEN["maxcut"], 5e-2),
             ("circle", circle_form(), -GOLDEN["circle"], 5e-2))
    for name, form, golden, tol in forms:
        t0 = time.perf_counter()
        sol = sdp.solve_sdr(form, device="device", check=False, full=True)
        _ready(sol.X)
        dt = time.perf_counter() - t0
        rp, rd = float(sol.primal_res), float(sol.dual_res)
        uv = sdp._unscaled_rel_viol(form, sol.X)
        accepted = (max(rp, rd) <= sdp._INACC_TOL
                    and uv <= sdp._UNSCALED_VIOL_TOL)
        placement = "f32 device accepted"
        if not accepted:
            sol = sdp.solve_sdr(form, device="auto", check=False, full=True)
            placement = "re-solved in f64"
        bound = float(sol.objective)
        ph.check(name, accepted and abs(bound - golden) <= tol,
                 bound=bound, golden=golden, rp=rp, rd=rd,
                 placement=placement, seconds=dt,
                 device=_platform(sol.X))
    form = sdr_boolean_ls_form(n_big)
    run = lambda: sdp.solve_sdr(form, device="device", check=False,
                                full=True, max_iters=max_iters)
    sol, c, s = _timed(run)
    ph.add_time(c, s)
    rp, rd = float(sol.primal_res), float(sol.dual_res)
    ph.check(f"boolean_ls_n{n_big}", max(rp, rd) <= sdp._INACC_TOL,
             iterations=int(sol.iterations), rp=rp, rd=rd,
             bound=float(sol.objective), device=_platform(sol.X),
             placement="f32 device, no re-solve",
             compile_s=c, steady_s=s)
    return ph


def _platform(x):
    return sorted(d.platform for d in x.devices())[0]


def phase_examples():
    """The reference examples' method chains through the QCQP handler,
    run twice: the first run compiles, the second is timed as the steady
    state and its checks are reported; both must pass.  Also the number of
    their SDRs re-solved in float64."""
    with counting_f64_resolves() as resolves:
        t0 = time.perf_counter()
        first = _examples()
        t1 = time.perf_counter()
        ph = _examples()
        t2 = time.perf_counter()
    ph.add_time(t1 - t0, t2 - t1)
    ph.check("first_run", first.ok,
             failed=[k for k, v in first.checks.items() if not v["ok"]])
    ph.check("sdr_placement", True, f64_resolves=resolves.count,
             placement="f32 device accepted" if resolves.count == 0
             else f"{resolves.count} re-solved in f64")
    return ph


def _examples():
    import qcqp_tpu as qt
    ph = Phase("examples")

    # boolean least squares (examples/boolean_least_squares.py)
    np.random.seed(1)
    A = np.random.randn(15, 10)
    b = np.random.randn(15, 1).ravel()
    x = qt.Variable(10)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]))
    h.suggest(qt.SDR)
    runs = {"cd": h.improve(qt.COORD_DESCENT)}
    h.suggest(qt.SDR)
    h.improve(qt.DCCP)
    runs["ccp_cd"] = h.improve(qt.COORD_DESCENT, phase1=False)
    h.suggest(qt.SDR)
    h.improve(qt.COORD_DESCENT)
    runs["cd_admm"] = h.improve(qt.ADMM, phase1=False)
    runs["best_of_256"] = h.solve(num_restarts=256, suggest=qt.SDR,
                                  improve=qt.COORD_DESCENT)
    ph.check("boolean_ls_sdr", abs(h.sdr_bound - GOLDEN["boolean_ls"]) <= 2e-2,
             bound=h.sdr_bound)
    for k, (f, v) in runs.items():
        ph.check(f"boolean_ls_{k}", np.isfinite(f) and v < 1e-2
                 and f >= h.sdr_bound - 1e-2, objective=f, violation=v)

    # maxcut (examples/maxcut.py)
    np.random.seed(1)
    W = np.random.uniform(0, 1, (25, 25))
    W = np.triu(W, 1) + np.triu(W, 1).T + np.eye(25)
    W = (W < 0.2).astype(float)
    x = qt.Variable(25)
    h = qt.QCQP(qt.Problem(
        qt.Maximize(0.25 * (qt.sum_entries(W) - qt.quad_form(x, W))),
        [qt.square(x) == 1]))
    h.suggest(qt.SDR)
    runs = {"cd": h.improve(qt.COORD_DESCENT)}
    h.suggest(qt.SDR)
    runs["ccp"] = h.improve(qt.DCCP, tau=1)
    h.suggest(qt.SDR)
    runs["admm"] = h.improve(qt.ADMM)
    ph.check("maxcut_sdr", abs(h.sdr_bound - GOLDEN["maxcut"]) <= 5e-2,
             bound=h.sdr_bound)
    for k, (f, v) in runs.items():
        ph.check(f"maxcut_{k}", np.isfinite(f) and f <= h.sdr_bound + 5e-2,
                 objective=f, violation=v)

    # circle packing (examples/circle_packing.py)
    nC, B = 5, 10.0
    X = qt.Variable(2, nC)
    r = qt.Variable()
    cons = [X >= r, X <= B - r, r >= 0]
    for i in range(nC):
        for j in range(i + 1, nC):
            cons.append(qt.square(2 * r) <= qt.sum_squares(X[:, i] - X[:, j]))
    h = qt.QCQP(qt.Problem(qt.Maximize(r), cons))
    h.suggest(qt.SDR)
    runs = {"cd": h.improve(qt.COORD_DESCENT)}
    h.suggest(qt.SDR)
    runs["ccp"] = h.improve(qt.DCCP)
    h.suggest(qt.SDR)
    runs["admm"] = h.improve(qt.ADMM)
    ph.check("circle_sdr", abs(h.sdr_bound - GOLDEN["circle"]) <= 5e-2,
             bound=h.sdr_bound)
    for k, (f, v) in runs.items():
        ph.check(f"circle_{k}", np.isfinite(f) and f <= h.sdr_bound + 5e-2,
                 objective=f, violation=v)

    # secondary-user beamforming (examples/secondary_user_beamforming.py)
    n, m, l = 20, 5, 2
    np.random.seed(1)
    HR, HI = np.random.randn(m, n), np.random.randn(m, n)
    GR, GI = np.random.randn(l, n), np.random.randn(l, n)
    A, B_ = np.hstack((HR, HI)), np.hstack((-HI, HR))
    C, D = np.hstack((GR, GI)), np.hstack((-GI, GR))
    x = qt.Variable(2 * n)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(x)), [
        qt.square(A @ x) + qt.square(B_ @ x) >= 20.0,
        qt.square(C @ x) + qt.square(D @ x) <= 2.0]))
    h.suggest(qt.SDR)
    f, v = h.improve(qt.DCCP)
    ph.check("beamforming_sdr",
             abs(h.sdr_bound - GOLDEN["beamforming"]) <= 1e-2,
             bound=h.sdr_bound)
    ph.check("beamforming_ccp",
             abs(f - GOLDEN["beamforming"]) <= 1e-2 and v < 1e-4,
             objective=f, violation=v)
    h.suggest(qt.SDR)
    h.improve(qt.COORD_DESCENT)
    h.improve(qt.ADMM, rho=np.sqrt(m + l))
    f, v = h.improve(qt.COORD_DESCENT, phase1=False)
    ph.check("beamforming_cd_admm_cd", np.isfinite(f)
             and f >= h.sdr_bound - 1e-2, objective=f, violation=v)
    return ph


def phase_cd(n=100, m=50, R=10240, sweeps=10, bls_restarts=256,
             bls_sweeps=50, med_vs_xla=MED_VS_XLA, feas_margin=FEAS_MARGIN,
             **cd_kw):
    """Batched CD through solve_restarts on the routed path; quality on the
    same starts against improve_coord_descent_batch and the percoord path
    (limits med_vs_xla, feas_margin, MED_VS_PERCOORD); boolean-LS best of
    bls_restarts against the brute-force optimum.  cd_kw forwards routing
    overrides (the CPU tests pass use_fused=True, interpret=True)."""
    import jax
    import qcqp_tpu as qt
    from qcqp_tpu.parallel.restarts import (_paths, improve_chain,
                                            solve_restarts)
    from qcqp_tpu.solvers.coord_descent import improve_coord_descent_batch
    from qcqp_tpu.solvers.coord_descent_fused import (
        improve_coord_descent_fused)
    ph = Phase("cd")
    form = bench_form(n, m)
    key = jax.random.PRNGKey(0)
    run = lambda: solve_restarts(form, R, key, improve=qt.COORD_DESCENT,
                                 num_iters=sweeps, **cd_kw)
    (x, f, v), c, s = _timed(run)
    ph.add_time(c, s)
    ph.check("bench_best_finite", np.isfinite(float(f)),
             objective=float(f), violation=float(v),
             path=_paths(form, cd_kw)[qt.COORD_DESCENT],
             restarts_per_s=R / s)

    xs = jax.random.normal(jax.random.PRNGKey(1), (R, n), form.dtype)
    got = quality(form, improve_chain(form, xs, qt.COORD_DESCENT,
                                      num_iters=sweeps, **cd_kw))
    ref = quality(form, improve_coord_descent_batch(form, xs,
                                                    num_iters=sweeps))
    pc = quality(form, improve_coord_descent_fused(form, xs, num_iters=sweeps,
                                                   path="percoord"))
    # Statistical parity on the same starts (trajectories diverge at
    # ulp-tangencies).  No restart is feasible after 10 sweeps at the bench
    # shape, so the median violation carries the comparison; the limits
    # sit above the spread of four sets of starts (PERF.md).
    ok = (got["finite"]
          and got["feasible"] >= ref["feasible"] - feas_margin
          and got["median_viol"] <= med_vs_xla * ref["median_viol"]
          and got["median_viol"] <= MED_VS_PERCOORD * pc["median_viol"])
    ph.check("bench_quality", ok, routed=got, xla_batch=ref, percoord=pc,
             med_vs_xla=got["median_viol"] / max(ref["median_viol"], 1e-30),
             med_vs_percoord=got["median_viol"]
             / max(pc["median_viol"], 1e-30))

    bls, brute = boolean_ls_form()
    _, f, v = solve_restarts(bls, bls_restarts, jax.random.PRNGKey(0),
                             improve=qt.COORD_DESCENT, num_iters=bls_sweeps,
                             **cd_kw)
    f, v = float(f), float(v)
    ph.check("boolean_ls_best", v < 1e-2 and abs(f - brute) <= 2e-2,
             objective=f, violation=v, brute_force=brute)
    return ph


def phase_improve(n=100, m=50, R_admm=1024, R_b=128, admm_iters=50,
                  **route_kw):
    """ADMM, CCP and NLP through solve_restarts on their routed paths.
    route_kw forwards routing overrides (the CPU tests pass use_fused=True
    for the GPU's ADMM path)."""
    import jax
    import qcqp_tpu as qt
    from qcqp_tpu.core import max_violation
    from qcqp_tpu.parallel.restarts import (_paths, improve_chain,
                                            solve_restarts)
    ph = Phase("improve")
    bls, brute = boolean_ls_form()

    # ADMM bucket: best violation of 128 random starts after 300 iterations
    viol = jax.vmap(lambda x: max_violation(bls, x))
    xs = jax.random.normal(jax.random.PRNGKey(1), (128, bls.n), bls.dtype)
    out = improve_chain(bls, xs, qt.ADMM, num_iters=300, **route_kw)
    vio = np.asarray(viol(out))
    ph.check("admm_boolean_ls", vio.min() < 1e-2,
             best_violation=float(vio.min()),
             path=_paths(bls, route_kw)[qt.ADMM], **quality(bls, out))

    xs = jax.random.normal(jax.random.PRNGKey(5), (64, bls.n), bls.dtype)
    qc = quality(bls, improve_chain(bls, xs, qt.DCCP, **route_kw))
    ph.check("ccp_boolean_ls", qc["feasible"] >= 0.9
             and qc["best_obj"] <= 1.35 * brute, brute_force=brute, **qc)

    form = bench_form(n, m)
    xs = jax.random.normal(jax.random.PRNGKey(3), (R_b, n), form.dtype)
    viol = jax.vmap(lambda x: max_violation(form, x))
    out = improve_chain(form, xs, qt.IPOPT, **route_kw)
    v0, v1 = np.asarray(viol(xs)), np.asarray(viol(out))
    # rounding of the f32 violation evaluation itself
    slack = 4 * np.finfo(np.float32).eps * np.maximum(1.0, v0)
    ph.check("nlp_never_worse", bool(np.isfinite(np.asarray(out)).all())
             and bool((v1 <= v0 + slack).all()),
             worst_increase=float(np.max(v1 - v0)))

    key = jax.random.PRNGKey(0)
    for method, R, kw in ((qt.ADMM, R_admm, {"num_iters": admm_iters}),
                          (qt.DCCP, R_b, {}), (qt.IPOPT, R_b, {})):
        run = lambda: solve_restarts(form, R, key, improve=method, **kw,
                                     **route_kw)
        (x, f, v), c, s = _timed(run)
        ph.add_time(c, s)
        ph.check(f"{method}_bench", np.isfinite(float(f))
                 and np.isfinite(float(v)), objective=float(f),
                 violation=float(v), restarts=R, restarts_per_s=R / s,
                 compile_s=c)
    return ph


def phase_precheck():
    """A contradictory-equality form raises InfeasibleRelaxationError from
    the host Farkas pre-check in under a second."""
    import jax.numpy as jnp
    from qcqp_tpu.core import QCQPForm
    from qcqp_tpu.solvers.sdp import InfeasibleRelaxationError, solve_sdr
    ph = Phase("precheck")
    q = np.zeros((3, 3), np.float32)
    q[1, 0] = q[2, 0] = 1.0
    r = np.array([0.0, 0.0, -1.0], np.float32)
    bad = QCQPForm(jnp.zeros((3, 3, 3), jnp.float32), jnp.asarray(q),
                   jnp.asarray(r), jnp.asarray([True, True]))
    t0 = time.perf_counter()
    try:
        solve_sdr(bad, max_iters=20000)
        raised = False
    except InfeasibleRelaxationError:
        raised = True
    dt = time.perf_counter() - t0
    ph.check("infeasible_precheck", raised and dt < 1.0, seconds=dt,
             raised=raised)
    return ph


def phase_four(devices, n=100, m=50, R=10240, sweeps=10, admm_iters=200,
               **cd_kw):
    """Restart sharding (solve_restarts over a mesh, the CD kernel mapped
    per shard) and constraint sharding (admm_phase1_sharded), each against
    its one-device run."""
    import jax
    import jax.numpy as jnp
    import qcqp_tpu as qt
    from qcqp_tpu.kernels.projection import precompute_eigh
    from qcqp_tpu.parallel.mesh import admm_phase1_sharded
    from qcqp_tpu.parallel.restarts import make_mesh, solve_restarts
    from qcqp_tpu.solvers.admm import admm_phase1
    ph = Phase("four")
    form = bench_form(n, m)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(devices)
    (_, f1, v1), c, s = _timed(lambda: solve_restarts(
        form, R, key, improve=qt.COORD_DESCENT, mesh=mesh,
        num_iters=sweeps, **cd_kw))
    ph.add_time(c, s)
    _, f0, v0 = solve_restarts(form, R, key, improve=qt.COORD_DESCENT,
                               num_iters=sweeps, **cd_kw)
    f0, v0, f1, v1 = map(float, (f0, v0, f1, v1))
    close = lambda a, b: abs(a - b) <= 1e-5 * max(abs(a), abs(b), 1e-6)
    ph.check("restart_sharding", close(f1, f0) and close(v1, v0),
             sharded=(f1, v1), single=(f0, v0), devices=len(devices),
             restarts_per_s=R / s)

    x0 = jax.random.normal(jax.random.PRNGKey(2), (n,), form.dtype)
    mesh_c = make_mesh(devices, axis="c")
    (z1, c, s) = _timed(lambda: admm_phase1_sharded(
        form, x0, mesh_c, axis="c", num_iters=admm_iters))
    ph.add_time(c, s)
    z0 = admm_phase1(form, precompute_eigh(form), x0, num_iters=admm_iters)
    diff = float(jnp.max(jnp.abs(z1 - z0)))
    scale = max(1.0, float(jnp.max(jnp.abs(z0))))
    ph.check("constraint_sharding", diff <= 1e-4 * scale, max_abs_diff=diff,
             scale=scale)
    return ph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding phase")
    args = ap.parse_args(argv)

    try:
        import bench  # noqa: F401 — the bench-shape problem generator
        import qcqp_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 2
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    if args.four and len(devs) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    gpu = gpu_info()
    print(gpu, flush=True)
    print(json.dumps({"gpu": gpu, "jax": jax.__version__,
                      "devices": [str(d) for d in devs]}), flush=True)
    if args.four:
        phases = [lambda: phase_four(devs[:4])]
    else:
        phases = [phase_sdr, phase_examples, phase_cd, phase_improve,
                  phase_precheck]
    ok = True
    for fn in phases:
        try:
            line = fn().line()
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            line = {"phase": getattr(fn, "__name__", "phase"), "ok": False,
                    "error": f"{type(e).__name__}: {e}"[:2000]}
        ok = ok and line["ok"]
        print(json.dumps(line, default=float), flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
