"""First-order semidefinite-relaxation solver, fully in JAX.

The reference hands its lifted SDPs to external conic solvers through CVXPY
(reference: qcqp/qcqp.py:64,92 — ECOS/SCS/MOSEK C code is where the whole SDR
hot loop lives).  This module replaces that native dependency with an
operator-splitting (ADMM / Douglas-Rachford) solver that is a single jitted
fixed-point loop on device:

    minimize    <W0, X>
    subject to  <Wi, X> <= / == 0   (i = 1..m)
                <E_nn, X> == 1
                X psd

Splitting: (affine + linear objective)-block prox, solved by a KKT projection
whose Gram matrix K = A A^T + D is formed once as a dense matmul and
pseudo-inverted once by eigh (duplicate/dependent constraint rows are fine);
cone-block prox = batched eigendecomposition -> eigenvalue clamp ->
reconstruct (the PSD projection) plus a ReLU on inequality slacks.  Both
blocks are dense linear algebra; the per-iteration PSD projection of the
(n+1)x(n+1) iterate is the dominant cost.

Extras over a textbook ADMM: over-relaxation (alpha = 1.6) and residual-
balancing adaptive rho (no refactorization needed — K is rho-independent),
and Frobenius normalization of the constraint rows for conditioning.

The reported bound is the converged objective value; at the default
tolerances it matches interior-point answers to ~1e-6 relative on the
reference's example set (validated in tests/test_sdp.py against analytic
solutions and a scipy SLSQP oracle).
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core import QCQPForm, homogeneous_forms


class SDPData(NamedTuple):
    """Preprocessed SDP: stacked constraint matrices and KKT pseudo-inverse."""
    W0: jax.Array      # (N, N) objective (normalized)
    obj_scale: jax.Array
    Wf: jax.Array      # (k, N*N) flattened constraint rows (normalized)
    b: jax.Array       # (k,)
    d: jax.Array       # (k,) inequality-slack coefficient (0 where none)
    Kinv: jax.Array    # (k, k) pseudo-inverse of A A^T + D
    AW0: jax.Array     # (k,) A(W0)
    incons: jax.Array = None  # scalar: affine-inconsistency residual (Farkas)
    Dscale: jax.Array = None  # (N,) Ruiz X-space scaling (X = D Xh D)


# All solver matmuls pin precision=HIGHEST: a reduced-precision f32 matmul
# (bf16 passes, or TF32 on a GPU) floors the splitting residuals far above
# the 1e-4 acceptance gate (the n=100 boolean-LS SDR stalled at 0.4 with
# bf16-pass matmuls and converges with HIGHEST).
_HP = jax.lax.Precision.HIGHEST


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def build_sdp(W0, Ws, b, is_ineq, ruiz_iters: int = 15) -> SDPData:
    """Assemble and precondition the SDP data (one-time, host or device).

    Ruiz equilibration (round 4; ROADMAP item): symmetric D (x) D scaling
    of the lifted X space plus per-row scaling E, iterated to balance the
    inf-norms of the scaled operator rows and X-entry columns.  The
    D-update uses a quarter power because each X entry (i, j) is scaled by
    both D_i and D_j.  The solution map X = D Xh D is applied by the
    solve_sdr/solve_spectral wrappers via SDPData.Dscale; slacks scale
    with their row (d becomes the row's slack coefficient).  Badly scaled
    lifted problems — e.g. a least-squares objective block against unit
    constraint rows — are exactly where the splitting iteration count
    explodes.  ruiz_iters=0 disables.
    """
    N = W0.shape[0]
    k = Ws.shape[0]
    dt = W0.dtype

    D = jnp.ones(N, dt)
    E = jnp.ones(k, dt)
    absW = jnp.abs(Ws)                         # (k, N, N)
    dmask = is_ineq.astype(dt)

    def ruiz_body(_, DE):
        D, E = DE
        DD = D[:, None] * D[None, :]           # (N, N)
        scaled = absW * (E[:, None, None] * DD[None])
        # row inf-norms (incl. the slack column for ineq rows)
        rw = jnp.maximum(jnp.max(scaled.reshape(k, -1), axis=1),
                         dmask * E)
        E = E / jnp.sqrt(jnp.where(rw > 1e-12, rw, 1.0))
        # column (X-entry) inf-norms under the D (x) D structure
        M = jnp.max(absW * E[:, None, None], axis=0)     # (N, N)
        c = jnp.max(M * DD, axis=1)                      # (N,)
        D = D / jnp.sqrt(jnp.sqrt(jnp.where(c > 1e-12, c, 1.0)))
        return D, E

    if ruiz_iters:
        D, E = jax.lax.fori_loop(0, ruiz_iters, ruiz_body, (D, E))

    DD = D[:, None] * D[None, :]
    Ws = Ws * (E[:, None, None] * DD[None])
    b = b * E
    W0 = W0 * DD
    d0 = is_ineq.astype(dt) * E

    Wf = Ws.reshape(k, N * N)
    row_norms = jnp.linalg.norm(Wf, axis=1)
    scale = jnp.where(row_norms > 1e-12, row_norms, 1.0)
    Wf = Wf / scale[:, None]
    b = b / scale
    obj_scale = jnp.maximum(jnp.linalg.norm(W0), 1e-12)
    W0n = W0 / obj_scale
    d = d0 / scale
    G = jnp.dot(Wf, Wf.T, precision=_HP)
    # the slack block contributes diag(d^2) to the Gram (d was 0/1 before
    # Ruiz made it a general per-row coefficient)
    K = G + jnp.diag(d * d)
    lam, V = jnp.linalg.eigh(K)
    lam_inv = jnp.where(lam > 1e-10 * jnp.max(lam), 1.0 / lam, 0.0)
    Kinv = jnp.dot(V * lam_inv, V.T, precision=_HP)
    AW0 = jnp.dot(Wf, W0n.reshape(-1), precision=_HP)
    # Affine-inconsistency residual: the component of b outside
    # range([A, diag(d)]).  A null vector nu of K with b'nu != 0 satisfies
    # A'nu = 0 and d*nu = 0 (nu'K nu = ||A'nu||^2 + sum d nu^2), so
    # sum nu_i W_i = 0 <= 0 and b'nu > 0 — a rigorous Farkas certificate of
    # primal infeasibility (e.g. contradictory equality constraints) that
    # costs nothing at build time.  (Reference-stack parity: ECOS/SCS return
    # 'infeasible' from the homogeneous self-dual embedding,
    # qcqp/qcqp.py:94-95.)
    w_res = b - jnp.dot(K, jnp.dot(Kinv, b, precision=_HP), precision=_HP)
    incons = jnp.linalg.norm(w_res) / jnp.maximum(jnp.linalg.norm(b), 1.0)
    return SDPData(W0n, obj_scale, Wf, b, d, Kinv, AW0, incons, D)


def _affine_prox(data: SDPData, Xt, st, rho):
    """argmin <W0,X> + rho/2 (||X-Xt||^2 + ||s-st||^2)  s.t. A(X) + d*s = b.

    Also returns the row-space KKT multiplier lam: under primal
    infeasibility lam diverges linearly and its per-iteration delta
    converges to a Farkas certificate direction (the infeasibility
    detection of solve_sdp rides on it)."""
    N = data.W0.shape[0]
    rhs = rho * (jnp.dot(data.Wf, Xt.reshape(-1), precision=_HP)
                 + data.d * st - data.b) - data.AW0
    lam = jnp.dot(data.Kinv, rhs, precision=_HP)
    X = Xt - (data.W0
              + jnp.dot(lam, data.Wf, precision=_HP).reshape(N, N)) / rho
    s = st - data.d * lam / rho
    return _sym(X), s, lam


def _cone_proj(X, s):
    lam, Q = jnp.linalg.eigh(_sym(X))
    Xp = jnp.dot(Q * jnp.maximum(lam, 0.0), Q.T, precision=_HP)
    return _sym(Xp), jnp.maximum(s, 0.0)


def _cone_proj_warm(X, s, V, sweeps=2):
    """PSD projection via warm-started Jacobi: rotate into the previous
    eigenbasis (nearly diagonal across consecutive splitting iterates), then
    a couple of matmul-only Jacobi sweeps in place of a full eigh."""
    from ..kernels.jacobi import jacobi_sweeps
    hp = jax.lax.Precision.HIGHEST
    B = jnp.dot(V.T, jnp.dot(_sym(X), V, precision=hp), precision=hp)
    lam, W = jacobi_sweeps(B, sweeps=sweeps)
    Vn = jnp.dot(V, W, precision=hp)
    Xp = jnp.dot(Vn * jnp.maximum(lam, 0.0), Vn.T, precision=hp)
    return _sym(Xp), jnp.maximum(s, 0.0), Vn


def _cone_proj_ns(X, s, ns_steps: int = 12):
    """PSD projection via a Newton-Schulz matrix-sign iteration — pure
    matmuls, no eigendecomposition, no cross-iteration state.

        X_+ = (X + |X|)/2,   |X| = sign(X) X,

    with sign(X) from `ns_steps` quintic NS steps f(S) = (15S - 10S^3 +
    3S^5)/8 — the minimax-monotone odd quintic: f([-1,1]) = [-1,1],
    f'(0) = 15/8, so k steps resolve eigenvalues down to ~(8/15)^k of the
    spectral norm; smaller ones are SOFT-clamped with error proportional to
    their own magnitude (benign for a cone projection).  The iterate is
    normalized by a power-iteration spectral-norm estimate (8 matvecs).

    The f32 device projection: on the n=100 boolean-LS SDR it reaches the
    3e-5 floor in 2123 iterations, against 2157 for the 1-sweep
    warm-Jacobi, with no eigenbasis bookkeeping.  Requires
    precision=HIGHEST: the small-eigenvalue signal must survive ~3k chained
    matmuls (reduced-precision matmuls diverge).  Exactness also restores
    the fixed-point map's stationarity, which the warm-Jacobi path broke
    (Anderson acceleration fails there even at 6 sweeps)."""
    Xs = _sym(X)
    n = Xs.shape[0]
    v0 = 1.0 + 0.01 * jnp.arange(n, dtype=Xs.dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def pw(_, v):
        w = jnp.dot(Xs, jnp.dot(Xs, v, precision=_HP), precision=_HP)
        return w / (jnp.linalg.norm(w) + 1e-30)

    v1 = jax.lax.fori_loop(0, 8, pw, v0)
    w1 = jnp.dot(Xs, v1, precision=_HP)
    smax = jnp.sqrt(jnp.dot(w1, w1)) * 1.05 + 1e-30
    Z = Xs / smax

    def ns(_, S):
        S2 = jnp.dot(S, S, precision=_HP)
        S4 = jnp.dot(S2, S2, precision=_HP)
        M = -10.0 * S2 + 3.0 * S4
        return (15.0 * S + jnp.dot(S, M, precision=_HP)) / 8.0

    S = jax.lax.fori_loop(0, ns_steps, ns, Z)
    absX = smax * jnp.dot(S, Z, precision=_HP)
    Xp = _sym(0.5 * (Xs + absX))
    return Xp, jnp.maximum(s, 0.0)


class SDPState(NamedTuple):
    """Full splitting-iteration state — pass back as `init` to warm-start a
    related instance (parameterized problem families, serving loops).  The
    reference can only re-solve from scratch through CVXPY."""
    Y: jax.Array       # cone-block primal (N, N)
    t: jax.Array       # slack block (k,)
    U: jax.Array       # scaled dual (N, N)
    v: jax.Array       # slack dual (k,)
    V: jax.Array       # running eigenbasis (for psd_method="warm")
    rho: jax.Array


# status_code values (SDPSolution.status_code)
STATUS_OK = 0           # converged or iteration-limited (see residuals)
STATUS_INFEASIBLE = 1   # primal infeasibility certificate found
STATUS_UNBOUNDED = 2    # dual infeasibility (unbounded relaxation) cert found


class SDPSolution(NamedTuple):
    X: jax.Array
    objective: jax.Array
    iterations: jax.Array
    primal_res: jax.Array
    dual_res: jax.Array
    state: SDPState = None
    status_code: jax.Array = None   # one of STATUS_* (None for old callers)


def _power_maxeig(M, iters: int = 60):
    """Largest eigenvalue of symmetric M by shifted power iteration —
    matmul-only (no eigh), so the certificate checks run on the device path
    too.  M + cI with c = ||M||_F is PSD and shares eigenvectors with M.
    v0 is a deterministically perturbed ramp (a constant v0 can
    be near-orthogonal to the top eigenvector — e.g. any eigenvector with a
    zero mean — making the Rayleigh quotient underestimate maxeig and
    letting a non-certificate pass the `mx <= ctol` test)."""
    N = M.shape[0]
    c = jnp.sqrt(jnp.sum(M * M)) + 1e-30
    Ms = M + c * jnp.eye(N, dtype=M.dtype)
    v0 = 1.0 + 0.3 * jnp.sin(jnp.arange(N, dtype=M.dtype))
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = jnp.dot(Ms, v, precision=_HP)
        return w / (jnp.linalg.norm(w) + 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v0)
    return jnp.dot(v, jnp.dot(Ms, v, precision=_HP)) - c


@partial(jax.jit, static_argnames=("max_iters", "psd_method", "warm_sweeps",
                                   "detect_certificates", "accel_mem",
                                   "ns_steps"))
def solve_sdp(data: SDPData, max_iters: int = 20000, tol: float = 1e-8,
              rho0: float = 1.0, alpha: float = None, psd_method: str = "eigh",
              warm_sweeps: int = 2, init: SDPState = None,
              detect_certificates: bool = True, cert_interval: int = 100,
              accel_mem: int = 20, accel_slack: float = 1.2,
              accel_cooldown: int = 2, accel_clamp: float = 100.0,
              stall_iters: int = 3000, ns_steps: int = 12):
    """Run the splitting loop until residuals drop below tol.

    psd_method:
      "eigh" — exact eigendecomposition per iteration (default; host/f64)
      "warm" — warm-started Jacobi sweeps in the running eigenbasis
               (matmul-only; the batched on-device path, see _cone_proj_warm)
      "ns"   — Newton-Schulz matrix-sign projection (matmul-only,
               stateless; the on-device default, see _cone_proj_ns)
    init: a previous SDPSolution.state to warm-start from (same shapes).

    Anderson acceleration (~3000 plain splitting
    iterations were the whole gap to interior-point-class latency):
    type-II AA with a ring-buffer memory of `accel_mem` iterate/residual
    difference pairs over the full (Y, t, U, v) fixed point.  The
    accelerated candidate w_AA = w_F - gamma (dW + dR), with gamma from a
    regularized mem x mem least squares, costs two (mem, D) matvecs per
    iteration — negligible next to the cone projection.  Safeguards: the
    memory is flushed (and the plain step taken) whenever the fixed-point
    residual grows or rho is rescaled, so the iteration inherits the plain
    splitting's convergence.  accel_mem=0 disables.

    Infeasibility / unboundedness detection (the
    one capability the reference's conic solvers had that this stack
    lacked, reference status semantics qcqp/qcqp.py:94-95): every
    cert_interval iterations the normalized per-interval deltas of the
    iterates are tested as Farkas certificates, SCS/OSQP-style (Banjac et
    al., "Infeasibility detection in the ADMM for convex optimization"):

      * primal infeasibility: delta of the affine-prox multiplier lam
        converges (when the duals diverge linearly) to a direction nu with
        sum nu_i W_i <= 0, nu <= 0 on inequality rows, b'nu > 0;
      * dual infeasibility (unbounded relaxation): delta of the cone
        iterate (Y, t) converges to a recession direction dY >= 0,
        d*dt >= 0, A(dY) + d*dt = 0 with <W0, dY> < 0.

    All tests are matmul-only (shifted power iterations instead of eigh)
    so they run identically on the device path.  The loop exits as soon as
    a certificate validates; SDPSolution.status_code reports it.
    """
    N = data.W0.shape[0]
    k = data.b.shape[0]
    dt = data.W0.dtype
    if alpha is None:
        # over-relaxation (1.6) speeds the PLAIN loop but destabilizes the
        # accelerated one (measured: maxcut SDR converges in 664 iters with
        # alpha=1.0+AA, never in 20000 with alpha=1.6+AA); AA more than
        # makes up for the un-relaxed base step.
        alpha = 1.0 if accel_mem > 0 else 1.6
    # certificate tolerances: f32 deltas are noisier than f64
    ctol = 1e-4 if dt == jnp.float64 else 1e-3
    cmarg = 1e-2           # required normalized margin on the strict parts
    dmin = 1e-12           # minimum delta magnitude to even test

    if init is not None:
        Y0, t0, U0, v0, V0 = init.Y, init.t, init.U, init.v, init.V
        rho0 = init.rho
    else:
        Y0 = jnp.eye(N, dtype=dt)
        t0 = jnp.zeros(k, dt)
        U0 = jnp.zeros((N, N), dt)
        v0 = jnp.zeros(k, dt)
        V0 = jnp.eye(N, dtype=dt)

    # Build-time Farkas certificate: b has a component outside
    # range([A, diag(d)]) => the affine system itself is infeasible
    # (contradictory equalities classify here at iteration 0).
    incons_tol = 1e-6 if dt == jnp.float64 else 1e-3
    # The build-time Farkas check rides on the Kinv pseudo-inverse, whose
    # f32 eigh on an accelerator can be too inaccurate (seen: incons >
    # 1e-3 on the feasible maxcut SDR => false 'infeasible' at iteration
    # 0).  Trust it only for f64 data or on the CPU backend.  The
    # delta-iterate certificates below don't involve Kinv and stay on
    # everywhere.
    trust_incons = (dt == jnp.float64) or (jax.default_backend() == "cpu")
    if detect_certificates and data.incons is not None and trust_incons:
        status0 = jnp.where(data.incons > incons_tol,
                            STATUS_INFEASIBLE, STATUS_OK)
    else:
        status0 = STATUS_OK

    def _check_certs(args):
        """Certificate tests on the normalized deltas; returns status."""
        dlam, dY, dtv = args
        # --- primal infeasibility from the dual-direction delta ---
        nl = jnp.linalg.norm(dlam)
        lamc = dlam / jnp.maximum(nl, 1e-30)
        M = jnp.dot(lamc, data.Wf, precision=_HP).reshape(N, N)
        M = _sym(M)
        mx_pos = _power_maxeig(M)        # maxeig(M)
        mx_neg = _power_maxeig(-M)       # -mineig(M)
        blam = jnp.dot(data.b, lamc, precision=_HP)
        dmax = jnp.max(data.d * lamc)
        dmin_l = jnp.min(data.d * lamc)

        def feas_cert(sgn_blam, mx, dbound):
            return (nl > dmin) & (mx <= ctol) & (dbound <= ctol) & \
                   (sgn_blam >= cmarg)

        infeas = feas_cert(blam, mx_pos, dmax) | \
            feas_cert(-blam, mx_neg, -dmin_l)

        # --- dual infeasibility (unboundedness) from the primal delta ---
        nY = jnp.sqrt(jnp.sum(dY * dY) + jnp.sum(dtv * dtv))
        Yc = dY / jnp.maximum(nY, 1e-30)
        tc = dtv / jnp.maximum(nY, 1e-30)
        a_res = jnp.linalg.norm(
            jnp.dot(data.Wf, Yc.reshape(-1), precision=_HP) + data.d * tc)
        psd_ok = _power_maxeig(-_sym(Yc)) <= ctol     # Yc >= -ctol
        slack_ok = jnp.min(jnp.where(data.d > 0.0, tc, 0.0)) >= -ctol
        obj_dir = jnp.sum(data.W0 * Yc)
        unbdd = (nY > dmin) & (a_res <= ctol) & psd_ok & slack_ok & \
            (obj_dir <= -cmarg)

        return jnp.where(infeas, STATUS_INFEASIBLE,
                         jnp.where(unbdd, STATUS_UNBOUNDED,
                                   STATUS_OK)).astype(jnp.int32)

    D = 2 * N * N + 2 * k      # flattened (Y, t, U, v) fixed-point dim

    def _pack(Y, t, U, v):
        return jnp.concatenate([Y.ravel(), t, U.ravel(), v])

    def _unpack(w):
        Y = w[:N * N].reshape(N, N)
        t = w[N * N:N * N + k]
        U = w[N * N + k:2 * N * N + k].reshape(N, N)
        v = w[2 * N * N + k:]
        return Y, t, U, v

    # For f64 the stall exit only fires once the best residual is near the
    # achievable floor (1e4*eps = 2.2e-12: hard f64 instances
    # can plateau above tol for >stall_iters before dropping — exiting
    # there would silently change check_status behavior for solves that
    # WOULD converge).  f32 keeps the unconditional round-4 stall exit:
    # its plateaus are instance-dependent (3e-5 .. 1e-2+) and the device
    # result is residual-gated with a host fallback anyway, so spinning an
    # above-floor plateau to max_iters — TWICE, counting the ns_steps=20
    # retry — buys nothing (review r5).
    stall_floor = (1e4 * float(jnp.finfo(dt).eps)
                   if dt == jnp.float64 else float(jnp.inf))

    def cond(c):
        # stall exit: once the best iterate hasn't improved for
        # stall_iters iterations AND that best is near the dtype residual
        # floor, spinning to max_iters buys nothing (the circle-packing
        # f32 SDR floors at ~9e-5 and used to burn its whole cap)
        stalled = (c["it"] - c["improve_it"] > stall_iters) & \
            (jnp.maximum(c["best_rp"], c["best_rd"]) <= stall_floor)
        return (c["it"] < max_iters) & ~stalled & \
               ((c["rp"] > tol) | (c["rd"] > tol)) & \
               (c["status"] == STATUS_OK)

    def body(c):
        Y, t, U, v, V = c["Y"], c["t"], c["U"], c["v"], c["V"]
        rho, status = c["rho"], c["status"]
        X1, s1, lam = _affine_prox(data, Y - U, t - v, rho)
        # over-relaxation
        Xr = alpha * X1 + (1 - alpha) * Y
        sr = alpha * s1 + (1 - alpha) * t
        if psd_method == "warm":
            Yn, tn, V = _cone_proj_warm(Xr + U, sr + v, V, warm_sweeps)
        elif psd_method == "ns":
            Yn, tn = _cone_proj_ns(Xr + U, sr + v, ns_steps)
        else:
            Yn, tn = _cone_proj(Xr + U, sr + v)
        Un = U + Xr - Yn
        vn = v + sr - tn

        rp = jnp.sqrt(jnp.sum((X1 - Yn) ** 2) + jnp.sum((s1 - tn) ** 2))
        rd = rho * jnp.sqrt(jnp.sum((Yn - Y) ** 2) + jnp.sum((tn - t) ** 2))

        if detect_certificates:
            # Snapshots are taken at EVERY interval boundary; the
            # classification only runs from the second boundary on (the
            # first delta against the zero-initialized snapshots is the
            # raw iterate, not an inter-interval difference) and must
            # repeat on two consecutive intervals before exiting (a
            # one-shot test on a noisy delta can misclassify a
            # feasible problem).  The snapshot/classify gates are split —
            # a shared gate would leave the first executed check comparing
            # against zeros, exactly the raw-iterate test being skipped.
            at_bound = c["it"] % cert_interval == cert_interval - 1
            do_chk = at_bound & (c["it"] >= 2 * cert_interval - 1) & \
                (rp > 10.0 * tol)
            cand = jax.lax.cond(
                do_chk,
                _check_certs,
                lambda args: jnp.asarray(STATUS_OK, jnp.int32),
                (lam - c["lam_c"], Yn - c["Y_c"], tn - c["t_c"]))
            confirmed = do_chk & (cand != STATUS_OK) & \
                (cand == c["cert_cand"])
            status = jnp.where(confirmed, cand, status)
            c["cert_cand"] = jnp.where(do_chk, cand, c["cert_cand"])
            c["lam_c"] = jnp.where(at_bound, lam, c["lam_c"])
            c["Y_c"] = jnp.where(at_bound, Yn, c["Y_c"])
            c["t_c"] = jnp.where(at_bound, tn, c["t_c"])

        # Residual balancing every 50 iterations (K is rho-independent, so
        # changing rho costs nothing but a dual rescale).  OSQP-style smooth
        # factor sqrt(rp/rd) clipped to [1/5, 5]; the coarse 2x/0.5x step
        # this replaces left a persistent imbalance that stalled the tail at
        # ~1e-6 residuals (ROADMAP item 4).
        do_adapt = (c["it"] % 50 == 49) & (rp > 0.0) & (rd > 0.0) & \
            jnp.isfinite(rp) & jnp.isfinite(rd)
        ratio = jnp.sqrt(jnp.maximum(rp, 1e-300) / jnp.maximum(rd, 1e-300))
        factor = jnp.where(do_adapt & ((ratio > 1.2) | (ratio < 1.0 / 1.2)),
                           jnp.clip(ratio, 0.2, 5.0), 1.0)
        rho_n = rho * factor
        Un = Un / factor
        vn = vn / factor

        # Best-iterate tracking: the f32 device path can converge to its
        # residual floor and then diverge hundreds of iterations later
        # (measured on the circle-packing SDR: rp 3.9e-4 at 6k iterations,
        # 3.6 at 20k).  Return the best (Y, t) seen, not the last.
        isbet = jnp.maximum(rp, rd) < jnp.maximum(c["best_rp"], c["best_rd"])
        c["best_Y"] = jnp.where(isbet, Yn, c["best_Y"])
        c["best_t"] = jnp.where(isbet, tn, c["best_t"])
        c["best_rp"] = jnp.where(isbet, rp, c["best_rp"])
        c["best_rd"] = jnp.where(isbet, rd, c["best_rd"])
        c["improve_it"] = jnp.where(isbet, c["it"], c["improve_it"])

        if accel_mem > 0:
            # --- type-II Anderson acceleration on w = (Y, t, U, v) ---
            w = _pack(Y, t, U, v)
            wF = _pack(Yn, tn, Un, vn)
            r = wF - w
            rnorm = jnp.linalg.norm(r)
            # Safeguard: a grown fixed-point residual means the last AA
            # candidate was an excursion — DISCARD the current point,
            # restart from the plain step of the last good iterate (stored
            # as w_last + r_last), flush the memory, and run plain for a
            # cooldown stretch.  Without the discard+cooldown, AA with a
            # 1-pair memory re-fires immediately after each reset and can
            # limit-cycle on a bad region (seen: rp stuck at 3.7 for 20000
            # iterations on a run that converges in ~1600 with this fix).
            # Rescale iterations are excluded from the `bad` test:
            # the dual rescale itself jumps rnorm, and the revert
            # point w_last + r_last holds duals saved under the PREVIOUS
            # rho — reverting there with the rescaled rho carried forward
            # would leave (U, v) inconsistent with rho by up to the
            # factor.  `reset` already flushes the memory on a rescale,
            # and rnorm_last is set to inf below so the polluted rnorm of
            # this iteration never becomes the next baseline either.
            resc = factor != 1.0
            bad = ((~jnp.isfinite(rnorm)) |
                   (rnorm > accel_slack * c["rnorm_last"])) & ~resc
            wF_prev = c["w_last"] + c["r_last"]
            reset = bad | resc
            hlen = jnp.where(reset, 0, c["hlen"])
            dW = jnp.where(reset, 0.0, c["dW"])
            dR = jnp.where(reset, 0.0, c["dR"])
            cool = jnp.where(bad, accel_cooldown,
                             jnp.maximum(c["cool"] - 1, 0))
            have = hlen > 0
            dW = jnp.roll(dW, 1, axis=0).at[0].set(
                jnp.where(have, w - c["w_last"], 0.0))
            dR = jnp.roll(dR, 1, axis=0).at[0].set(
                jnp.where(have, r - c["r_last"], 0.0))
            hnew = jnp.minimum(hlen + 1, accel_mem)
            G = jnp.dot(dR, dR.T, precision=_HP)
            reg = 1e-12 * jnp.trace(G) + 1e-30
            Greg = G + reg * jnp.eye(accel_mem, dtype=dt)
            rhs = jnp.dot(dR, r, precision=_HP)

            # tiny PSD solve by fixed-trip CG: on a regularized (mem, mem)
            # Gram it is exact to machine precision in <= mem steps, and it
            # vmaps in any dtype
            def cg(_, s):
                x, rr, p, rs = s
                Gp = jnp.dot(Greg, p, precision=_HP)
                den = p @ Gp
                ok = den > 1e-300
                a = jnp.where(ok, rs / jnp.where(ok, den, 1.0), 0.0)
                x = x + a * p
                rr = rr - a * Gp
                rs_new = rr @ rr
                beta = jnp.where(ok, rs_new / jnp.maximum(rs, 1e-300), 0.0)
                return x, rr, rr + beta * p, rs_new

            gam, _, _, _ = jax.lax.fori_loop(
                0, 2 * accel_mem, cg,
                (jnp.zeros_like(rhs), rhs, rhs, rhs @ rhs))
            wAA = wF - jnp.dot(gam, dW + dR, precision=_HP)
            # the AA correction is O(residual) near the fixed point; scale
            # an outsized one back to accel_clamp * ||r|| (ill-conditioned
            # LS guard; on the inexact warm-projection paths a small clamp
            # also keeps the extrapolation within the warm eigenbasis's
            # tracking range)
            corr = wAA - wF
            cn = jnp.linalg.norm(corr)
            wAA = wF + jnp.minimum(1.0, accel_clamp * rnorm
                                   / (cn + 1e-30)) * corr
            use = have & (cool == 0) & jnp.all(jnp.isfinite(wAA))
            w_next = jnp.where(bad, wF_prev, jnp.where(use, wAA, wF))
            Ya, ta, Ua, va = _unpack(w_next)
            Yn, tn, Un, vn = _sym(Ya), ta, _sym(Ua), va
            # On a discarded excursion: keep (w_last, r_last) pointing at
            # the last good pair, but RESET the residual baseline to inf so
            # the next (plain) step is accepted unconditionally — comparing
            # it against the old good residual can fire `bad` forever and
            # pin the iterate at the revert point (observed: rp stuck at
            # ~0.3 for 20000 iters).
            c.update(dW=dW, dR=dR,
                     w_last=jnp.where(bad, c["w_last"], w),
                     r_last=jnp.where(bad, c["r_last"], r),
                     rnorm_last=jnp.where(bad | resc,
                                          jnp.asarray(jnp.inf, dt), rnorm),
                     hlen=hnew, cool=cool)

        c.update(Y=Yn, t=tn, U=Un, v=vn, V=V, rho=rho_n, it=c["it"] + 1,
                 rp=rp, rd=rd, status=status)
        return c

    big = jnp.asarray(jnp.inf, dt)
    carry = dict(Y=Y0, t=t0, U=U0, v=v0, V=V0, rho=jnp.asarray(rho0, dt),
                 it=jnp.asarray(0), rp=big, rd=big,
                 lam_c=jnp.zeros(k, dt), Y_c=Y0, t_c=t0,
                 cert_cand=jnp.asarray(STATUS_OK, jnp.int32),
                 best_Y=Y0, best_t=t0, best_rp=big, best_rd=big,
                 improve_it=jnp.asarray(0),
                 status=jnp.asarray(status0, jnp.int32))
    if accel_mem > 0:
        carry.update(dW=jnp.zeros((accel_mem, D), dt),
                     dR=jnp.zeros((accel_mem, D), dt),
                     w_last=jnp.zeros(D, dt), r_last=jnp.zeros(D, dt),
                     rnorm_last=big, hlen=jnp.asarray(0),
                     cool=jnp.asarray(0))
    c = jax.lax.while_loop(cond, body, carry)
    Y, t, U, v, V, rho = c["Y"], c["t"], c["U"], c["v"], c["V"], c["rho"]
    Yb = c["best_Y"]
    obj = jnp.sum(data.W0 * Yb) * data.obj_scale
    # solution/residuals are the best iterate; state is the LAST iterate
    # (warm-start continuity, SCALED space).  X is mapped back through the
    # Ruiz scaling (X = D Xh D) so callers see the original coordinates.
    Xout = Yb
    if data.Dscale is not None:
        Xout = data.Dscale[:, None] * Yb * data.Dscale[None, :]
    return SDPSolution(Xout, obj, c["it"], c["best_rp"], c["best_rd"],
                       SDPState(Y, t, U, v, V, rho), c["status"])


# ---------------------------------------------------------------------------
# QCQP-facing entry points (the reference's solve_sdr / solve_spectral)
# ---------------------------------------------------------------------------

@jax.jit
def _sdr_data(form: QCQPForm) -> SDPData:
    """(jitted: one compiled program instead of ~40 eager dispatches)"""
    M = homogeneous_forms(form)        # (m+1, N, N)
    W0, Wc = M[0], M[1:]
    N = W0.shape[0]
    E = jnp.zeros((1, N, N), form.dtype).at[0, N - 1, N - 1].set(1.0)
    Ws = jnp.concatenate([Wc, E], axis=0)
    b = jnp.concatenate([jnp.zeros(form.m, form.dtype),
                         jnp.ones(1, form.dtype)])
    is_ineq = jnp.concatenate([~form.is_eq, jnp.zeros(1, bool)])
    return build_sdp(W0, Ws, b, is_ineq)


# Inaccurate-status gate shared between check_status and _solve_single's
# device-first acceptance test (a hardcoded duplicate let the
# fallback decision and the status gate diverge if inacc_tol was overridden).
_INACC_TOL = 1e-4

# Unscaled-coordinate acceptance gate (relative, per-row-normalized); see
# _unscaled_rel_viol.  10x the scaled gate: Ruiz distortion of a residual is
# bounded by max(D_i D_j)/scale, measured < 10 on the golden set.
_UNSCALED_VIOL_TOL = 10 * _INACC_TOL


def _unscaled_rel_viol(form: QCQPForm, X):
    """Max relative affine violation of the lifted X in ORIGINAL (pre-Ruiz)
    coordinates (after Ruiz equilibration all loop residuals live
    in scaled coordinates, so on badly scaled problems — exactly the ones
    Ruiz targets — a scaled-converged X can carry an unscaled violation
    inflated by up to max(D_i D_j)/scale).  OSQP-style: each row residual is
    normalized by its own data norm and the solution magnitude, so the gate
    is scale-free.  (jitted core + one host read.)"""
    return float(_unscaled_rel_viol_jit(form, X))


@jax.jit
def _unscaled_rel_viol_jit(form: QCQPForm, X):
    M = homogeneous_forms(form)              # (m+1, N, N)
    Xn = 1.0 + jnp.linalg.norm(X)
    vals = jnp.einsum("kij,ij->k", M[1:], X)
    if form.m:
        rown = jnp.maximum(
            jnp.linalg.norm(M[1:].reshape(form.m, -1), axis=1), 1e-12)
        v = jnp.where(form.is_eq, jnp.abs(vals), jnp.maximum(vals, 0.0))
        vmax = jnp.max(v / (rown * Xn))
    else:
        vmax = jnp.zeros((), form.dtype)
    return jnp.maximum(vmax, jnp.abs(X[-1, -1] - 1.0) / Xn)


class InfeasibleRelaxationError(RuntimeError):
    """The relaxation is primal infeasible (certified)."""


class UnboundedRelaxationError(RuntimeError):
    """The relaxation is unbounded below (dual infeasibility certified)."""


def check_status(sol: SDPSolution, tol: float, inacc_tol: float = _INACC_TOL):
    """Reference-parity status gate (qcqp/qcqp.py:66-67,94-95): OPTIMAL /
    OPTIMAL_INACCURATE pass (the latter with a warning); anything else
    raises.  Certified infeasibility / unboundedness raise DISTINCT error
    types (the classification the reference got from ECOS/SCS's homogeneous
    self-dual embedding; slow and infeasible used to
    share one RuntimeError).
    """
    import logging
    if sol.status_code is not None:
        code = int(sol.status_code)
        if code == STATUS_INFEASIBLE:
            raise InfeasibleRelaxationError(
                "Relaxation problem status: infeasible "
                f"(certificate found after {int(sol.iterations)} iters)")
        if code == STATUS_UNBOUNDED:
            raise UnboundedRelaxationError(
                "Relaxation problem status: unbounded "
                f"(certificate found after {int(sol.iterations)} iters)")
    rp, rd = float(sol.primal_res), float(sol.dual_res)
    if rp <= tol and rd <= tol:
        return "optimal"
    if rp <= inacc_tol and rd <= inacc_tol:
        logging.getLogger("qcqp_tpu").warning(
            "SDP solved inaccurately (residuals %.2e / %.2e)", rp, rd)
        return "optimal_inaccurate"
    raise RuntimeError(
        f"Relaxation problem status: not converged "
        f"(primal {rp:.2e}, dual {rd:.2e} after {int(sol.iterations)} iters)")


# f32 splitting iterations bottom out near this residual; asking for less
# just spins the loop to max_iters (the f64 default tol stays 1e-8).
_F32_TOL_FLOOR = 3e-5


def _relaxation_device(device):
    """Placement of single-instance relaxations: "auto" and "device" keep
    them on the default device (a GPU computes float64 natively);
    device="host" asks for the host CPU explicitly; a concrete jax.Device
    is honored as-is.  Returns None for the default device."""
    if device in ("auto", "device"):
        return None
    if device == "host":
        if jax.default_backend() != "cpu":
            return jax.devices("cpu")[0]
        return None
    return device


def _solve_f64(data_fn, form: QCQPForm, max_iters, tol, dev, init, sk):
    """float64 solve on `dev` (None: the default device); the solution is
    cast back to the form's dtype."""
    form64 = form.astype(jnp.float64)
    if init is not None:
        init = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init)
    if dev is not None:
        form64, init = jax.device_put((form64, init), dev)
    with (jax.default_device(dev) if dev is not None
          else contextlib.nullcontext()):
        sol = solve_sdp(data_fn(form64), max_iters=max_iters, tol=tol,
                        init=init, **sk)
    return SDPSolution(sol.X.astype(form.dtype), sol.objective,
                       sol.iterations, sol.primal_res, sol.dual_res,
                       sol.state, sol.status_code), tol


def _spectral_rel_viol(form: QCQPForm, X):
    """Unscaled relative violation of the AGGREGATED spectral constraints
    (the relaxation only enforces the two summed rows, not each original
    one — see _spectral_data).  Jitted core, like _unscaled_rel_viol."""
    return float(_spectral_rel_viol_jit(form, X))


@jax.jit
def _spectral_rel_viol_jit(form: QCQPForm, X):
    M = homogeneous_forms(form)
    ineq_mask = (~form.is_eq).astype(form.dtype)
    eq_mask = form.is_eq.astype(form.dtype)
    W1 = jnp.einsum("i,ijk->jk", ineq_mask, M[1:])
    W2 = jnp.einsum("i,ijk->jk", eq_mask, M[1:])
    Xn = 1.0 + jnp.linalg.norm(X)
    v1 = jnp.maximum(jnp.sum(W1 * X), 0.0) / \
        (jnp.maximum(jnp.linalg.norm(W1), 1e-12) * Xn)
    v2 = jnp.abs(jnp.sum(W2 * X)) / \
        (jnp.maximum(jnp.linalg.norm(W2), 1e-12) * Xn)
    return jnp.maximum(jnp.maximum(v1, v2),
                       jnp.abs(X[-1, -1] - 1.0) / Xn)


def _affine_farkas_infeasible(form: QCQPForm) -> bool:
    """Host-f64 build-time Farkas pre-check for the SDR affine system:
    classify contradictory-equality problems BEFORE the
    f32 device attempt instead of after ~12000 wasted device iterations
    plus the host fallback.

    Mirrors build_sdp's inconsistency residual — the component of b outside
    range([A, diag(d)]) certifies primal infeasibility (reference-stack
    parity: ECOS/SCS classify in one solve, qcqp/qcqp.py:94-95) — but runs
    in numpy float64 on the host because an f32 eigh pseudo-inverse can
    misclassify feasible problems.  Row consistency is Ruiz-invariant, so
    no equilibration is needed.  Cost: one (k, N^2) x (N^2, k) host matmul
    + a (k, k) eigh — milliseconds — plus one device->host read of the
    form tensors.  A classification, not a solve: it does no device work."""
    import numpy as np
    P = np.asarray(form.P, dtype=np.float64)      # (m+1, n, n)
    q = np.asarray(form.q, dtype=np.float64)
    r = np.asarray(form.r, dtype=np.float64)
    m = form.m
    n = P.shape[-1]
    N = n + 1
    M = np.zeros((m, N, N))                       # lifted constraint rows
    M[:, :n, :n] = P[1:]
    M[:, :n, n] = 0.5 * q[1:]
    M[:, n, :n] = 0.5 * q[1:]
    M[:, n, n] = r[1:]
    Wf = M.reshape(m, N * N)
    E = np.zeros((1, N * N))
    E[0, -1] = 1.0
    Wf = np.concatenate([Wf, E], axis=0)                        # (k, N^2)
    b = np.zeros(m + 1)
    b[-1] = 1.0
    d = np.concatenate([~np.asarray(form.is_eq), [False]]).astype(float)
    scale = np.maximum(np.linalg.norm(Wf, axis=1), 1e-12)
    Wf /= scale[:, None]
    b /= scale
    d /= scale
    K = Wf @ Wf.T + np.diag(d * d)
    lam, V = np.linalg.eigh(K)
    lam_inv = np.where(lam > 1e-10 * lam.max(), 1.0 / lam, 0.0)
    w = b - K @ ((V * lam_inv) @ (V.T @ b))
    return float(np.linalg.norm(w) / max(np.linalg.norm(b), 1.0)) > 1e-6


def _solve_single(data_fn, form: QCQPForm, max_iters, tol, device,
                  init: SDPState = None, solver_kwargs: dict = None,
                  uviol_fn=None, farkas_precheck: bool = False):
    """Returns (sol, eff_tol): eff_tol is the dtype-achievable tolerance the
    status gate should be checked against.

    Placement: f32 forms on the GPU solve on the device in f32 first
    (Newton-Schulz cone projection); the f32-achievable residual floor is
    instance-dependent (3e-5 on the n=100 boolean-LS SDR, ~1.5e-4 on the
    n=25 maxcut SDR), so if the device result misses the inaccurate-status
    gate the solve is repeated in float64 on the same device.
    device="device" forces the f32 attempt with no re-solve; device="host"
    solves in float64 on the host CPU.
    """
    sk = solver_kwargs or {}
    if (device == "auto" and form.dtype == jnp.float32
            and jax.default_backend() != "cpu"):
        # Certificates are OFF for the f32 device attempt: the build-time
        # Farkas check rides on an f32 eigh pseudo-inverse (a false
        # 'infeasible' at iteration 0 was seen on the feasible maxcut SDR),
        # and a wrong classification is worse than a slow re-solve.
        # Infeasible problems fail the residual gate below and get
        # classified by the f64 re-solve, whose certificates are
        # trustworthy.  Host-f64 Farkas pre-check: contradictory-equality
        # forms classify here in milliseconds instead of paying the full
        # device attempt + retry + f64 re-solve.  Only the SDR path sets
        # farkas_precheck (the spectral relaxation aggregates rows, so the
        # per-row system is not its affine system).
        if farkas_precheck and form.m > 0 and \
                sk.get("detect_certificates", True) and \
                _affine_farkas_infeasible(form):
            # numpy result carriers: the classification is host work
            import numpy as np
            Nn = form.n + 1
            npdt = np.dtype(form.dtype)
            return SDPSolution(
                np.zeros((Nn, Nn), npdt), np.asarray(np.inf, npdt), 0,
                np.asarray(np.inf, npdt), np.asarray(np.inf, npdt), None,
                STATUS_INFEASIBLE), tol

        dev_sk = dict(sk)
        dev_sk.setdefault("detect_certificates", False)

        def _accept(s):
            # scaled residual gate + unscaled-coordinate violation gate:
            # a Ruiz-scaled-converged X must also satisfy the
            # ORIGINAL constraints to a scale-free tolerance before the
            # f32 device result is accepted.
            if float(s.primal_res) > _INACC_TOL or \
                    float(s.dual_res) > _INACC_TOL:
                return False
            if uviol_fn is None:
                return True
            uv = uviol_fn(form, s.X)
            if uv > _UNSCALED_VIOL_TOL:
                import logging
                logging.getLogger("qcqp_tpu").debug(
                    "device f32 SDP passed the scaled gate but carries "
                    "%.2e unscaled relative violation (> %.0e)", uv,
                    _UNSCALED_VIOL_TOL)
                return False
            return True

        sol, eff = _solve_single(data_fn, form, max_iters, tol, "device",
                                 init=init, solver_kwargs=dev_sk)
        if _accept(sol):
            return sol, eff
        if "ns_steps" not in dev_sk:
            # Retry once with a deeper (20-step) Newton-Schulz sign
            # iteration, warm-started from the 12-step floor: the extra
            # steps resolve eigenvalues ~150x closer to zero, dropping the
            # residual floor on inequality-heavy instances, but cost 20/12
            # the matmuls per iteration — the common case keeps the 12-step
            # path.
            sk3 = dict(dev_sk, ns_steps=20)
            sol3, eff3 = _solve_single(data_fn, form, max_iters, tol,
                                       "device", init=sol.state,
                                       solver_kwargs=sk3)
            if _accept(sol3):
                return sol3, eff3
        rp, rd = float(sol.primal_res), float(sol.dual_res)
        import logging
        logging.getLogger("qcqp_tpu").debug(
            "on-device f32 SDP attempt discarded (residuals %.2e / %.2e "
            "miss the %.0e gate); re-solving in f64 on the device", rp, rd,
            _INACC_TOL)
        return _solve_f64(data_fn, form, max_iters, tol, None, init, sk)
    dev = _relaxation_device(device)
    if dev is not None:                  # device="host" or a jax.Device
        return _solve_f64(data_fn, form, max_iters, tol, dev, init, sk)
    psd = "eigh"
    if form.dtype == jnp.float32:
        tol = max(tol, _F32_TOL_FLOOR)
        if jax.default_backend() != "cpu":
            psd = "ns"
    if psd == "ns":
        # Newton-Schulz projection, see _cone_proj_ns.  Anderson
        # acceleration fires on this near-exact stateless map (804 iters
        # at ns_steps=16, vs a stall on every warm-Jacobi configuration)
        # but adds ring-buffer updates and (mem, D) matvecs per iteration;
        # whether that pays on the GPU is not measured, so it stays off.
        # alpha > 1 over-relaxation diverges here with either projection
        # (8000-iteration stall at 1.3 and 1.6).
        sk = dict(sk)
        sk.setdefault("accel_mem", 0)
        sk.setdefault("alpha", 1.0)
    sol = solve_sdp(data_fn(form), max_iters=max_iters, tol=tol,
                    psd_method=psd, init=init, **sk)
    return sol, tol


def solve_sdr(form: QCQPForm, max_iters: int = 20000, tol: float = 1e-8,
              check: bool = True, device="auto", warm: SDPState = None,
              full: bool = False, solver_kwargs: dict = None, **_ignored):
    """Full Shor relaxation (reference: qcqp/qcqp.py:72-97).

    Returns (X, bound) with X the (n+1)x(n+1) PSD lifted solution.
    warm: a previous solution's `.state` for a *related* instance (same
    shapes) — parameterized problem families re-solve in a fraction of the
    cold iteration count.  full=True returns the SDPSolution (with `.state`)
    instead of the (X, bound) pair.
    """
    sol, eff_tol = _solve_single(_sdr_data, form, max_iters, tol, device,
                                 init=warm, solver_kwargs=solver_kwargs,
                                 uviol_fn=_unscaled_rel_viol,
                                 farkas_precheck=True)
    if check:
        check_status(sol, eff_tol)
    if full:
        return sol
    return sol.X, sol.objective


def solve_sdr_batch(stacked: QCQPForm, max_iters: int = 5000,
                    tol: float = 1e-6, psd_method: str = "auto",
                    warm: SDPState = None, return_state: bool = False,
                    gate: float = _INACC_TOL, fallback: bool = True,
                    return_accept: bool = False):
    """Scenario-batched SDR: vmapped splitting solver over stacked instances.

    This is the accelerator-resident path.  psd_method "auto" picks the
    Newton-Schulz sign projection for float32 data — stateless batched
    matmuls (see _cone_proj_ns) — and the exact eigh for float64 data.

    warm: batched SDPState from a previous call (serving loops over
    slowly-drifting instance banks re-solve warm).  return_state=True appends
    the batched final states to the return tuple.

    Acceptance gate (the batch path used to return
    whatever residuals came out): every instance whose residuals miss
    `gate` (default the shared inaccurate-status tolerance) is re-solved
    individually in float64 on the default device when `fallback` is True
    — the same quality contract the single-instance path has.  Instances
    that STILL miss the gate after the fallback (e.g. infeasible ones —
    certificates are off under vmap) stay flagged.  return_accept=True
    appends the per-instance accept mask (host numpy bool array) so
    serving callers can gate without re-deriving it; gate=None restores
    the ungated legacy behavior.

    Returns (X (S, n+1, n+1), bounds (S,), primal_res (S,), dual_res (S,)
    [, states][, accept]).
    """
    if psd_method == "auto":
        psd_method = "ns" if stacked.dtype == jnp.float32 else "eigh"
    if stacked.dtype == jnp.float32:
        tol = max(tol, _F32_TOL_FLOOR)

    # acceleration off on the device projections: it stalls on the inexact
    # warm-Jacobi map, and on the exact-enough NS map it stays off as in
    # _solve_single; the exact-eigh batch keeps it.  alpha > 1 diverges
    # with NS.
    accel = 0 if psd_method in ("warm", "ns") else 20
    alpha = 1.0 if psd_method == "ns" else (
        1.6 if psd_method == "warm" else None)

    def one(P, q, r, is_eq, init):
        form = QCQPForm(P, q, r, is_eq)
        # certificates off: under vmap the periodic lax.cond lowers to a
        # select that executes the power-iteration checks EVERY iteration
        # for the whole batch; serving callers gate feasibility upstream
        sol = solve_sdp(_sdr_data(form), max_iters=max_iters, tol=tol,
                        psd_method=psd_method, init=init,
                        detect_certificates=False, accel_mem=accel,
                        alpha=alpha)
        return sol.X, sol.objective, sol.primal_res, sol.dual_res, sol.state

    fn = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0,
                                        None if warm is None else 0)))
    X, obj, rp, rd, states = fn(stacked.P, stacked.q, stacked.r,
                                stacked.is_eq, warm)

    accept = None
    if gate is not None:
        import numpy as np
        rp_h, rd_h = np.asarray(rp), np.asarray(rd)
        accept = np.maximum(rp_h, rd_h) <= gate
        if fallback and not accept.all():
            for i in np.nonzero(~accept)[0]:
                fi = QCQPForm(
                    jnp.asarray(stacked.P[i], jnp.float64),
                    jnp.asarray(stacked.q[i], jnp.float64),
                    jnp.asarray(stacked.r[i], jnp.float64),
                    stacked.is_eq[i])
                si, _ = _solve_single(_sdr_data, fi, 20000,
                                      min(tol, 1e-8), "auto")
                rp_i = float(si.primal_res)
                rd_i = float(si.dual_res)
                X = X.at[i].set(jnp.asarray(si.X, X.dtype))
                obj = obj.at[i].set(jnp.asarray(si.objective, obj.dtype))
                rp = rp.at[i].set(jnp.asarray(rp_i, rp.dtype))
                rd = rd.at[i].set(jnp.asarray(rd_i, rd.dtype))
                accept[i] = max(rp_i, rd_i) <= gate

    out = (X, obj, rp, rd)
    if return_state:
        out = out + (states,)
    if return_accept:
        out = out + (accept,)
    return out


@jax.jit
def _spectral_data(form: QCQPForm) -> SDPData:
    M = homogeneous_forms(form)
    W0 = M[0]
    N = W0.shape[0]
    ineq_mask = (~form.is_eq).astype(form.dtype)
    eq_mask = form.is_eq.astype(form.dtype)
    W1 = jnp.einsum("i,ijk->jk", ineq_mask, M[1:])
    W2 = jnp.einsum("i,ijk->jk", eq_mask, M[1:])
    E = jnp.zeros((N, N), form.dtype).at[N - 1, N - 1].set(1.0)
    Ws = jnp.stack([W1, W2, E])
    b = jnp.asarray([0.0, 0.0, 1.0], form.dtype)
    is_ineq = jnp.asarray([True, False, False])
    return build_sdp(W0, Ws, b, is_ineq)


def solve_spectral(form: QCQPForm, max_iters: int = 20000, tol: float = 1e-8,
                   check: bool = True, device="auto",
                   **_ignored) -> Tuple[jax.Array, jax.Array]:
    """Spectral (aggregated) relaxation (reference: qcqp/qcqp.py:41-70):
    all '<=' rows summed into one constraint, all '==' rows into another,
    then the lifted SDP is solved and x recovered from the top eigenpair.
    """
    sol, eff_tol = _solve_single(_spectral_data, form, max_iters, tol, device,
                                 uviol_fn=_spectral_rel_viol)
    if check:
        check_status(sol, eff_tol)
    lam, V = jnp.linalg.eigh(sol.X)   # X symmetric: eigh == reference's eig
    x = jnp.sqrt(jnp.maximum(lam[-1], 0.0)) * V[:-1, -1]
    return x, sol.objective
