"""The QCQP handler — the reference's public entry object, batched JAX inside.

Mirrors the behavioral contract of the reference class (reference:
qcqp/qcqp.py:367-432): canonicalize once, cache relaxation solutions, dispatch
suggest/improve by method constant, sync the flat iterate with the modeling
variables, return (objective, max violation) pairs with the maximize sign
convention un-negated on report.

Differences by design:
  * randomness is explicit jax.random key threading (seed constructor arg)
    instead of global numpy RNG state;
  * `improve` before any `suggest` auto-suggests RANDOM — the reference's
    guard tests Variable objects against None and can never fire
    (reference: qcqp/qcqp.py:427, latent bug per SURVEY.md section 2d);
  * batched multi-restart solve is first-class (`solve`), not a user loop.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import routing
from . import settings as s
from .core import eval_objective, max_violation
from .expressions import Problem, canonicalize
from .solvers.coord_descent import improve_coord_descent
from .solvers.admm import improve_admm, min_valid_rho

logger = logging.getLogger("qcqp_tpu")


@jax.jit
def _report_vec(form, x):
    """Point + (objective, max violation) as ONE (n+2,) device array.

    The reporting surface is the reference's (f, v) pair
    (reference: qcqp/qcqp.py:399-401); fusing the point sync and both
    scalars into a single output means one device->host read per
    suggest/improve instead of three."""
    return jnp.concatenate(
        [x, jnp.stack([eval_objective(form, x), max_violation(form, x)])])


def enable_file_log(path: str = "qcqp.log", level=logging.INFO) -> None:
    """Opt-in file logging, the reference's qcqp.log pattern
    (reference: qcqp/qcqp.py:39 does this unconditionally at import;
    here it is explicit).  Solvers are jitted, so per-iteration traces come
    from qcqp_tpu.diagnostics instead of log lines."""
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter("%(levelname)s:%(name)s:%(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)


class QCQP:
    def __init__(self, prob: Problem, seed: int = 0, dtype=None,
                 check_dcp: bool = True):
        if dtype is None:
            # float64 parity on the CPU; float32 on the GPU, where the
            # batched improve paths and the device SDR run in float32
            dtype = routing.default_dtype(jax.default_backend())
        self.prob = prob
        self.qcqp_form, self.layout, self.maximize_flag = canonicalize(prob, dtype)
        self.n = self.layout.n
        self.m = self.qcqp_form.m
        if check_dcp and prob.is_dcp():
            logger.warning(
                "Problem is already convex; specifying solve method is unnecessary."
            )
        self.spectral_sol = None
        self.spectral_bound = None
        self.sdr_sol = None
        self.sdr_bound = None
        self.mu = None
        self._sigma_chol = None
        self._key = jax.random.PRNGKey(seed)

    # -- rng ---------------------------------------------------------------
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    # -- reporting ---------------------------------------------------------
    def _report(self, x) -> tuple:
        out = np.asarray(_report_vec(
            self.qcqp_form, jnp.asarray(x, self.qcqp_form.dtype)))
        self.layout.assign(out[:-2])
        f0 = float(out[-2])
        if self.maximize_flag:
            f0 = -f0
        return f0, float(out[-1])

    # -- suggest -----------------------------------------------------------
    def suggest(self, method: str = s.RANDOM, eps: float = 1e-8, **kwargs):
        if method not in s.suggest_methods:
            raise ValueError(f"Unknown suggest method: {method}")
        if method == s.RANDOM:
            x = jax.random.normal(self._next_key(), (self.n,), self.qcqp_form.dtype)
        elif method == s.SPECTRAL:
            if self.spectral_sol is None:
                from .solvers.sdp import solve_spectral
                xs, bound = solve_spectral(self.qcqp_form, **kwargs)
                self.spectral_sol = xs
                self.spectral_bound = float(bound)
                if self.maximize_flag:
                    self.spectral_bound *= -1
            x = self.spectral_sol
        elif method == s.SDR:
            if self.sdr_sol is None:
                from .solvers.sdp import solve_sdr
                X, bound = solve_sdr(self.qcqp_form, **kwargs)
                self.sdr_sol = X
                self.sdr_bound = float(bound)
                if self.maximize_flag:
                    self.sdr_bound *= -1
                mu = X[:-1, -1]
                Sigma = X[:-1, :-1] - jnp.outer(mu, mu)
                Sigma = Sigma + eps * jnp.eye(self.n, dtype=X.dtype)
                # PSD up to roundoff (Schur complement of X[nn]=1); clamp the
                # spectrum before Cholesky for a robust sampler.
                lam, Q = jnp.linalg.eigh(Sigma)
                self.mu = mu
                self._sigma_chol = Q * jnp.sqrt(jnp.maximum(lam, 0.0))
            xi = jax.random.normal(self._next_key(), (self.n,), self.mu.dtype)
            x = self.mu + self._sigma_chol @ xi
        return self._report(x)

    # -- improve -----------------------------------------------------------
    def _improve_one(self, method: str, x0: jnp.ndarray, **kwargs):
        form = self.qcqp_form
        if method == s.COORD_DESCENT:
            return improve_coord_descent(
                form, x0,
                num_iters=kwargs.get("num_iters", 1000),
                viol_tol=kwargs.get("viol_tol", 1e-2),
                tol=kwargs.get("tol", 1e-4),
                phase1=kwargs.get("phase1", True),
            )
        if method == s.ADMM:
            rho = kwargs.get("rho", None)
            if rho is not None:
                min_rho = float(min_valid_rho(form))
                if rho < min_rho:
                    raise ValueError(
                        f"rho parameter is too small, need at least {min_rho:.3f}."
                    )
            if rho is not None:
                rho = jnp.asarray(rho, form.dtype)
            path = routing.form_paths(form)[s.ADMM]
            return improve_admm(
                form, x0, rho,
                num_iters=kwargs.get("num_iters", 1000),
                viol_lim=kwargs.get("viol_lim", 1e4),
                tol=kwargs.get("tol", 1e-2),
                phase1=kwargs.get("phase1", True),
                proj_trips=routing.admm_proj_trips(path),
            )
        if method == s.DCCP:
            from .solvers.ccp import improve_ccp
            return improve_ccp(
                form, x0,
                tau=kwargs.get("tau", 0.005),
                use_eigen_split=kwargs.get("use_eigen_split", False),
                **{k: v for k, v in kwargs.items()
                   if k in ("max_iter", "mu", "tau_max", "inner_iters")},
            )
        if method == s.IPOPT:
            from .solvers.nlp import improve_nlp
            return improve_nlp(form, x0, **{
                k: v for k, v in kwargs.items()
                if k in ("num_outer", "num_inner", "mu0")
            })
        raise ValueError(f"Unknown improve method: {method}")

    def improve(self, method, **kwargs):
        methods = method if isinstance(method, list) else [method]
        for mth in methods:
            if mth not in s.improve_methods:
                raise ValueError(f"Unknown improve method(s): {methods}")
        # Auto-suggest if no variable has a value yet (intended reference
        # behavior, qcqp.py:427-428; see module docstring).
        if any(v.value is None for v in self.prob.variables()):
            self.suggest()
        result = None
        for mth in methods:
            x0 = jnp.asarray(self.layout.flatten(), self.qcqp_form.dtype)
            x = self._improve_one(mth, x0, **kwargs)
            result = self._report(x)
            logger.info("improve(%s): objective %.6f, violation %.6f",
                        mth, result[0], result[1])
        return result

    # -- checkpoint / resume -------------------------------------------------
    def save_state(self, path: str) -> None:
        """Persist the handler's caches (relaxation solutions, sampler,
        variable values, RNG key) so long multi-restart runs resume without
        re-solving the SDP.  The reference keeps these only in memory
        (reference: qcqp/qcqp.py:372-375; SURVEY.md section 5)."""
        payload = {"key": np.asarray(self._key)}
        if self.sdr_sol is not None:
            payload.update(
                sdr_sol=np.asarray(self.sdr_sol),
                sdr_bound=np.asarray(self.sdr_bound),
                mu=np.asarray(self.mu),
                sigma_chol=np.asarray(self._sigma_chol))
        if self.spectral_sol is not None:
            payload.update(
                spectral_sol=np.asarray(self.spectral_sol),
                spectral_bound=np.asarray(self.spectral_bound))
        try:
            x = self.layout.flatten()
            payload["x"] = x
        except ValueError:
            pass
        np.savez(path, **payload)

    def load_state(self, path: str) -> None:
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            self._key = jnp.asarray(z["key"])
            if "sdr_sol" in z:
                self.sdr_sol = jnp.asarray(z["sdr_sol"])
                self.sdr_bound = float(z["sdr_bound"])
                self.mu = jnp.asarray(z["mu"])
                self._sigma_chol = jnp.asarray(z["sigma_chol"])
            if "spectral_sol" in z:
                self.spectral_sol = jnp.asarray(z["spectral_sol"])
                self.spectral_bound = float(z["spectral_bound"])
            if "x" in z:
                self.layout.assign(z["x"])

    # -- batched multi-restart driver (new capability) ----------------------
    def solve(self, num_restarts: int = 32, suggest: str = s.RANDOM,
              improve=s.COORD_DESCENT, key: Optional[jax.Array] = None, **kwargs):
        """Run `num_restarts` suggest+improve chains in parallel and keep the
        best point under the (violation bucket, objective) order.

        This is the vmapped/shardable path the reference lacks (it runs chains
        one at a time, e.g. examples/boolean_least_squares.py:19-38).
        """
        from .parallel.restarts import solve_restarts
        if key is None:
            key = self._next_key()
        x, f, v = solve_restarts(
            self.qcqp_form, num_restarts, key,
            suggest=suggest, improve=improve, handler=self, **kwargs)
        # one fused host read (see _report_vec)
        out = np.asarray(jnp.concatenate([x, jnp.stack([f, v])]))
        self.layout.assign(out[:-2])
        f0 = float(out[-2])
        if self.maximize_flag:
            f0 = -f0
        return f0, float(out[-1])
