"""qcqp_tpu — Suggest-and-Improve framework for nonconvex QCQPs in JAX.

A from-scratch JAX/XLA re-design of the capabilities of cvxgrp/qcqp
(Park & Boyd, "General Heuristics for Nonconvex Quadratically Constrained
Quadratic Programming"): quadratic problems are canonicalized to stacked
(P, q, r) tensors resident in device memory, Suggest methods (random / spectral / SDR
with a first-order in-JAX SDP solver) and Improve methods (two-phase
coordinate descent, consensus ADMM, penalty convex-concave, augmented-
Lagrangian polish) run as jitted fixed-point loops, and thousands of restarts
vmap per device and shard across a device mesh.

Public API mirrors the reference surface (reference: qcqp/__init__.py:27-29):
`QCQP` handler + method constants, plus the modeling layer that replaces CVXPY.
"""

import os

import jax

# Parity with the reference's float64 numpy semantics: scalar kernels and
# tolerances (1e-6 bisection) assume double precision.  Throughput paths pass
# explicit float32/bfloat16 tensors regardless of this flag.
if os.environ.get("QCQP_TPU_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR if set (JAX reads it itself), else a fixed
    .jax_cache/ at the repository root."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from .settings import (  # noqa: E402
    RANDOM, SDR, SPECTRAL, COORD_DESCENT, ADMM, DCCP, IPOPT,
    suggest_methods, improve_methods,
)
from .core import QCQPForm, make_form  # noqa: E402
from .expressions import (  # noqa: E402
    Variable, Problem, Minimize, Maximize, Constraint,
    square, sum_squares, quad_form, power, quad_over_lin, matrix_frac,
    sum_entries, mul_elemwise, reshape, canonicalize,
)
from .api import QCQP, enable_file_log  # noqa: E402
from .solvers.sdp import (  # noqa: E402
    InfeasibleRelaxationError, UnboundedRelaxationError,
)
from .complexvar import (  # noqa: E402
    ComplexVariable, abs2, sum_abs2, cquad_form, real, imag, conj,
)

__version__ = "0.1.0"

__all__ = [
    "QCQP", "QCQPForm", "make_form", "enable_file_log",
    "InfeasibleRelaxationError", "UnboundedRelaxationError",
    "RANDOM", "SDR", "SPECTRAL", "COORD_DESCENT", "ADMM", "DCCP", "IPOPT",
    "suggest_methods", "improve_methods",
    "Variable", "Problem", "Minimize", "Maximize", "Constraint",
    "square", "sum_squares", "quad_form", "power", "quad_over_lin",
    "matrix_frac", "sum_entries", "mul_elemwise", "reshape", "canonicalize",
    "ComplexVariable", "abs2", "sum_abs2", "cquad_form", "real", "imag",
    "conj",
]
