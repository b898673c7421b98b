"""Canonical batched QCQP representation and its pure-jnp evaluators.

The reference keeps the canonical problem as a Python list of per-constraint
``QuadraticFunction`` objects holding scipy sparse matrices
(reference: qcqp/utilities.py:41-146).  Here the whole problem is a single
pytree of stacked dense device tensors so that every evaluation is one batched
matmul and the constraint axis can be vmapped/sharded:

    P : (m+1, n, n)  symmetric; row 0 is the objective, rows 1..m constraints
    q : (m+1, n)
    r : (m+1,)
    is_eq : (m,) bool   relop per constraint (True for '==', False for '<=')

All functions are pure and jit/vmap-safe.  Dtype follows the stored tensors;
canonicalization produces float64 by default for parity with the reference's
numpy semantics, while throughput paths may build float32 forms.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class QCQPForm(NamedTuple):
    """Batched canonical form of `minimize f0(x) s.t. f_i(x) <= / == 0`.

    Mirrors the information content of the reference ``QCQPForm``
    (reference: qcqp/utilities.py:122-146) but as stacked tensors.
    """

    P: jax.Array      # (m+1, n, n)
    q: jax.Array      # (m+1, n)
    r: jax.Array      # (m+1,)
    is_eq: jax.Array  # (m,) bool

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.P.shape[0] - 1

    @property
    def dtype(self):
        return self.P.dtype

    def astype(self, dtype) -> "QCQPForm":
        return QCQPForm(
            self.P.astype(dtype), self.q.astype(dtype), self.r.astype(dtype), self.is_eq
        )


def make_form(P, q, r, is_eq) -> QCQPForm:
    """Build a QCQPForm from array-likes, symmetrizing P rows.

    Symmetrization (P + P^T)/2 matches the canonicalizer contract
    (reference: qcqp/utilities.py:333,345).
    """
    P = jnp.asarray(P)
    P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
    q = jnp.asarray(q)
    r = jnp.asarray(r)
    is_eq = jnp.asarray(is_eq, dtype=bool)
    if P.ndim != 3 or q.ndim != 2 or r.ndim != 1:
        raise ValueError("expected P (m+1,n,n), q (m+1,n), r (m+1,)")
    if P.shape[0] != q.shape[0] or P.shape[0] != r.shape[0]:
        raise ValueError("inconsistent leading (m+1) dims")
    if is_eq.shape[0] != P.shape[0] - 1:
        raise ValueError("is_eq must have m entries")
    return QCQPForm(P, q, r, is_eq)


# ---------------------------------------------------------------------------
# Evaluators.  All batched over the function axis; x is a single point (n,).
# vmap over restarts composes on top.
# ---------------------------------------------------------------------------

def eval_all(form: QCQPForm, x: jax.Array) -> jax.Array:
    """f_i(x) = x^T P_i x + q_i^T x + r_i for all rows i (objective + constraints).

    One (m+1,n,n)x(n,) batched contraction (reference computes these one
    at a time: qcqp/utilities.py:49-50).
    """
    k, n = form.P.shape[0], form.P.shape[-1]
    # Flat matmul, not einsum("knm,m->kn"): under vmap over a large restart
    # axis XLA can lower that einsum through a materialized (R, m+1, n, n)
    # broadcast (23 GB at the headline-bench shape) instead of a dot_general.
    Px = (form.P.reshape(k * n, n) @ x).reshape(k, n)
    return (Px + form.q) @ x + form.r


def eval_objective(form: QCQPForm, x: jax.Array) -> jax.Array:
    P0, q0, r0 = form.P[0], form.q[0], form.r[0]
    return x @ (P0 @ x + q0) + r0


def violations(form: QCQPForm, x: jax.Array) -> jax.Array:
    """Per-constraint violations: |f_i| for '==', max(0, f_i) for '<='.

    (reference: qcqp/utilities.py:56-62,133-134)
    """
    vals = eval_all(form, x)[1:]
    return jnp.where(form.is_eq, jnp.abs(vals), jnp.maximum(vals, 0.0))


def max_violation(form: QCQPForm, x: jax.Array) -> jax.Array:
    v = violations(form, x)
    # A problem with m == 0 has violation 0 (reference would crash on max([])).
    return jnp.max(v, initial=jnp.zeros((), v.dtype))


def better_key(form: QCQPForm, x: jax.Array, tol: float = 1e-4):
    """Lexicographic comparison key (violation bucket, objective).

    The reference bucketizes max violation to ``int(maxviol/tol)`` and breaks
    ties on the objective (reference: qcqp/utilities.py:135-146).  Returning
    the key pair (rather than comparing in Python) makes the ordering usable
    inside jitted reductions and cross-device collectives.
    """
    v = jnp.floor(max_violation(form, x) / tol)
    f = eval_objective(form, x)
    return v, f


def better(form: QCQPForm, x1: jax.Array, x2: jax.Array, tol: float = 1e-4) -> jax.Array:
    """Return the better of two points under the (viol bucket, objective) order.

    Exactly mirrors the tie-breaking of the reference: equal buckets and equal
    objectives prefer x2 (reference: qcqp/utilities.py:143-146).
    """
    v1, f1 = better_key(form, x1, tol)
    v2, f2 = better_key(form, x2, tol)
    take1 = (v1 < v2) | ((v1 == v2) & (f1 < f2))
    return jnp.where(take1, x1, x2)


def homogeneous_forms(form: QCQPForm) -> jax.Array:
    """Stacked homogeneous forms M_i = [[P_i, q_i/2], [q_i^T/2, r_i]].

    (x,1)^T M_i (x,1) == f_i(x)  (reference: qcqp/utilities.py:64-67)
    Returns (m+1, n+1, n+1).
    """
    k, n = form.q.shape
    M = jnp.zeros((k, n + 1, n + 1), form.dtype)
    M = M.at[:, :n, :n].set(form.P)
    M = M.at[:, :n, n].set(form.q / 2)
    M = M.at[:, n, :n].set(form.q / 2)
    M = M.at[:, n, n].set(form.r)
    return M


def dc_split(form: QCQPForm):
    """Difference-of-convex split of every row: P_i = P1_i - P2_i, both PSD.

    Default diagonal-shift mode of the reference (qcqp/utilities.py:82-89):
    if lambda_min(P) < 0, P1 = P + (1-lambda_min) I, P2 = (1-lambda_min) I;
    otherwise P1 = P, P2 = 0.  Affine/constant parts ride with P1.
    Returns (P1, P2) each (m+1, n, n); q, r are unchanged and belong to f1.
    """
    lmb_min = jnp.min(jnp.linalg.eigvalsh(form.P), axis=-1)  # (m+1,)
    shift = jnp.where(lmb_min < 0, 1.0 - lmb_min, 0.0)
    eye = jnp.eye(form.n, dtype=form.dtype)
    P2 = shift[:, None, None] * eye
    P1 = form.P + P2
    return P1, P2


def dc_split_eigen(form: QCQPForm):
    """Eigen-split mode (reference: qcqp/utilities.py:77-81): P1 keeps the
    positive eigenspace, P2 the negated negative eigenspace."""
    lmb, Q = jnp.linalg.eigh(form.P)
    pos = jnp.maximum(lmb, 0.0)
    neg = jnp.maximum(-lmb, 0.0)
    P1 = jnp.einsum("kij,kj,klj->kil", Q, pos, Q)
    P2 = jnp.einsum("kij,kj,klj->kil", Q, neg, Q)
    return P1, P2


# ---------------------------------------------------------------------------
# Host-side helpers (numpy): random problem generators used by tests/bench.
# ---------------------------------------------------------------------------

def random_form(rng: np.random.Generator, n: int, m: int, eq_frac: float = 0.5,
                dtype=np.float64) -> QCQPForm:
    """Dense random QCQP instance (all tensors O(1) scale)."""
    A = rng.standard_normal((m + 1, n, n))
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n))
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    return make_form(P.astype(dtype), q.astype(dtype), r.astype(dtype), is_eq)
