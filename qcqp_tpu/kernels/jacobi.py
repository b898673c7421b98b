"""Round-robin Jacobi sweeps for warm-started symmetric eigendecomposition.

The classic parallel one-round-robin Jacobi scheme, as plain JAX matmuls:

  * each round zeroes n/2 disjoint pivots (pairs (2i, 2i+1)); the n/2 Givens
    rotations form one block-diagonal orthogonal matrix J built with masked
    elementwise algebra, so the update A <- J^T A J and the eigenvector
    accumulation V <- V J are plain matmuls;
  * a fixed tournament permutation Pi (circle method, conjugated so the
    paired elements are always adjacent) re-seats the matrix between rounds;
    n-1 rounds visit every pivot pair exactly once (verified in tests).

Its consumer is the warm-started PSD cone projection of the SDP solver
(solvers/sdp.py, psd_method="warm").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def tournament_permutation(n: int) -> np.ndarray:
    """Index permutation sigma with: pairing (2i,2i+1) applied to
    sigma^k-reseated elements enumerates all unordered pairs over k=0..n-2.

    Circle method: seats s = [0, 1, ..., n-1], pairs are (s[i], s[n-1-i]);
    one round rotates all seats but seat 0.  Conjugating by the interleave
    arrangement (s[0], s[n-1], s[1], s[n-2], ...) makes every pair adjacent.
    Returns sigma as an index array: round k+1 element at slot j is the
    round-k element at slot sigma[j].
    """
    assert n % 2 == 0
    # arrangement: slot -> seat
    arr = np.empty(n, dtype=np.int64)
    arr[0::2] = np.arange(n // 2)
    arr[1::2] = n - 1 - np.arange(n // 2)
    inv_arr = np.argsort(arr)
    # seat rotation: seat 0 fixed; seats 1..n-1 rotate by one
    rot = np.empty(n, dtype=np.int64)
    rot[0] = 0
    rot[1:] = np.concatenate([[n - 1], np.arange(1, n - 1)])
    # slot-level permutation: slot -> slot
    return inv_arr[rot[arr]]


@functools.lru_cache(maxsize=8)
def _constants(n: int):
    """Constant masks as numpy arrays: identity, pair-offdiag selectors,
    pair-spread matrices, and the permutation matrix."""
    eye = np.eye(n, dtype=np.float32)
    E1 = np.zeros((n, n), np.float32)   # (2i, 2i+1)
    E2 = np.zeros((n, n), np.float32)   # (2i+1, 2i)
    Sp_a = np.zeros((n, n), np.float32)  # spread diag[2i] to rows 2i, 2i+1
    Sp_b = np.zeros((n, n), np.float32)  # spread diag[2i+1] to both rows
    Sp_c = np.zeros((n, n), np.float32)  # spread offdiag[2i] to both rows
    for i in range(n // 2):
        a, b = 2 * i, 2 * i + 1
        E1[a, b] = 1.0
        E2[b, a] = 1.0
        Sp_a[a, a] = Sp_a[b, a] = 1.0
        Sp_b[a, b] = Sp_b[b, b] = 1.0
        Sp_c[a, a] = Sp_c[b, a] = 1.0
    sigma = tournament_permutation(n)
    Pi = np.zeros((n, n), np.float32)
    # X_new = Pi^T X Pi reseats element sigma[j] into slot j
    Pi[sigma, np.arange(n)] = 1.0
    return eye, E1, E2, Sp_a, Sp_b, Sp_c, Pi


def jacobi_sweeps(A, V0=None, sweeps: int = 2):
    """Round-robin Jacobi sweeps (any dtype, odd sizes padded).

    Returns (lam_unsorted, V) with A ~= V diag(lam) V^T after `sweeps` full
    sweeps.  Intended for *warm-started* eigendecomposition: pass the
    previous eigenbasis via A' = V_prev^T A V_prev, then compose — a nearly
    diagonal A' converges in 1-2 sweeps of pure matmuls, replacing a
    sequential eigh in iterative loops (the SDP cone projection).
    """
    n0 = A.shape[-1]
    n = n0 + (n0 % 2)
    if n != n0:
        A = jnp.pad(A, ((0, 1), (0, 1)))
    consts = [jnp.asarray(c, A.dtype) for c in _constants(n)]
    eye, E1, E2, Sp_a, Sp_b, Sp_c, Pi = consts
    V = eye if V0 is None else (
        jnp.pad(V0, ((0, 1), (0, 1))).at[n0, n0].set(1.0) if n != n0 else V0)

    def round_body(_, carry):
        A, V = carry
        d = jnp.sum(A * eye, axis=1)
        o = jnp.sum(A * E1, axis=1)
        a = Sp_a @ d
        b = Sp_b @ d
        c = Sp_c @ o
        tau = (b - a) / jnp.where(c == 0.0, 1.0, 2.0 * c)
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        t = jnp.where(c == 0.0, 0.0, t)
        cs = jax.lax.rsqrt(1.0 + t * t)
        sn = t * cs
        J = eye * cs[:, None] + E1 * sn[:, None] - E2 * sn[:, None]
        hp = jax.lax.Precision.HIGHEST
        JP = jnp.dot(J, Pi, preferred_element_type=A.dtype, precision=hp)
        A = jnp.dot(JP.T, jnp.dot(A, JP, preferred_element_type=A.dtype,
                                  precision=hp),
                    preferred_element_type=A.dtype, precision=hp)
        V = jnp.dot(V, JP, preferred_element_type=A.dtype, precision=hp)
        return A, V

    A, V = jax.lax.fori_loop(jnp.int32(0), jnp.int32(sweeps * (n - 1)),
                             round_body, (A, V))
    lam = jnp.sum(A * eye, axis=1)
    if n != n0:
        lam = lam[:n0]
        V = V[:n0, :n0]
    return lam, V
