import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qcqp_tpu.kernels.jacobi import tournament_permutation


@pytest.mark.parametrize("n", [4, 8, 64, 128])
def test_tournament_covers_all_pairs(n):
    sigma = tournament_permutation(n)
    elems = np.arange(n)
    seen = set()
    for _ in range(n - 1):
        for i in range(n // 2):
            seen.add(tuple(sorted((elems[2 * i], elems[2 * i + 1]))))
        elems = elems[sigma]
    assert len(seen) == n * (n - 1) // 2
