"""the port's banded eigen iterations (ops/eigen.py) against the JAX
package's on the same operators, float64, on the CPU

QR's column signs may differ between LAPACK and XLA, so the Ritz values
and the normalised null vector are compared, not the raw bases.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from newton_krylov_ooc_tpu.ops import eigen as jax_eigen
from newton_krylov_ooc_tpu.ops.banded import dense_to_bands
from newton_krylov_ooc_tpu_torch.ops import eigen

REL = 1e-8  # eigenvalues, relative, and the null vector after normalising


def _path_laplacian(n):
    """tridiagonal graph Laplacian of a path: singular, real spectrum
    lambda_k = -4 sin^2(k pi / 2n), null vector = constant"""
    lap = np.zeros((n, n))
    for i in range(n):
        for j in (i - 1, i + 1):
            if 0 <= j < n:
                lap[i, j] = 1.0
                lap[i, i] -= 1.0
    return lap


@pytest.mark.parametrize("bw", [0, 3])
def test_band_matvec_matches_jax_and_dense(bw):
    rng = np.random.default_rng(5 + bw)
    n = 20
    dense = np.zeros((n, n))
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.standard_normal(len(idx))
    x = rng.standard_normal((3, n))
    bands = dense_to_bands(dense, bw)
    y = eigen.band_matvec(torch.as_tensor(bands), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, x @ dense.T, rtol=0, atol=1e-13)
    y_j = np.asarray(jax_eigen.band_matvec(jnp.asarray(bands), jnp.asarray(x[0])))
    np.testing.assert_allclose(y[0], y_j, rtol=0, atol=1e-14)


def test_start_basis_is_the_jax_packages():
    q0 = eigen._start_basis(24, 8, torch.float64, "cpu").numpy()
    assert np.array_equal(q0, np.asarray(jax_eigen._start_basis(24, 8, jnp.float64)))


def test_eigen_iterations_on_singular_laplacian_match_jax():
    """tests/test_eigen.py's singular path Laplacian: the extreme and the
    smallest eigenvalues against JAX's to 1e-8 relative, the null vector
    (normalised) against JAX's and the constant vector to 1e-8, the
    shifted solve against a dense solve"""
    n = 24
    lap = _path_laplacian(n)
    bands = dense_to_bands(lap, 1)
    bands_t, bands_j = torch.as_tensor(bands), jnp.asarray(bands)

    large = eigen.banded_extreme_eigs(bands_t, k=3, iters=300)
    large_j = jax_eigen.banded_extreme_eigs(bands_j, k=3, iters=300)
    np.testing.assert_allclose(large, large_j, rtol=REL, atol=0)

    sigma = 1.0e-3 * np.abs(np.diag(lap)).max()
    vals, vecs = eigen.banded_smallest_eigs(bands_t, sigma, k=3, iters=200)
    vals_j, vecs_j = jax_eigen.banded_smallest_eigs(bands_j, sigma, k=3, iters=200)
    # the null eigenvalue is zero to roundoff: compare the others relatively
    assert abs(vals[0]) < 1e-12 and abs(vals_j[0]) < 1e-12
    np.testing.assert_allclose(vals[1:], vals_j[1:], rtol=REL, atol=0)
    exact = np.sort(4.0 * np.sin(np.arange(n) * np.pi / (2 * n)) ** 2)[:3]
    np.testing.assert_allclose(np.abs(vals.real), exact, rtol=0, atol=1e-8)
    null, null_j = vecs[:, 0], vecs_j[:, 0]
    null = null / np.linalg.norm(null)
    null_j = null_j / np.linalg.norm(null_j)
    assert abs(abs(null @ null_j) - 1.0) < REL
    assert abs(abs(null @ np.full(n, n ** -0.5)) - 1.0) < REL

    rhs = np.random.default_rng(2).standard_normal(n)
    x = eigen.banded_shift_solve(bands_t, -0.37, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(lap + 0.37 * np.eye(n), rhs),
                               rtol=1e-12, atol=1e-12)
    x_j = np.asarray(jax_eigen.banded_shift_solve(bands_j, -0.37, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, x_j, rtol=1e-12, atol=1e-13)
