"""the port's pivot-free banded LU against the JAX package's, float64, on
random diagonally dominant 7-band batches"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.ops import banded as jax_banded  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import banded  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12  # relative: the same eliminations in float64


def _dominant(rng, m, bw):
    """a dense (m, m) band matrix of half-width bw, diagonally dominant"""
    mat = np.zeros((m, m))
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(m, m - off))
        mat[idx, idx + off] = rng.uniform(-1.0, 1.0, len(idx))
    mat[np.arange(m), np.arange(m)] = np.abs(mat).sum(axis=1) + rng.uniform(
        0.5, 2.0, m)
    return mat


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("m, bw", [(1, 0), (2, 1), (7, 3), (24, 3)])
def test_dense_to_bands_matches_jax(m, bw):
    mat = _dominant(np.random.default_rng(m), m, bw)
    assert np.array_equal(banded.dense_to_bands(mat, bw),
                          jax_banded.dense_to_bands(mat, bw))


@pytest.mark.parametrize("m", [4, 10, 24])
def test_factor_and_solve_match_jax_and_numpy(m):
    rng = np.random.default_rng(11 + m)
    mat = _dominant(rng, m, 3)
    bands = banded.dense_to_bands(mat, 3)
    rhs = rng.normal(size=m)

    lu = banded.banded_lu_factor(torch.as_tensor(bands))
    lu_j = jax_banded.banded_lu_factor(jnp.asarray(bands))
    assert _rel(lu, lu_j) < TOL
    x = banded.banded_lu_solve(lu, torch.as_tensor(rhs))
    assert _rel(x, jax_banded.banded_lu_solve(lu_j, jnp.asarray(rhs))) < TOL
    assert _rel(x, np.linalg.solve(mat, rhs)) < TOL


def test_blocks_match_jax_and_share_factors():
    """the batched forms against JAX's vmapped ones; a leading axis of
    right-hand sides shares the factors, as the preconditioner uses it"""
    rng = np.random.default_rng(5)
    n_blk, m = 6, 12
    mats = [_dominant(rng, m, 3) for _ in range(n_blk)]
    bands = np.stack([banded.dense_to_bands(mat, 3) for mat in mats])
    rhs = rng.normal(size=(3, n_blk, m))

    lu = banded.banded_lu_factor_blocks(torch.as_tensor(bands))
    lu_j = jax_banded.banded_lu_factor_blocks(jnp.asarray(bands))
    assert _rel(lu, lu_j) < TOL
    x = banded.banded_lu_solve_blocks(lu, torch.as_tensor(rhs))
    x_j = jax.vmap(lambda r: jax_banded.banded_lu_solve_blocks(lu_j, r))(
        jnp.asarray(rhs))
    assert x.shape == (3, n_blk, m)
    assert _rel(x, x_j) < TOL
    for blk, mat in enumerate(mats):
        assert _rel(x[:, blk], np.linalg.solve(mat, rhs[:, blk].T).T) < TOL


def test_forms_refuse_the_wrong_rank():
    bands = torch.zeros((2, 5, 7), dtype=torch.float64)
    with pytest.raises(ValueError, match="2-d"):
        banded.banded_lu_factor(bands)
    with pytest.raises(ValueError, match="3-d"):
        banded.banded_lu_factor_blocks(bands[0])
