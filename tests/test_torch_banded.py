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


# -- bands_add_diag and the complex systems --------------------------------------


def _random_bands(rng, m, bw, cplx, diag):
    """tests/test_banded.py's band matrices: entries 0.1 N(0, 1) (complex
    parts each), diag added to the main diagonal; dense"""
    mat = np.zeros((m, m), complex if cplx else float)
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(m, m - off))
        vals = rng.normal(size=len(idx))
        if cplx:
            vals = vals + 1j * rng.normal(size=len(idx))
        mat[idx, idx + off] = vals * 0.1
    mat[np.arange(m), np.arange(m)] += diag
    return mat


@pytest.mark.parametrize("cplx", [False, True])
def test_bands_add_diag_matches_jax(cplx):
    rng = np.random.default_rng(3)
    mat = _random_bands(rng, 12, 2, cplx, 1.0)
    bands = banded.dense_to_bands(mat, 2)
    val = 0.75 - 0.5j if cplx else 0.75
    out = banded.bands_add_diag(torch.as_tensor(bands), val)
    assert np.array_equal(out.numpy(),
                          np.asarray(jax_banded.bands_add_diag(jnp.asarray(bands), val)))
    # a 0-d tensor shift, and the input left as it was
    shift = torch.tensor(val)
    blocks = torch.as_tensor(np.stack([bands, 2 * bands]))
    out = banded.bands_add_diag(blocks, shift)
    assert np.array_equal(blocks.numpy()[0], bands)
    assert np.array_equal(out.numpy()[1], np.asarray(
        jax_banded.bands_add_diag(jnp.asarray(2 * bands), val)))


@pytest.mark.parametrize("m, bw, cplx", [(12, 1, False), (30, 4, False),
                                         (90, 30, False), (40, 5, True),
                                         (90, 30, True)])
def test_factor_and_solve_at_jax_test_shapes(m, bw, cplx):
    """tests/test_banded.py's real and complex systems: factors and
    solution against JAX's and against numpy.linalg.solve"""
    rng = np.random.default_rng(m + bw)
    mat = _random_bands(rng, m, bw, cplx, 4.0 + 2.0j if cplx else 5.0)
    rhs = rng.normal(size=m) + (1j * rng.normal(size=m) if cplx else 0.0)
    bands = banded.dense_to_bands(mat, bw)
    lu = banded.banded_lu_factor(torch.as_tensor(bands))
    lu_j = jax_banded.banded_lu_factor(jnp.asarray(bands))
    assert lu.dtype == (torch.complex128 if cplx else torch.float64)
    assert _rel(lu, lu_j) < TOL
    x = banded.banded_lu_solve(lu, torch.as_tensor(rhs))
    assert _rel(x, jax_banded.banded_lu_solve(lu_j, jnp.asarray(rhs))) < TOL
    assert _rel(x, np.linalg.solve(mat, rhs)) < TOL
    assert np.abs(mat @ x.numpy() - rhs).max() < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_single_precision_blocks(dtype):
    """float32 and complex64 blocks against numpy's double-precision solve"""
    rng = np.random.default_rng(9)
    cplx = dtype.is_complex
    mats = [_random_bands(rng, 25, 3, cplx, 3.0) for _ in range(3)]
    bands = np.stack([banded.dense_to_bands(mat, 3) for mat in mats])
    rhs = rng.normal(size=(3, 25))
    lu = banded.banded_lu_factor_blocks(torch.as_tensor(bands, dtype=dtype))
    x = banded.banded_lu_solve_blocks(lu, torch.as_tensor(rhs))
    assert x.dtype == dtype
    for k in range(3):
        assert _rel(x[k], np.linalg.solve(mats[k], rhs[k])) < 1e-5


def test_factor_where_due_on_the_cpu():
    """out and due: nothing factored where due is False; active: rhs
    returned unsolved where it is False"""
    rng = np.random.default_rng(4)
    bands = torch.as_tensor(np.stack([banded.dense_to_bands(
        _dominant(rng, 10, 2), 2) for _ in range(2)]))
    out = torch.full_like(bands, 7.0)
    banded.banded_lu_factor_blocks(bands, out=out, due=torch.tensor(False))
    assert bool((out == 7.0).all())
    banded.banded_lu_factor_blocks(bands, out=out, due=torch.tensor(True))
    assert torch.equal(out, banded.banded_lu_factor_blocks(bands))
    with pytest.raises(ValueError, match="due needs out"):
        banded.banded_lu_factor_blocks(bands, due=torch.tensor(True))
    rhs = torch.ones((2, 10), dtype=torch.float64)
    assert torch.equal(banded.banded_lu_solve_blocks(out, rhs,
                                                     active=torch.tensor(False)), rhs)
    assert torch.equal(banded.banded_lu_solve_blocks(out, rhs, active=torch.tensor(True)),
                       banded.banded_lu_solve_blocks(out, rhs))


def test_other_devices_go_to_the_kernel_or_raise():
    """the plain loop is for CPU tensors only: any other device goes to the
    CUDA kernel's wrapper, which refuses what is not a CUDA tensor"""
    bands = torch.zeros((2, 6, 5), device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        banded.banded_lu_factor_blocks(bands)
    with pytest.raises(ValueError, match="CUDA kernel"):
        banded.banded_lu_solve_blocks(bands, torch.zeros((2, 6), device="meta"))
