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


def _pair_inputs(rng, real, n_blocks=2, m=30, bw=4):
    """a real banded system and a complex one of its precision, each
    diagonally dominant, and right-hand sides for both"""
    cplx = {torch.float32: torch.complex64, torch.float64: torch.complex128}[real]
    bands_r = np.stack([banded.dense_to_bands(_dominant(rng, m, bw), bw)
                        for _ in range(n_blocks)])
    bands_c = np.stack([banded.dense_to_bands(
        _random_bands(rng, m, bw, True, 3.0), bw) for _ in range(n_blocks)])
    rhs_r = rng.normal(size=(3, n_blocks, m))
    rhs_c = rng.normal(size=(3, n_blocks, m)) + 1j * rng.normal(size=(3, n_blocks, m))
    return (torch.as_tensor(bands_r, dtype=real), torch.as_tensor(bands_c, dtype=cplx),
            torch.as_tensor(rhs_r, dtype=real), torch.as_tensor(rhs_c, dtype=cplx))


@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_pair_forms_equal_the_single_calls(real):
    """the pair forms on the CPU: the two single calls, bit for bit, with
    and without out, due and active"""
    bands_r, bands_c, rhs_r, rhs_c = _pair_inputs(np.random.default_rng(12), real)
    lu_r, lu_c = banded.banded_lu_factor_pair(bands_r, bands_c)
    assert torch.equal(lu_r, banded.banded_lu_factor_blocks(bands_r))
    assert torch.equal(lu_c, banded.banded_lu_factor_blocks(bands_c))
    x_r, x_c = banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c)
    assert torch.equal(x_r, banded.banded_lu_solve_blocks(lu_r, rhs_r))
    assert torch.equal(x_c, banded.banded_lu_solve_blocks(lu_c, rhs_c))

    out_r, out_c = torch.full_like(bands_r, 7.0), torch.full_like(bands_c, 7.0)
    got = banded.banded_lu_factor_pair(bands_r, bands_c, out_r=out_r,
                                       out_c=out_c, due=torch.tensor(False))
    assert got[0] is out_r and got[1] is out_c
    assert bool((out_r == 7.0).all()) and bool((out_c == 7.0).all())
    banded.banded_lu_factor_pair(bands_r, bands_c, out_r=out_r, out_c=out_c,
                                 due=torch.tensor(True))
    assert torch.equal(out_r, lu_r) and torch.equal(out_c, lu_c)
    x_r, x_c = banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c,
                                           active=torch.tensor(False))
    assert torch.equal(x_r, rhs_r) and torch.equal(x_c, rhs_c)
    x_r, x_c = banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c,
                                           active=torch.tensor(True))
    assert torch.equal(x_r, banded.banded_lu_solve_blocks(lu_r, rhs_r))
    assert torch.equal(x_c, banded.banded_lu_solve_blocks(lu_c, rhs_c))


def test_pair_forms_refuse_what_is_no_pair():
    """mismatched rows, blocks or bands, dtypes that are no real and
    complex twin, an out that is an input or the other out"""
    bands_r, bands_c, rhs_r, rhs_c = _pair_inputs(np.random.default_rng(13),
                                                  torch.float64)
    factor, solve = banded.banded_lu_factor_pair, banded.banded_lu_solve_pair
    with pytest.raises(ValueError, match="shape"):
        factor(bands_r, bands_c[:, :20])
    with pytest.raises(ValueError, match="shape"):
        factor(bands_r, bands_c[:1])
    with pytest.raises(ValueError, match="shape"):
        factor(bands_r, torch.zeros((2, 30, 11), dtype=torch.complex128))
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        factor(bands_r, bands_c.to(torch.complex64))
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        factor(bands_c, bands_r)
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        factor(bands_r.to(torch.float32), bands_c)
    with pytest.raises(ValueError, match="3-d"):
        factor(bands_r[0], bands_c[0])
    with pytest.raises(ValueError, match="distinct"):
        factor(bands_r, bands_c, out_r=bands_r)
    out = torch.empty_like(bands_r)
    with pytest.raises(ValueError, match="distinct"):
        factor(bands_r, bands_c, out_r=out, out_c=out)
    with pytest.raises(ValueError, match="distinct"):
        factor(bands_r, bands_c, out_c=bands_c)
    lu_r, lu_c = factor(bands_r, bands_c)
    with pytest.raises(ValueError, match="shape"):
        solve(lu_r, rhs_r, lu_c[:1], rhs_c)
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        solve(lu_r, rhs_r, lu_c.to(torch.complex64), rhs_c)
