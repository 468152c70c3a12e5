"""the port's parallel/sharded_sparse.py held against the JAX package's on
the CPU: twins of the 13 tests of tests/test_sharded_sparse.py, the port's
solve on meshes of 1, 2 and 4 CPU shards (parallel/mesh.py, one module row)
against JAX's sharded solve on its virtual CPU devices and JAX's unsharded
solve, plus the default mesh's logged fallback.

Tolerances: the JAX tests' own against the dense solve; the port against
JAX's solves 1e-9 of max|x| (both converge to a 1e-12 residual).  Per-rhs
iterations: the float64 line solves equal the port's unsharded ones (the
shards' dot products sum in another order, which these systems do not
feel); the mixed solves' float32 inner loops within MIXED_ITER_SPREAD, a
bound set from the first readings on these fixtures (the port against JAX
up to 2, the port's sharded against its unsharded solve 3 on one fixture),
not fixed before them.
"""

import logging

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import newton_krylov_ooc_tpu.ops.sparse as jax_sparse
import newton_krylov_ooc_tpu.parallel.sharded_sparse as jax_sharded
import newton_krylov_ooc_tpu_torch.ops.sparse as port_sparse
import newton_krylov_ooc_tpu_torch.parallel.sharded_sparse as port_sharded
from newton_krylov_ooc_tpu_torch.parallel.mesh import make_mesh
from sparse_fixtures import grid_csr
from test_sharded_sparse import _random_csr

X_TOL = 1e-9
MIXED_ITER_SPREAD = 3
SHARDS = [1, 2, 4]


def _mesh(n):
    return make_mesh(1, n, devices=["cpu"] * n)


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices())[:n], ("rows",))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _solve(n_shards, *args, **kwargs):
    return port_sharded.solve_csr_systems_sharded(
        *args, mesh=_mesh(n_shards), return_iters=True, **kwargs)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's sharded solves (its default 8-device mesh), one per system"""
    return {}


def _jax_sharded(cache, key, *args, **kwargs):
    if key not in cache:
        cache[key] = jax_sharded.solve_csr_systems_sharded(*args, **kwargs)
    return cache[key]


def test_pad_ell_rows_identity_padding():
    vals = np.array([[2.0, 1.0], [0.5, 3.0], [4.0, 0.0]])
    cols = np.array([[0, 1], [0, 1], [2, 0]])
    vals_p, cols_p, n_rows = port_sharded.pad_ell_rows(vals, cols, 4)
    assert n_rows == 3
    assert vals_p.shape == (4, 2)
    assert vals_p[3, 0] == 1.0
    assert cols_p[3, 0] == 3
    assert (vals_p[3, 1:] == 0.0).all()
    np.testing.assert_array_equal(vals_p[:3], vals)
    np.testing.assert_array_equal(cols_p[:3], cols)
    for got, ref in zip((vals_p, cols_p, n_rows),
                        jax_sharded.pad_ell_rows(vals, cols, 4)):
        np.testing.assert_array_equal(got, ref)


def test_pad_ell_rows_already_divisible():
    vals = np.ones((8, 2))
    cols = np.zeros((8, 2), np.int64)
    vals_p, _cols_p, n_rows = port_sharded.pad_ell_rows(vals, cols, 4)
    assert n_rows == 8
    assert vals_p.shape == (8, 2)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_solve_matches_dense(jax_results, n_shards):
    # 37 rows: not divisible by 2 or 4, so the identity-row padding runs
    row_ptr, col_ind, data, dense, rhs = _random_csr(37, 3, seed=1)
    x, ok, _it = _solve(n_shards, row_ptr, col_ind, data, rhs)
    assert ok.all()
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs.T).T,
                               rtol=1e-9, atol=1e-9)
    x_j, ok_j = _jax_sharded(jax_results, "dense37", row_ptr, col_ind, data,
                             rhs)
    assert ok_j.all() and _rel(x, x_j) <= X_TOL


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_solve_matches_single_device(jax_results, n_shards):
    row_ptr, col_ind, data, _dense, rhs = _random_csr(64, 2, seed=2)
    x_sh, ok_sh, _it = _solve(n_shards, row_ptr, col_ind, data, rhs)
    x_1d, ok_1d = port_sparse.solve_csr_systems(row_ptr, col_ind, data, rhs,
                                                device="cpu")
    assert ok_sh.all() and ok_1d.all()
    np.testing.assert_allclose(x_sh, x_1d, rtol=1e-8, atol=1e-10)
    x_j, _ok = jax_sparse.solve_csr_systems(row_ptr, col_ind, data, rhs)
    assert _rel(x_sh, x_j) <= X_TOL


def test_sharded_solve_explicit_mesh_shapes():
    row_ptr, col_ind, data, dense, rhs = _random_csr(48, 2, seed=3)
    expected = np.linalg.solve(dense, rhs.T).T
    for n_dev in (2, 4):
        x, ok, _it = _solve(n_dev, row_ptr, col_ind, data, rhs)
        assert ok.all()
        np.testing.assert_allclose(x, expected, rtol=1e-9, atol=1e-9)
        x_j, _ok = jax_sharded.solve_csr_systems_sharded(
            row_ptr, col_ind, data, rhs, mesh=_jax_mesh(n_dev))
        assert _rel(x, x_j) <= X_TOL


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_line_precond_matches_dense(jax_results, n_shards):
    """whole vertical lines per shard, shard-local PCR; 7 active lines over
    2 and 4 shards exercise the identity-line padding.  The float64 line
    solve's iterations equal the unsharded port's, per rhs"""
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        6, 2, 4, 3, seed=7)
    grid = {"row_to_cell": row_to_cell, "nhoriz": nhoriz}
    x, ok, iters = _solve(n_shards, row_ptr, col_ind, data, rhs, **grid)
    assert ok.all()
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs.T).T,
                               rtol=1e-9, atol=1e-9)
    x_1d, ok_1d, it_1d = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, return_iters=True, device="cpu", **grid)
    assert ok_1d.all()
    np.testing.assert_allclose(x, x_1d, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(iters, it_1d)
    x_j, _ok = _jax_sharded(jax_results, "line7", row_ptr, col_ind, data,
                            rhs, **grid)
    assert _rel(x, x_j) <= X_TOL


def test_sharded_line_precond_mesh_shapes():
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        5, 3, 4, 2, seed=8)
    expected = np.linalg.solve(dense, rhs.T).T
    for n_dev in (2, 4, 8):
        x, ok, _it = _solve(n_dev, row_ptr, col_ind, data, rhs,
                            row_to_cell=row_to_cell, nhoriz=nhoriz)
        assert ok.all()
        np.testing.assert_allclose(x, expected, rtol=1e-9, atol=1e-9)
    x_j, _ok = jax_sharded.solve_csr_systems_sharded(
        row_ptr, col_ind, data, rhs, mesh=_jax_mesh(4),
        row_to_cell=row_to_cell, nhoriz=nhoriz)
    assert _rel(x, x_j) <= X_TOL


def test_mixed_precision_refinement_matches_dense():
    """float32 inner solves + float64 refinement reach the float64 path's
    answer; reaching 1e-12 costs more inner iterations than a loose
    single-round solve; JAX's counts within MIXED_ITER_SPREAD"""
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        6, 3, 4, 2, seed=11)
    grid = {"row_to_cell": row_to_cell, "nhoriz": nhoriz}
    expected = np.linalg.solve(dense, rhs.T).T
    x, ok, iters = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, mixed_precision=True, return_iters=True,
        device="cpu", **grid)
    assert ok.all()
    np.testing.assert_allclose(x, expected, rtol=1e-8, atol=1e-10)
    _x1, ok1, iters1 = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, mixed_precision=True, rtol=1e-5,
        return_iters=True, device="cpu", **grid)
    assert ok1.all()
    assert (iters > iters1).all()
    x64, ok64 = port_sparse.solve_csr_systems(row_ptr, col_ind, data, rhs,
                                              device="cpu", **grid)
    assert ok64.all()
    np.testing.assert_allclose(x, x64, rtol=1e-8, atol=1e-10)
    x_j, _ok, it_j = jax_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, mixed_precision=True, return_iters=True,
        **grid)
    assert _rel(x, x_j) <= X_TOL
    assert np.abs(iters - it_j).max() <= MIXED_ITER_SPREAD
    with pytest.raises(ValueError, match="mixed_precision"):
        port_sparse.solve_csr_systems(row_ptr, col_ind, data, rhs,
                                      mixed_precision=True, device="cpu")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_mixed_precision_matches_dense(jax_results, n_shards):
    """the sharded f32-inner/f64-refinement solve reaches the sharded f64
    path's answer, the dense one and JAX's; its inner iterations within
    MIXED_ITER_SPREAD of the unsharded mixed solve's"""
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        6, 3, 4, 2, seed=13)
    grid = {"row_to_cell": row_to_cell, "nhoriz": nhoriz}
    expected = np.linalg.solve(dense, rhs.T).T
    x, ok, iters = _solve(n_shards, row_ptr, col_ind, data, rhs,
                          mixed_precision=True, **grid)
    assert ok.all()
    np.testing.assert_allclose(x, expected, rtol=1e-8, atol=1e-10)
    x64, ok64, _it = _solve(n_shards, row_ptr, col_ind, data, rhs, **grid)
    assert ok64.all()
    np.testing.assert_allclose(x, x64, rtol=1e-8, atol=1e-10)
    _x, _ok, it_1d = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, mixed_precision=True, return_iters=True,
        device="cpu", **grid)
    assert np.abs(iters - it_1d).max() <= MIXED_ITER_SPREAD
    x_j, _ok = _jax_sharded(jax_results, "mixed13", row_ptr, col_ind, data,
                            rhs, mixed_precision=True, **grid)
    assert _rel(x, x_j) <= X_TOL


def test_sharded_mixed_precision_mesh_shapes():
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        5, 3, 4, 2, seed=14)
    expected = np.linalg.solve(dense, rhs.T).T
    for n_dev in (2, 8):
        x, ok, _it = _solve(n_dev, row_ptr, col_ind, data, rhs,
                            row_to_cell=row_to_cell, nhoriz=nhoriz,
                            mixed_precision=True)
        assert ok.all()
        np.testing.assert_allclose(x, expected, rtol=1e-8, atol=1e-10)
        x_j, _ok = jax_sharded.solve_csr_systems_sharded(
            row_ptr, col_ind, data, rhs, mesh=_jax_mesh(n_dev),
            row_to_cell=row_to_cell, nhoriz=nhoriz, mixed_precision=True)
        assert _rel(x, x_j) <= X_TOL


def test_sharded_mixed_precision_needs_line_args():
    row_ptr, col_ind, data, _dense, rhs = _random_csr(16, 1, seed=15)
    with pytest.raises(ValueError, match="mixed_precision"):
        _solve(2, row_ptr, col_ind, data, rhs, mixed_precision=True)


def test_sharded_solve_rhs_shape_error():
    row_ptr, col_ind, data, _dense, rhs = _random_csr(16, 2, seed=4)
    with pytest.raises(ValueError, match="rhs_batch"):
        _solve(2, row_ptr, col_ind, data, rhs[:, :-1])
    r2c_args = grid_csr(4, 2, 3, 1, seed=4)
    with pytest.raises(ValueError, match="rhs_batch"):
        _solve(2, *r2c_args[:3], r2c_args[4][:, :-1],
               row_to_cell=r2c_args[5], nhoriz=r2c_args[6])


@pytest.mark.parametrize("shape", [(2, 2), (1, 2, 2)],
                         ids=["two module rows", "space_x"])
def test_sharded_solve_rejects_2d_mesh(shape):
    row_ptr, col_ind, data, _dense, rhs = _random_csr(16, 1, seed=5)
    n_module, n_space, *n_x = shape
    mesh = make_mesh(n_module, n_space, devices=["cpu"] * 4,
                     n_space_x=n_x[0] if n_x else None)
    with pytest.raises(ValueError, match="1-D mesh"):
        port_sharded.solve_csr_systems_sharded(row_ptr, col_ind, data, rhs,
                                               mesh=mesh)


def test_default_mesh_on_the_cpu_falls_back_and_logs(caplog):
    """mesh=None on the CPU is one device: the unsharded solve, logged"""
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = grid_csr(
        4, 2, 3, 2, seed=6)
    with caplog.at_level(logging.INFO, logger=port_sharded.__name__):
        x, ok, iters = port_sharded.solve_csr_systems_sharded(
            row_ptr, col_ind, data, rhs, row_to_cell=row_to_cell,
            nhoriz=nhoriz, device="cpu", return_iters=True)
    assert "solving unsharded" in caplog.text
    x_1d, _ok, it_1d = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, row_to_cell=row_to_cell, nhoriz=nhoriz,
        return_iters=True, device="cpu")
    assert ok.all()
    np.testing.assert_array_equal(x, x_1d)
    np.testing.assert_array_equal(iters, it_1d)
