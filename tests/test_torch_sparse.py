"""the port's ops/sparse.py held against the JAX package's on the CPU: every
function of the module on sparse_fixtures' grid systems and on a small
gen_A matrix from the committed native binary, the twins of
tests/test_sparse_dia.py, and the twin of
test_native.py::test_device_sparse_solve_matches_native through the cime_pop
adapter's _device_solve_matrix.

Tolerances, relative to the compared quantity's max: operators 1e-13 (the
same float64 arithmetic, reductions in another order); solutions 1e-9 (both
converge to a 1e-12 residual on systems of condition ~1e2-1e3).  Per-rhs
iterations equal JAX's in the float64 line route.  The float64 Jacobi and ELL
routes run more iterations than the systems have unknowns, where the count
is decided by rounding: JAX's own count moves by up to 31 of ~85 when the
right-hand side changes by 1e-15 relative.  So each package solves the
fixture's right-hand side and PERTURBED_RHS - 1 seeded copies changed by
RHS_JITTER relative, and the port's median count must lie within the range
of JAX's counts over the same right-hand sides (read on this fixture: JAX
79-101 and 79-113 for Jacobi, 75-96 and 74-86 for ELL; the port's medians
91, 84, 91 and 84.5).  The mixed route's float32 inner loops round
otherwise than XLA's: held within MIXED_ITER_SPREAD of JAX's, a bound set
from the first readings on these fixtures (the port against JAX up to 2,
the port's sharded against its unsharded solve 3 on one fixture), not
fixed before them.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import newton_krylov_ooc_tpu.models.cime_pop.model_state as jax_cime
import newton_krylov_ooc_tpu.ops.sparse as jax_sparse
import newton_krylov_ooc_tpu_torch.models.cime_pop.model_state as port_cime
import newton_krylov_ooc_tpu_torch.ops.sparse as port_sparse
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic
from newton_krylov_ooc_tpu_torch.utils.ncio import NCFile
from sparse_fixtures import grid_csr

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
GEN_A = os.path.join(REPO, "native", "precond_tools", "bin", "gen_A")
needs_gen_a = pytest.mark.skipif(not os.path.exists(GEN_A),
                                 reason="native tools not built")

OP_TOL = 1e-13
X_TOL = 1e-9
PERTURBED_RHS = 8
RHS_JITTER = 1e-15
MIXED_ITER_SPREAD = 3


def _t(arr, dtype=torch.float64):
    return torch.as_tensor(np.asarray(arr), dtype=dtype)


def _perturbed(rhs):
    """the right-hand side, then PERTURBED_RHS - 1 seeded copies changed by
    RHS_JITTER relative"""
    return [rhs] + [
        rhs * (1.0 + RHS_JITTER
               * np.random.default_rng(100 + k).standard_normal(rhs.shape))
        for k in range(1, PERTURBED_RHS)]


def _assert_median_in_jax_range(counts_p, counts_j):
    """counts (PERTURBED_RHS, ...) of each package over _perturbed's
    right-hand sides: the port's median within JAX's range"""
    med = np.median(np.asarray(counts_p), axis=0)
    counts_j = np.asarray(counts_j)
    assert (counts_j.min(axis=0) <= med).all(), (counts_p, counts_j)
    assert (med <= counts_j.max(axis=0)).all(), (counts_p, counts_j)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def system():
    return grid_csr(4, 3, 5, n_rhs=2, seed=3)


@pytest.fixture(scope="module")
def gen_a_system(tmp_path_factory):
    """a gen_A matrix of the synthetic circulation at 5 x 12 x 10 with the
    JAX bench's precond options, and two seeded right-hand sides"""
    if not os.path.exists(GEN_A):
        pytest.skip("native tools not built")
    work = tmp_path_factory.mktemp("gen_a")
    circ = synthetic.gen_circulation(5, 12, 10)
    synthetic.write_circulation(str(work / "irf.nc"), circ)
    synthetic.write_grid_vars(str(work / "grid_vars.nc"), circ)
    (work / "matrix.opts").write_text(
        "day_cnt 365\n"
        f"reg_fname {work / 'grid_vars.nc'}\n"
        f"circ_fname {work / 'irf.nc'}\n"
        "vmix_type file VDC\nadv_type upwind3\nhmix_type isop_file\n"
        "sink_type const 3.17e-10\n"
    )
    subprocess.run([GEN_A, "-o", str(work / "matrix.opts"),
                    str(work / "matrix.nc")], check=True, capture_output=True)
    with NCFile(str(work / "matrix.nc")) as fptr:
        row_ptr = fptr.var("row_ptr")[:].astype(np.int64)
        col_ind = fptr.var("col_ind")[:].astype(np.int64)
        data = np.asarray(fptr.var("data")[:], np.float64)
        row_to_cell = fptr.var("row_to_cell")[:].astype(np.int64)
        nhoriz = fptr.dimensions["grid_nhoriz"]
    n = len(row_ptr) - 1
    dense = np.zeros((n, n))
    dense[np.repeat(np.arange(n), np.diff(row_ptr)), col_ind] = data
    rhs = np.random.default_rng(17).normal(size=(2, n))
    return row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz


@pytest.fixture(params=["grid_csr", "gen_a"])
def any_system(request, system, gen_a_system):
    return system if request.param == "grid_csr" else gen_a_system


# -- the module's functions, one by one, against JAX's ----------------------


def test_csr_to_ell_and_ell_ops_match_jax(any_system):
    row_ptr, col_ind, data, dense, _rhs, _r2c, _nh = any_system
    vals_j, cols_j = jax_sparse.csr_to_ell(row_ptr, col_ind, data)
    vals_p, cols_p = port_sparse.csr_to_ell(row_ptr, col_ind, data)
    np.testing.assert_array_equal(vals_p, vals_j)
    np.testing.assert_array_equal(cols_p, cols_j)
    x = np.random.default_rng(0).normal(size=dense.shape[0])
    got = port_sparse.ell_matvec(_t(vals_p), _t(cols_p, torch.int64), _t(x))
    ref = np.asarray(jax_sparse.ell_matvec(vals_j, cols_j, x))
    assert _rel(got, ref) <= OP_TOL
    assert _rel(got, dense @ x) <= OP_TOL
    np.testing.assert_array_equal(
        port_sparse.ell_diagonal(_t(vals_p), _t(cols_p, torch.int64)),
        np.asarray(jax_sparse.ell_diagonal(vals_j, cols_j)))
    np.testing.assert_array_equal(
        port_sparse.jacobi_inverse_diagonal(_t(vals_p), _t(cols_p, torch.int64)),
        np.asarray(jax_sparse.jacobi_inverse_diagonal(vals_j, cols_j)))


def test_grid_dia_and_matvec_match_jax(any_system):
    row_ptr, col_ind, data, dense, _rhs, row_to_cell, nhoriz = any_system
    n_cells = (int(row_to_cell.max()) // nhoriz + 1) * nhoriz
    off_j, coefs_j = jax_sparse.grid_dia_from_csr(
        row_ptr, col_ind, data, row_to_cell, n_cells)
    off_p, coefs_p = port_sparse.grid_dia_from_csr(
        row_ptr, col_ind, data, row_to_cell, n_cells)
    assert off_p == off_j
    np.testing.assert_array_equal(coefs_p, coefs_j)
    x = np.zeros(n_cells)
    x[row_to_cell] = np.random.default_rng(1).normal(size=len(row_to_cell))
    got = port_sparse.dia_matvec(off_p, _t(coefs_p), _t(x)).numpy()
    ref = np.asarray(jax_sparse.dia_matvec(off_j, coefs_j, x))
    # the same multiply-adds in the offsets' order: bit for bit
    np.testing.assert_array_equal(got, ref)
    assert _rel(got[row_to_cell], dense @ x[row_to_cell]) <= OP_TOL


def test_line_preconditioners_match_jax(any_system):
    row_ptr, col_ind, data, _dense, _rhs, row_to_cell, nhoriz = any_system
    nz = int(row_to_cell.max()) // nhoriz + 1
    bands_j = jax_sparse.column_tridiag_grid(
        row_ptr, col_ind, data, row_to_cell, nhoriz, nz)
    bands_p = port_sparse.column_tridiag_grid(
        row_ptr, col_ind, data, row_to_cell, nhoriz, nz)
    for got, ref in zip(bands_p, bands_j):
        np.testing.assert_array_equal(got, ref)
    v = np.random.default_rng(2).normal(size=nz * nhoriz)
    got = port_sparse.grid_line_precond_apply(*map(_t, bands_p), _t(v))
    ref = jax_sparse.grid_line_precond_apply(*bands_j, v)
    assert _rel(got, ref) <= OP_TOL

    packed_j = jax_sparse.column_tridiag_from_csr(
        row_ptr, col_ind, data, row_to_cell, nhoriz)
    packed_p = port_sparse.column_tridiag_from_csr(
        row_ptr, col_ind, data, row_to_cell, nhoriz)
    for got, ref in zip(packed_p, packed_j):
        np.testing.assert_array_equal(got, ref)
    v = np.random.default_rng(3).normal(size=len(row_to_cell))
    got = port_sparse.line_precond_apply(
        *map(_t, packed_p[:3]), _t(packed_p[3], torch.int64), _t(v))
    ref = jax_sparse.line_precond_apply(*packed_j, v)
    assert _rel(got, ref) <= OP_TOL


def test_bicgstab_ell_matches_jax(system):
    row_ptr, col_ind, data, dense, rhs, _r2c, _nh = system
    vals, cols = port_sparse.csr_to_ell(row_ptr, col_ind, data)
    counts_p, counts_j = [], []
    for k, b in enumerate(_perturbed(rhs[0])):
        x_p, ok_p, k_p = port_sparse.bicgstab_ell(
            _t(vals), _t(cols, torch.int64), _t(b))
        x_j, ok_j, k_j = jax_sparse.bicgstab_ell(vals, cols, b)
        counts_p.append(int(k_p))
        counts_j.append(int(k_j))
        if k == 0:
            assert bool(ok_p) and bool(ok_j)
            assert _rel(x_p, x_j) <= X_TOL
            assert _rel(x_p, np.linalg.solve(dense, rhs[0])) <= X_TOL
    _assert_median_in_jax_range(counts_p, counts_j)


ROUTES = {
    "line": dict(grid=True),
    "jacobi": dict(grid=True, precond="jacobi"),
    "mixed": dict(grid=True, mixed_precision=True),
    "mixed polish": dict(grid=True, mixed_precision=True, refine_rounds=0),
    "ell": dict(grid=False),
}


# pointwise Jacobi (the DIA jacobi and ELL routes) does not converge on the
# stiff gen_A matrix at this size in either package (condition ~2e5: JAX's
# stagnates to max_iter, the port's reaches an exact rho = 0 breakdown
# first); those routes are held on the grid fixture
CASES = [(fixture, route) for fixture in ("grid_csr", "gen_a")
         for route in ROUTES
         if fixture == "grid_csr" or route not in ("jacobi", "ell")]


@pytest.mark.parametrize("fixture, route", CASES)
def test_solve_csr_systems_matches_jax(request, fixture, route):
    """every route: converged, the dense solution, JAX's solution, and JAX's
    per-rhs iterations (exactly in float64's line and polish routes)"""
    name = "system" if fixture == "grid_csr" else "gen_a_system"
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = (
        request.getfixturevalue(name))
    kwargs = dict(ROUTES[route])
    if kwargs.pop("grid"):
        kwargs.update(row_to_cell=row_to_cell, nhoriz=nhoriz)
    x_p, ok_p, it_p = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, return_iters=True, device="cpu", **kwargs)
    x_j, ok_j, it_j = jax_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, return_iters=True, **kwargs)
    np.testing.assert_array_equal(ok_p, ok_j)
    assert ok_p.all()
    assert _rel(x_p, x_j) <= X_TOL
    assert _rel(x_p, np.linalg.solve(dense, rhs.T).T) <= X_TOL
    if route in ("line", "mixed polish"):
        np.testing.assert_array_equal(it_p, it_j)
    elif route == "mixed":
        assert np.abs(it_p - it_j).max() <= MIXED_ITER_SPREAD
    else:
        counts_p, counts_j = [it_p], [it_j]
        for b in _perturbed(rhs)[1:]:
            counts_p.append(port_sparse.solve_csr_systems(
                row_ptr, col_ind, data, b, return_iters=True, device="cpu",
                **kwargs)[2])
            counts_j.append(jax_sparse.solve_csr_systems(
                row_ptr, col_ind, data, b, return_iters=True, **kwargs)[2])
        _assert_median_in_jax_range(counts_p, counts_j)


def test_zero_rhs_exits_at_zero_iterations(system):
    """a zeroed right-hand side exits at once in every route (the mixed
    route's polish relies on it)"""
    row_ptr, col_ind, data, _dense, rhs, row_to_cell, nhoriz = system
    rhs = np.stack([np.zeros_like(rhs[0]), rhs[1]])
    for route, kwargs in ROUTES.items():
        kwargs = dict(kwargs)
        if kwargs.pop("grid"):
            kwargs.update(row_to_cell=row_to_cell, nhoriz=nhoriz)
        x, ok, iters = port_sparse.solve_csr_systems(
            row_ptr, col_ind, data, rhs, return_iters=True, device="cpu",
            **kwargs)
        assert ok.all() and iters[0] == 0 and iters[1] > 0, route
        assert (x[0] == 0.0).all(), route


def test_solve_csr_systems_refuses_cuda_without_a_card(system):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    row_ptr, col_ind, data, _dense, rhs, _r2c, _nh = system
    with pytest.raises(RuntimeError, match="cuda"):
        port_sparse.solve_csr_systems(row_ptr, col_ind, data, rhs)


# -- twins of tests/test_sparse_dia.py ---------------------------------------


def test_dia_matvec_matches_dense(system):
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = system
    nz = int(row_to_cell.max()) // nhoriz + 1
    n_cells = nz * nhoriz
    offsets, coefs = port_sparse.grid_dia_from_csr(
        row_ptr, col_ind, data, row_to_cell, n_cells)
    # the fixture's periodic horizontal coupling shows up as distinct wrap
    # diagonals, not folded into +-1
    assert max(offsets) >= nhoriz - 1
    x = np.random.default_rng(0).normal(size=dense.shape[0])
    x_grid = np.zeros(n_cells)
    x_grid[row_to_cell] = x
    got = port_sparse.dia_matvec(offsets, _t(coefs), _t(x_grid)).numpy()
    np.testing.assert_allclose(got[row_to_cell], dense @ x, rtol=1e-13)
    dry = np.ones(n_cells, bool)
    dry[row_to_cell] = False
    assert np.abs(got[dry]).max() == 0.0
    np.testing.assert_array_equal(
        got, np.asarray(jax_sparse.dia_matvec(offsets, coefs, x_grid)))


def test_grid_line_precond_matches_line_system(system):
    row_ptr, col_ind, data, _dense, _rhs, row_to_cell, nhoriz = system
    nz = int(row_to_cell.max()) // nhoriz + 1
    dl, d, du = port_sparse.column_tridiag_grid(
        row_ptr, col_ind, data, row_to_cell, nhoriz, nz)
    rng = np.random.default_rng(1)
    v = np.zeros(nz * nhoriz)
    v[row_to_cell] = rng.normal(size=len(row_to_cell))
    lines = v.reshape(nz, nhoriz).T
    applied = d * lines
    applied[:, 1:] += dl[:, 1:] * lines[:, :-1]
    applied[:, :-1] += du[:, :-1] * lines[:, 1:]
    got = port_sparse.grid_line_precond_apply(
        _t(dl), _t(d), _t(du), _t(applied.T.reshape(-1))).numpy()
    np.testing.assert_allclose(got, v, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("precond", ["line", "jacobi"])
def test_solve_matches_dense(system, precond):
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = system
    x, ok, iters = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, row_to_cell=row_to_cell, nhoriz=nhoriz,
        precond=precond, return_iters=True, device="cpu")
    assert ok.all()
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs.T).T,
                               rtol=1e-8, atol=1e-11)
    if precond == "line":
        # the stiff coupling is vertical: line preconditioning wins big
        _xj, okj, itj = port_sparse.solve_csr_systems(
            row_ptr, col_ind, data, rhs, row_to_cell=row_to_cell,
            nhoriz=nhoriz, precond="jacobi", return_iters=True, device="cpu")
        assert okj.all() and iters.max() * 4 <= itj.max()


def test_mixed_polish_fallback(system):
    """refine_rounds=0 skips refinement: convergence comes from the float64
    polish, the stalled-refinement rescue path"""
    row_ptr, col_ind, data, dense, rhs, row_to_cell, nhoriz = system
    x, ok, _iters = port_sparse.solve_csr_systems(
        row_ptr, col_ind, data, rhs, row_to_cell=row_to_cell, nhoriz=nhoriz,
        mixed_precision=True, refine_rounds=0, return_iters=True,
        device="cpu")
    assert ok.all()
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs.T).T,
                               rtol=1e-8, atol=1e-11)


def test_unstructured_matrix_rejected():
    """entries scattered over too many cell offsets: the grid path refuses
    instead of building an enormous DIA form, as JAX's does"""
    rng = np.random.default_rng(5)
    n = 200
    row_ptr = [0]
    col_ind = []
    data = []
    for _r in range(n):
        cols = rng.choice(n, size=4, replace=False)
        col_ind.extend(sorted(cols.tolist()))
        data.extend(rng.normal(size=4).tolist())
        row_ptr.append(len(col_ind))
    args = (np.asarray(row_ptr), np.asarray(col_ind), np.asarray(data),
            np.zeros((1, n)))
    for solve, extra in ((port_sparse.solve_csr_systems, {"device": "cpu"}),
                         (jax_sparse.solve_csr_systems, {})):
        with pytest.raises(ValueError, match="offsets"):
            solve(*args, row_to_cell=np.arange(n), nhoriz=n, **extra)
    with pytest.raises(ValueError, match="mixed_precision"):
        port_sparse.solve_csr_systems(*args, mixed_precision=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="precond"):
        port_sparse.solve_csr_systems(*args, precond="ilu", device="cpu")


# -- twin of test_native.py::test_device_sparse_solve_matches_native ---------


@needs_gen_a
@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_device_solve_matrix_matches_jax(tmp_path, mixed):
    """the adapter's _device_solve_matrix on the CPU against JAX's on the
    same gen_A matrix and state file: the solution, the _OLD twin, and the
    dense solve"""
    nz, nlat, nlon = 5, 3, 2
    reg_fname = tmp_path / "grid_vars.nc"
    with NCFile(str(reg_fname), mode="w") as fptr:
        fptr.create_dimensions_verify({"z_t": nz, "nlat": nlat, "nlon": nlon})
        mask = fptr.create_variable("region_mask", "i4", ("z_t", "nlat", "nlon"))
        mask[:] = np.ones((nz, nlat, nlon), np.int32)
    circ_fname = tmp_path / "irf.nc"
    with NCFile(str(circ_fname), mode="w") as fptr:
        fptr.create_dimensions_verify({"z_t": nz, "nlat": nlat, "nlon": nlon})
        fptr.create_variable("dz", "f8", ("z_t",))[:] = np.full(nz, 100.0e2)
        vdc = fptr.create_variable("VDC", "f8", ("z_t", "nlat", "nlon"))
        vdc[:] = np.full((nz, nlat, nlon), 1.0e4)
    opts = tmp_path / "matrix.opts"
    opts.write_text(
        "day_cnt 365\n"
        f"reg_fname {reg_fname}\n"
        f"circ_fname {circ_fname}\n"
        "vmix_type file VDC\n"
        "sink_type const 1.0e-8\n"
    )
    matrix_fname = tmp_path / "matrix.nc"
    subprocess.run([GEN_A, "-D1", "-o", str(opts), str(matrix_fname)],
                   check=True, capture_output=True)

    rhs = np.random.default_rng(7).normal(size=(nz, nlat, nlon))
    states = {}
    for name, solve, extra in (
            ("jax", jax_cime._device_solve_matrix, {}),
            ("port", port_cime._device_solve_matrix, {"device": "cpu"})):
        states[name] = tmp_path / f"state_{name}.nc"
        with NCFile(str(states[name]), mode="w") as fptr:
            fptr.create_dimensions_verify({"z_t": nz, "nlat": nlat, "nlon": nlon})
            for suffix in ["CUR", "OLD"]:
                fptr.create_variable(
                    f"IAGE_{suffix}", "f8", ("z_t", "nlat", "nlon"))[:] = rhs
        solve(str(matrix_fname), str(states[name]), ["IAGE_CUR"],
              mixed_precision=mixed, **extra)

    with NCFile(str(matrix_fname)) as fptr:
        row_ptr = fptr.var("row_ptr")[:].astype(np.int64)
        col_ind = fptr.var("col_ind")[:].astype(np.int64)
        data = fptr.var("data")[:]
        row_to_cell = fptr.var("row_to_cell")[:].astype(np.int64)
    n = len(row_ptr) - 1
    a_dense = np.zeros((n, n))
    a_dense[np.repeat(np.arange(n), np.diff(row_ptr)), col_ind] = data
    expected = np.linalg.solve(a_dense, rhs.reshape(-1)[row_to_cell])
    sol = {}
    for name, fname in states.items():
        with NCFile(str(fname)) as fptr:
            sol[name] = fptr.var("IAGE_CUR")[:].reshape(-1)
            np.testing.assert_array_equal(sol[name],
                                          fptr.var("IAGE_OLD")[:].reshape(-1))
    np.testing.assert_allclose(sol["port"][row_to_cell], expected,
                               rtol=1e-8, atol=1e-11)
    assert _rel(sol["port"], sol["jax"]) <= X_TOL
