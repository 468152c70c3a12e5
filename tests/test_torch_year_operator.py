"""the port's dense year operator (ops/year_operator.py,
IageKernel.build_year_operator) against the JAX package's on the CPU, the
operator against the time-stepped year it was probed from (the JAX test's
bounds, tests/test_year_operator.py), and B1's channel map: the wrapper's
packing and table-slot checks against csrc/iage_year.cu's layout, and the
table's size check"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel as JaxIageKernel,
)
from newton_krylov_ooc_tpu.ops.year_operator import (  # noqa: E402
    YearOperator as JaxYearOperator,
)
from newton_krylov_ooc_tpu_torch.cli import year_operator_spinup  # noqa: E402
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (  # noqa: E402
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import imex_cuda  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops.year_operator import (  # noqa: E402
    YearOperator,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
NZ, NY, N_STEPS = 5, 4, 6
CHUNK = 7  # 20 columns a tracer: chunks of 7, 7 and a ragged 6
# B against the JAX package's, relative to max|B|: the same year in two
# frameworks (float64), float32 rounding of the same year (float32)
B_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
OP_TOL = 1e-5  # the JAX test's bound: the operator against the year


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(dtype):
    depth, ypos = build_axes(NZ, NY)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jk = JaxIageKernel(depth, ypos, MODELINFO, dtype=jdtype, n_steps=N_STEPS,
                       use_pallas=False)
    grid = grid_from_numpy({k: np.asarray(v) for k, v in jk.grid._asdict().items()},
                           device=CPU, dtype=dtype)
    tk = IageKernel(depth, ypos, MODELINFO, device=CPU, dtype=dtype,
                    n_steps=N_STEPS, grid=grid)
    return jk, tk


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def operators(request):
    jk, tk = _pair(request.param)
    return (request.param, jk, tk, jk.build_year_operator(col_chunk=CHUNK),
            tk.build_year_operator(col_chunk=CHUNK))


def test_probe_matches_jax(operators):
    """B and c, probed with a ragged last chunk, against the JAX package's
    scan-path operator"""
    dtype, _, tk, jop, op = operators
    assert op.b_mats.dtype == op.const.dtype == dtype
    assert tuple(op.b_mats.shape) == (2, NZ * NY, NZ * NY)
    assert _rel(op.b_mats, jop.b_mats) < B_TOL[dtype]
    assert _rel(op.const, jop.const) < B_TOL[dtype]


def test_fcn_and_jvp_match_the_time_stepped_year(operators):
    dtype, _, tk, _, op = operators
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, NZ, NY)), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((2, NZ, NY)), dtype=dtype)
    tol = OP_TOL if dtype == torch.float32 else 1e-12
    assert _rel(op.fcn(x), tk.comp_fcn(x)) < tol
    assert _rel(op.year(x), tk._year_fn(x)) < tol
    assert _rel(op.jvp(v), tk.jvp(x, None, v)) < tol


def test_with_source_reuses_b(operators):
    """a doubled aging source: the probed B with a new constant response
    against a year built with that source, without a new probe"""
    dtype, _, tk, _, op = operators
    year2 = imex_cuda.build_iage_year_plain(
        tk.grid, tk._vert_diag, np.full((2, 1, 1), 2.0 / tk.year),
        (0.0, tk.year), N_STEPS)
    op2 = op.with_source(year2)
    assert op2.b_mats is op.b_mats
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, NZ, NY)),
                        dtype=dtype)
    tol = OP_TOL if dtype == torch.float32 else 1e-12
    assert _rel(op2.fcn(x), year2(x) - x) < tol


# the float32 direct solve at 6 steps a year sits on float32's floor: its B
# is 1.4e-5 from the float64 B (the JAX package's float32 B 1.2e-5), its X*
# 2.1e-5 from the float64 root (JAX's 1.25e-5), and |F(X*)| through the
# float32 year 1.00e-5 of max|X*| (JAX's on its own year 4.3e-7); the
# float64 solve is held to the JAX test's 1e-5, the float32 one to the
# float64 root
F32_ROOT_TOL = 5e-5


def test_direct_spinup_lands_on_a_root_of_the_year(operators):
    """(I - B) X = c solved directly: a root of the time-stepped F, not
    merely of the operator model"""
    dtype, _, tk, _, op = operators
    x_star = op.solve_cyclostationary()
    assert x_star.dtype == dtype and x_star.shape == (2, NZ, NY)
    assert (op.rel_resid(x_star) < 1e-4).all()
    scale = max(float(x_star.abs().max()), 1.0)
    if dtype == torch.float64:
        assert float(tk.comp_fcn(x_star).abs().max()) / scale < OP_TOL
        return
    _, k64 = _pair(torch.float64)
    root = k64.build_year_operator(col_chunk=CHUNK).solve_cyclostationary()
    assert float(k64.comp_fcn(root).abs().max()) / scale < OP_TOL
    assert _rel(x_star.double(), root) < F32_ROOT_TOL


def test_spectrum_matches_dense_eigvals(operators):
    dtype, _, _, _, op = operators
    k = 4
    eigvals, timescales = op.spectrum(k=k, iters=300)
    for t in range(2):
        exact = np.linalg.eigvals(op.b_mats[t].double().numpy())
        exact = exact[np.argsort(-np.abs(exact))][:k]
        assert np.allclose(np.abs(eigvals[t]), np.abs(exact), rtol=1e-3,
                           atol=1e-5)
    assert (np.abs(eigvals) < 1.0).all()
    assert np.isfinite(timescales).all() and (timescales > 0).all()


def test_from_numpy_carries_the_jax_operator():
    """YearOperator.from_numpy on the JAX operator's arrays: both packages'
    direct solve and spectrum on the same B"""
    jk, _ = _pair(torch.float64)
    jop = jk.build_year_operator(col_chunk=CHUNK)
    op = YearOperator.from_numpy(np.asarray(jop.b_mats),
                                 np.asarray(jop.const), NZ, NY, device=CPU)
    assert op.b_mats.dtype == torch.float64
    assert np.array_equal(op.b_mats.numpy(), np.asarray(jop.b_mats))
    assert _rel(op.solve_cyclostationary(), jop.solve_cyclostationary()) < 1e-12
    ours, ours_tau = op.spectrum(k=4, iters=300)
    ref, ref_tau = jop.spectrum(k=4, iters=300)
    assert np.allclose(np.abs(ours), np.abs(ref), rtol=1e-10)
    assert np.allclose(ours_tau, ref_tau, rtol=1e-8)
    assert isinstance(jop, JaxYearOperator)


def test_phosphorus_refuses_the_probe():
    depth, ypos = build_axes(NZ, NY)
    phos = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU, n_steps=4)
    with pytest.raises(NotImplementedError, match="nonlinear"):
        phos.build_year_operator()


def test_cli_runs_on_the_cpu(capsys):
    kernel, op, x_star, info = year_operator_spinup.main(
        [str(NZ), str(NY), str(N_STEPS), str(CHUNK), "--device", "cpu"])
    assert not kernel.use_kernel and info["table_bytes"] is None
    assert tuple(op.b_mats.shape) == (2, NZ * NY, NZ * NY)
    assert info["resid"] < F32_ROOT_TOL * max(float(x_star.abs().max()), 1.0)
    assert info["probe_seconds"] > 0.0 and info["eigvals"].shape == (2, 5)
    out = capsys.readouterr().out
    assert "probed B" in out and "propagator spectrum" in out
    args = year_operator_spinup.parse_args([])
    assert (args.nz, args.ny, args.n_steps, args.col_chunk) == \
        (40, 50, 8760, 125)
    assert args.device == "cuda"


# -- B1's channel map -----------------------------------------------------------

def _diag(nz, ny):
    rate = surf_restore_rate(build_axes(nz, ny)[0])
    diag = np.zeros((2, nz, ny))
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    return diag


def test_channel_map_packing_matches_the_kernel_source():
    """the packed constants end with each channel's slot, where
    csrc/iage_year.cu reads it (after the header, the grid, T sources and
    the (T, nz, ny) diagonal), and the kernel's field count is the
    wrapper's"""
    source = (imex_cuda.CSRC / "iage_year.cu").read_text()
    common = (imex_cuda.CSRC / "imex_common.cuh").read_text()
    header = int(re.search(r"constexpr int kHeader = (\d+);", common).group(1))
    assert header == imex_cuda._HEADER
    assert "kHeader + grid_floats(nz, ny) + 2L * t_dim + (long)t_dim * nz * ny" \
        in source
    assert ("fields[kHeader + grid_floats(nz, ny) + t_dim +\n"
            "                     (long)t_dim * nz * ny + ch]") in source
    assert "fetch<kPcr>(smem, slot_len, slot_bar, table, 0, slot, n_slots" \
        in source
    nz, ny = 6, 5
    grid = physics.make_grid(*build_axes(nz, ny), MODELINFO, device=CPU,
                             dtype=torch.float32)
    diag = np.repeat(_diag(nz, ny), 3, axis=0)           # 6 channels
    slot_map = torch.tensor([0, 0, 0, 1, 1, 1])
    fields = imex_cuda._pack_fields(grid, torch.as_tensor(diag),
                                    torch.zeros(6), slot_map)
    n_grid = fields.numel() - header - 2 * 6 - 6 * nz * ny
    assert n_grid == 2 * nz * (ny - 1) + (nz - 1) * ny + 2 * ny + 4 * nz - 2
    assert torch.equal(fields[-6:], slot_map.to(torch.float32))
    assert torch.equal(fields[header + n_grid + 6:-6].reshape(6, nz, ny),
                       torch.as_tensor(diag, dtype=torch.float32))


def test_table_slots_and_channel_map():
    """one slot a distinct diagonal, in order of first appearance; a year's
    channels map to the slots that hold their diagonals, and a year of a
    diagonal the table lacks is refused"""
    nz, ny, n_steps = 6, 5, 8
    span = (0.0, physics.SEC_PER_YEAR)
    grid = physics.make_grid(*build_axes(nz, ny), MODELINFO, device=CPU,
                             dtype=torch.float32)
    diag = _diag(nz, ny)
    probe = np.concatenate([np.repeat(diag[:1], 3, axis=0),
                            np.repeat(diag[1:], 3, axis=0)])
    assert torch.equal(imex_cuda.table_slots(probe), torch.as_tensor(diag))
    assert torch.equal(imex_cuda.table_slots(diag[::-1].copy()),
                       torch.as_tensor(diag[::-1].copy()))

    # the table of the two tracers serves the probe's six channels
    table = imex_cuda.build_iage_table(grid, probe, span, n_steps,
                                       device="cpu")
    assert table.shape == (2, nz, ny)
    assert table.nbytes == imex_cuda.table_layout(2, nz, ny, n_steps)["bytes"]
    t0, dt = imex_cuda._time_step(span, n_steps)
    key = imex_cuda._table_key(grid, torch.as_tensor(probe))
    assert table.check(key, (6, nz, ny), n_steps, t0, dt, CPU).tolist() == \
        [0, 0, 0, 1, 1, 1]
    swapped = imex_cuda._table_key(grid, torch.as_tensor(probe[::-1].copy()))
    assert table.check(swapped, (6, nz, ny), n_steps, t0, dt,
                       CPU).tolist() == [1, 1, 1, 0, 0, 0]
    own = imex_cuda._table_key(grid, torch.as_tensor(diag))
    assert table.check(own, (2, nz, ny), n_steps, t0, dt, CPU).tolist() == \
        [0, 1]
    foreign = probe.copy()
    foreign[4] *= 2.0
    with pytest.raises(ValueError, match="another year"):
        table.check(imex_cuda._table_key(grid, torch.as_tensor(foreign)),
                    (6, nz, ny), n_steps, t0, dt, CPU)
    with pytest.raises(ValueError, match="another year"):
        table.check(key, (6, nz, ny), n_steps + 1, t0, dt, CPU)
    # the packed table's factors are the plain table's of the two slots
    times, h = imex_cuda.solve_times(span, n_steps)
    plain = imex_cuda.iage_table_plain(grid, diag, times, h)
    for ours, ref in zip(imex_cuda.unpack_table(table.tensor, 2, nz, ny,
                                                n_steps), plain):
        assert torch.equal(ours, ref)


def test_table_size_check():
    """the table's bytes at the year-operator example's size: 488,933,888
    for the two tracers' slots, about 52.6 GB for one slot each of the
    probe's 250 channels; a table larger than the card's free memory is
    refused, with the sizes, before it is allocated"""
    assert imex_cuda.table_layout(2, 40, 50, 8760)["bytes"] == 488_933_888
    full = imex_cuda.table_layout(250, 40, 50, 8760)["bytes"]
    assert abs(full - 52.6e9) < 0.05e9
    free, total = 40 * 2**30, 80 * 2**30
    imex_cuda.check_table_bytes(488_933_888, free, total, "a card")
    with pytest.raises(ValueError, match=f"needs {full} bytes .*"
                                         f"{free} of {total} bytes are free"):
        imex_cuda.check_table_bytes(full, free, total, "a card")
