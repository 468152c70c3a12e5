"""the CUDA kernels (csrc/iage_year.cu with its PCR variant B1v1,
csrc/phosphorus_year.cu, csrc/transport3d_year.cu,
csrc/transport3d_stream.cu, csrc/iage_block.cu, csrc/transport3d_sweep.cu,
csrc/transport3d_block.cu, csrc/banded_lu.cu) against their plain PyTorch
versions; need an
NVIDIA Hopper card and nvcc, and skip without a card

    python -m pytest tests/test_torch_kernels.py -q     # on the card
"""

import ctypes

import numpy as np
import pytest
import torch

from newton_krylov_ooc_tpu_torch.cli.incore_spinup import MODELINFO, build_axes
from newton_krylov_ooc_tpu_torch.cli.irf3d_spinup import ABIO_SPECS, FAMILY_SPECS
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import phosphorus, physics
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import (
    banded,
    banded_cuda,
    imex_block_cuda,
    imex_cuda,
    transport3d_block_cuda,
    transport3d_cuda,
    transport3d_stream_cuda,
    transport3d_sweep_cuda,
)
from newton_krylov_ooc_tpu_torch.ops.transport3d import assemble_rate_fields
from newton_krylov_ooc_tpu_torch.parallel import mesh as port_mesh
from newton_krylov_ooc_tpu_torch.parallel import sharded_year
from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (
    ShardedTransport3dKernel,
    build_sharded_transport3d_year,
    build_sharded_transport3d_year_blocked,
    build_sharded_transport3d_year_stream,
    family_year_inputs,
)
from newton_krylov_ooc_tpu_torch.parallel.sharded_year import (
    ShardedIageKernel,
    ShardedYearData,
    build_sharded_year,
    build_sharded_year_blocked,
    build_sharded_year_blocked_plain,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# f32 rounding in another order (Thomas vs PCR, FMA), relative to max|y|:
# the JAX package's own bound for its kernel against the scan
TOL = 5e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _setup(nz, ny, device):
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=device,
                             dtype=torch.float32)
    rate = surf_restore_rate(depth)
    diag = np.zeros((2, nz, ny))
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    return grid, diag


# the B1 / B1v1 runs (nz, ny, n_steps, fraction of the year): the JAX tests'
# grid, phase 2's year, and a grid whose columns and levels divide into no
# lane group (53 columns of 16 lanes, 37 levels: 3 a lane, the last
# partial) over the first tenth of the year at phase 2's hourly step (at
# 200 steps a year the float32 PCR of the plain year is 1e-3 from float64)
IAGE_SHAPES = [(8, 6, 24, 1.0), (40, 50, 8760, 1.0), (37, 53, 876, 0.1)]


@pytest.mark.parametrize("nz, ny, n_steps, years", IAGE_SHAPES)
@pytest.mark.parametrize("aging", [True, False])
def test_year_kernel_matches_plain(cuda_device, nz, ny, n_steps, years,
                                   aging):
    grid, diag = _setup(nz, ny, cuda_device)
    source = np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR if aging else 0.0)
    span = (0.0, years * physics.SEC_PER_YEAR)
    rng = np.random.default_rng(7)
    y0 = torch.as_tensor(rng.uniform(0.0, 2.0, (2, nz, ny)), dtype=torch.float32,
                         device=cuda_device)

    before = imex_cuda.iage_year_launches
    y_k = imex_cuda.build_iage_year(grid, diag, source, span, n_steps,
                                    device=cuda_device)(y0)
    torch.cuda.synchronize()
    assert imex_cuda.iage_year_launches == before + 1
    y_p = imex_cuda.build_iage_year_plain(grid, diag, source, span, n_steps)(y0)

    assert torch.isfinite(y_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL


def test_year_kernel_rejects_what_it_cannot_take(cuda_device):
    grid, diag = _setup(8, 6, cuda_device)
    span = (0.0, physics.SEC_PER_YEAR)
    year = imex_cuda.build_iage_year(grid, diag, np.zeros((2, 1, 1)),
                                     span, 24, device=cuda_device)
    y0 = torch.ones((2, 8, 6), dtype=torch.float32, device=cuda_device)
    before = imex_cuda.iage_year_launches
    tables = imex_cuda.iage_table_launches
    for bad in (y0.double(), y0.cpu(), y0[:1], y0.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            year(bad)
    # a table of another year, no steps, a column of too many levels
    table = imex_cuda.build_iage_table(grid, diag, span, 24,
                                       device=cuda_device)
    tables += 1
    with pytest.raises(ValueError, match="another year"):
        imex_cuda.build_iage_year(grid, diag, np.zeros((2, 1, 1)), span, 48,
                                  device=cuda_device, table=table)
    with pytest.raises(ValueError, match="another year"):
        imex_cuda.build_iage_year_v1(grid, 2.0 * diag, np.zeros((2, 1, 1)),
                                     span, 24, device=cuda_device, table=table)
    with pytest.raises(ValueError, match="at least one step"):
        imex_cuda.build_iage_year(grid, diag, np.zeros((2, 1, 1)), span, 0,
                                  device=cuda_device)
    deep, deep_diag = _setup(300, 6, cuda_device)
    with pytest.raises(ValueError, match="8 levels a lane"):
        imex_cuda.build_iage_year(deep, deep_diag, np.zeros((2, 1, 1)), span,
                                  24, device=cuda_device)
    assert imex_cuda.iage_year_launches == before
    assert imex_cuda.iage_table_launches == tables


@pytest.mark.parametrize("nz, ny, n_steps, years", IAGE_SHAPES)
def test_table_kernel_matches_plain(cuda_device, nz, ny, n_steps, years):
    """the table kernel against iage_table_plain in float64 on the card,
    within 1e-4 of each field's largest value (float32 rounding of the
    factor recursion: at 24 steps a year, h = 1.3e6 s, denom = b - a cp
    cancels and the plain float32 table is itself 3.4e-5 from float64),
    and its layout against the counts csrc/iage_year.cu exports"""
    grid, diag = _setup(nz, ny, cuda_device)
    span = (0.0, years * physics.SEC_PER_YEAR)
    before = imex_cuda.iage_table_launches
    table = imex_cuda.build_iage_table(grid, diag, span, n_steps,
                                       device=cuda_device)
    torch.cuda.synchronize()
    assert imex_cuda.iage_table_launches == before + 1
    assert table.build_ms() > 0.0
    layout = imex_cuda.table_layout(2, nz, ny, n_steps)
    lib = imex_cuda._library("iage_year")
    assert lib.iage_year_kv_floats(nz, ny) == layout["kv_floats"]
    assert lib.iage_year_factor_floats(nz, ny) == layout["factor_floats"]
    assert (lib.iage_year_table_floats(2, nz, ny, n_steps)
            == layout["floats"])
    assert table.nbytes == layout["bytes"]
    times, h = imex_cuda.solve_times(span, n_steps)
    grid64 = physics.make_grid(*build_axes(nz, ny), MODELINFO,
                               device=cuda_device, dtype=torch.float64)
    plain = imex_cuda.iage_table_plain(grid64, diag, times, h)
    ours = imex_cuda.unpack_table(table.tensor, 2, nz, ny, n_steps)
    for name, a, b in zip(("kv", "m", "w", "cp"), ours, plain):
        assert torch.isfinite(a).all(), name
        assert float((a.double() - b).abs().max()) / float(b.abs().max()) \
            < 1e-4, name


def test_iage_kernel_builds_one_table(cuda_device):
    """IageKernel's F and JVP years run on one table, built once"""
    nz, ny, n_steps = 8, 6, 24
    depth, ypos = build_axes(nz, ny)
    before = imex_cuda.iage_table_launches
    kernel = IageKernel(depth, ypos, MODELINFO, device=cuda_device,
                        n_steps=n_steps)
    assert imex_cuda.iage_table_launches == before + 1
    x = kernel.init_iterate()
    years = imex_cuda.iage_year_launches
    fcn = kernel.comp_fcn(x)
    jvp = kernel.jvp(x, fcn, torch.ones_like(x))
    torch.cuda.synchronize()
    assert imex_cuda.iage_year_launches == years + 2
    assert imex_cuda.iage_table_launches == before + 1
    grid, diag = _setup(nz, ny, cuda_device)
    span = (0.0, physics.SEC_PER_YEAR)
    for source, got, y0 in (
            (np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR), fcn, x),
            (np.zeros((2, 1, 1)), jvp, torch.ones_like(x))):
        ref = imex_cuda.build_iage_year_plain(grid, diag, source, span,
                                              n_steps)(y0) - y0
        assert float((got - ref).abs().max()) / float(y0.abs().max()) < TOL


# B1 under the channel map: 8 channels of the two tracers' diagonals in an
# order no identity map gives, each with its own source, over the first
# tenth of phase 2's year
MAP_CHANNELS = [1, 0, 0, 1, 1, 0, 1, 0]


def _map_year_inputs(nz, ny, device):
    grid, diag = _setup(nz, ny, device)
    diag8 = diag[MAP_CHANNELS]
    source = (np.arange(8.0) / 4.0 / physics.SEC_PER_YEAR).reshape(8, 1, 1)
    span = (0.0, 0.1 * physics.SEC_PER_YEAR)
    y0 = torch.as_tensor(np.random.default_rng(17).uniform(0.0, 2.0,
                                                           (8, nz, ny)),
                         dtype=torch.float32, device=device)
    return grid, diag, diag8, source, span, y0


class _OwnSlots(imex_cuda.IageTable):
    """a table whose every channel streams its own slot: the identity map,
    once IageTable.check has accepted the year"""

    def check(self, key, shape, n_steps, t0, dt, device):
        super().check(key, shape, n_steps, t0, dt, device)
        return torch.arange(shape[0])


def _full_table(table, grid, diag8, n_steps):
    """a table of one slot for each of the 8 channels, its factors copied
    from the two-slot table's slots by the map, read through the identity
    map"""
    nz, ny = table.shape[1:]
    kv, m, w, cp = imex_cuda.unpack_table(table.tensor, 2, nz, ny, n_steps)
    slots = torch.as_tensor(MAP_CHANNELS, device=m.device)
    tensor = imex_cuda.pack_table(kv, m[:, slots], w[:, slots],
                                  cp[:, slots])
    return _OwnSlots(tensor, imex_cuda._table_key(
        grid, torch.as_tensor(diag8)), (8, nz, ny), n_steps, table.t0,
        table.dt)


@pytest.mark.parametrize("nz, ny", [(40, 50), (37, 53)])
def test_year_kernel_channel_map_matches_full_table(cuda_device, nz, ny):
    """B1 with 8 channels on the two-slot table (map 1, 0, 0, 1, 1, 0, 1,
    0) against B1 on a table of a slot a channel holding the same factors:
    bitwise equal, and one launch each"""
    grid, diag, diag8, source, span, y0 = _map_year_inputs(nz, ny,
                                                          cuda_device)
    n_steps = 876
    table = imex_cuda.build_iage_table(grid, diag, span, n_steps,
                                       device=cuda_device)
    assert table.shape[0] == 2
    slot_map = table.check(imex_cuda._table_key(grid, torch.as_tensor(diag8)),
                           (8, nz, ny), n_steps, *imex_cuda._time_step(
                               span, n_steps), cuda_device)
    assert slot_map.tolist() == MAP_CHANNELS
    full = _full_table(table, grid, diag8, n_steps)
    before = imex_cuda.iage_year_launches
    y_map = imex_cuda.build_iage_year(grid, diag8, source, span, n_steps,
                                      device=cuda_device, table=table)(y0)
    y_full = imex_cuda.build_iage_year(grid, diag8, source, span, n_steps,
                                       device=cuda_device, table=full)(y0)
    # without a table the year builds its own, of the two distinct slots
    tables = imex_cuda.iage_table_launches
    own = imex_cuda.build_iage_year(grid, diag8, source, span, n_steps,
                                    device=cuda_device)
    y_own = own(y0)
    torch.cuda.synchronize()
    assert imex_cuda.iage_year_launches == before + 3
    assert imex_cuda.iage_table_launches == tables + 1
    assert torch.isfinite(y_map).all()
    assert torch.equal(y_map, y_full)
    assert torch.equal(y_map, y_own)


def test_year_kernel_channel_map_matches_plain(cuda_device):
    """B1 under the map against the plain float32 year of the 8 channels,
    within the kernel's bound (5e-5 of max|y|)"""
    nz, ny = 40, 50
    grid, diag, diag8, source, span, y0 = _map_year_inputs(nz, ny,
                                                          cuda_device)
    table = imex_cuda.build_iage_table(grid, diag, span, 876,
                                       device=cuda_device)
    y_k = imex_cuda.build_iage_year(grid, diag8, source, span, 876,
                                    device=cuda_device, table=table)(y0)
    y_p = imex_cuda.build_iage_year_plain(grid, diag8, source, span, 876)(y0)
    assert float((y_k - y_p).abs().max()) / float(y_p.abs().max()) < TOL


def test_iage_kernel_year_operator_on_b1(cuda_device):
    """IageKernel.build_year_operator on the card probes through B1 on the
    kernel's one table (a launch a chunk, no new table), and the operator
    reproduces F and the JVP through B1 (the JAX test's 1e-5)"""
    nz, ny, n_steps, chunk = 8, 6, 24, 7
    kernel = IageKernel(*build_axes(nz, ny), MODELINFO, device=cuda_device,
                        n_steps=n_steps)
    years, tables = imex_cuda.iage_year_launches, imex_cuda.iage_table_launches
    op = kernel.build_year_operator(col_chunk=chunk)
    torch.cuda.synchronize()
    chunks = -(-nz * ny // chunk)
    assert imex_cuda.iage_year_launches == years + chunks + 1
    assert imex_cuda.iage_table_launches == tables
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0.0, 2.0, (2, nz, ny)),
                        dtype=torch.float32, device=cuda_device)
    v = torch.as_tensor(rng.standard_normal((2, nz, ny)),
                        dtype=torch.float32, device=cuda_device)
    for ours, ref in ((op.fcn(x), kernel.comp_fcn(x)),
                      (op.jvp(v), kernel.jvp(x, None, v))):
        assert float((ours - ref).abs().max()) / float(ref.abs().max()) < 1e-5


def _phosphorus_year(nz, ny, n_steps, device, years=1.0):
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=device,
                             dtype=torch.float32)
    light = phosphorus.light_lim_2d(depth, ypos, device=device,
                                    dtype=torch.float32)
    args = (grid, phosphorus.DEFAULT_PARAMS, light,
            (0.0, years * physics.SEC_PER_YEAR), n_steps)
    return (imex_cuda.build_phosphorus_year(*args, device=device),
            imex_cuda.build_phosphorus_year_plain(*args))


# the JAX tests' grid, phase 4's year, and a grid whose columns and levels
# divide into no lane group (53 columns: blocks of 14, 14, 14 and 11
# columns of 16 lanes, 37 levels: 3 a lane, the last partial) over the first
# tenth of the year at phase 4's hourly step
PHOSPHORUS_SHAPES = [(8, 6, 24, 1.0), (40, 50, 8760, 1.0), (37, 53, 876, 0.1)]


@pytest.mark.parametrize("nz, ny, n_steps, years", PHOSPHORUS_SHAPES)
def test_phosphorus_year_kernel_matches_plain(cuda_device, nz, ny, n_steps,
                                              years):
    """each tracer within TOL of its own largest value: dop and pop are
    held, not only the largest tracer"""
    year_k, year_p = _phosphorus_year(nz, ny, n_steps, cuda_device, years)
    rng = np.random.default_rng(9)
    y0 = torch.as_tensor(rng.uniform(0.0, 2.0, (3, nz, ny)), dtype=torch.float32,
                         device=cuda_device)
    y0[1:] *= torch.tensor([[[0.05]], [[0.01]]], device=cuda_device)

    before = imex_cuda.phosphorus_year_launches
    y_k = year_k(y0)
    torch.cuda.synchronize()
    assert imex_cuda.phosphorus_year_launches == before + 1
    y_p = year_p(y0)

    assert torch.isfinite(y_k).all()
    for tr in range(3):
        scale = float(y_p[tr].abs().max())
        assert float((y_k[tr] - y_p[tr]).abs().max()) / scale < TOL, tr


def test_phosphorus_year_kernel_deep_columns(cuda_device):
    """60 levels (4 a lane, the most the kernel takes) over the year's first
    219 hourly steps, each tracer against the plain float64 year: no
    further from it than the plain float32 year is.  In these deep, stiff
    columns float32 rounding in any order moves the year by ~1e-4 (on the
    CPU: the kernel's step in plain PyTorch 9.9e-5, 7.1e-5 and 2.9e-5 from
    float64 by tracer, the same with its table formed in float64 1.3e-4,
    5.8e-5 and 4.3e-5, the plain float32 PCR year 2.4e-4, 3.0e-4 and
    8.9e-5), so no float32 year is a yardstick for another here"""
    nz, ny, n_steps = 60, 50, 219
    depth, ypos = build_axes(nz, ny)
    span = (0.0, 0.025 * physics.SEC_PER_YEAR)
    args = {}
    for dtype in (torch.float32, torch.float64):
        grid = physics.make_grid(depth, ypos, MODELINFO, device=cuda_device,
                                 dtype=dtype)
        light = phosphorus.light_lim_2d(depth, ypos, device=cuda_device,
                                        dtype=dtype)
        args[dtype] = (grid, phosphorus.DEFAULT_PARAMS, light, span, n_steps)
    y0 = torch.as_tensor(np.random.default_rng(9).uniform(0.0, 2.0,
                                                          (3, nz, ny)),
                         dtype=torch.float32, device=cuda_device)
    y0[1:] *= torch.tensor([[[0.05]], [[0.01]]], device=cuda_device)
    y_k = imex_cuda.build_phosphorus_year(*args[torch.float32],
                                          device=cuda_device)(y0)
    torch.cuda.synchronize()
    y_32 = imex_cuda.build_phosphorus_year_plain(*args[torch.float32])(y0)
    y_64 = imex_cuda.build_phosphorus_year_plain(*args[torch.float64])(
        y0.double())
    assert torch.isfinite(y_k).all()
    for tr in range(3):
        scale = float(y_64[tr].abs().max())
        err_k = float((y_k[tr].double() - y_64[tr]).abs().max()) / scale
        err_32 = float((y_32[tr].double() - y_64[tr]).abs().max()) / scale
        assert err_k <= err_32, (tr, err_k, err_32)


def test_phosphorus_kernel_builds_one_table(cuda_device):
    """PhosphorusKernel's year runs on one table, built once; the year
    refuses a table of a nonzero diagonal or of another span"""
    nz, ny, n_steps = 8, 6, 24
    depth, ypos = build_axes(nz, ny)
    before = imex_cuda.iage_table_launches
    kernel = PhosphorusKernel(depth, ypos, MODELINFO, device=cuda_device,
                              n_steps=n_steps)
    assert imex_cuda.iage_table_launches == before + 1
    assert kernel.table.shape == (1, nz, ny)
    x = kernel.init_iterate()
    years = imex_cuda.phosphorus_year_launches
    fcn = kernel.comp_fcn(x)
    kernel.comp_fcn(x + 0.01)
    torch.cuda.synchronize()
    assert imex_cuda.phosphorus_year_launches == years + 2
    assert imex_cuda.iage_table_launches == before + 1
    ref = kernel._year_plain(x) - x
    assert float((fcn - ref).abs().max()) / float(x.abs().max()) < TOL

    grid = kernel.grid
    span = (0.0, physics.SEC_PER_YEAR)
    args = (grid, kernel.params, kernel.light_lim, span, n_steps)
    nonzero = imex_cuda.build_iage_table(
        grid, np.full((1, nz, ny), -1e-7), span, n_steps, device=cuda_device)
    other_span = imex_cuda.build_phosphorus_table(
        grid, (0.0, 0.5 * physics.SEC_PER_YEAR), n_steps, device=cuda_device)
    launches = imex_cuda.phosphorus_year_launches
    for table in (nonzero, other_span):
        with pytest.raises(ValueError, match="another year"):
            imex_cuda.build_phosphorus_year(*args, device=cuda_device,
                                            table=table)
    imex_cuda.build_phosphorus_year(*args, device=cuda_device,
                                    table=kernel.table)
    assert imex_cuda.phosphorus_year_launches == launches


def test_phosphorus_year_kernel_rejects_what_it_cannot_take(cuda_device):
    year, _ = _phosphorus_year(8, 6, 24, cuda_device)
    y0 = torch.ones((3, 8, 6), dtype=torch.float32, device=cuda_device)
    before = imex_cuda.phosphorus_year_launches
    for bad in (y0.double(), y0.cpu(), y0[:2], y0.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            year(bad)
    # no steps, a column of too many levels a lane
    with pytest.raises(ValueError, match="at least one step"):
        _phosphorus_year(8, 6, 0, cuda_device)
    with pytest.raises(ValueError, match="4 levels a lane"):
        _phosphorus_year(300, 6, 24, cuda_device)
    with pytest.raises(ValueError, match="4 levels a lane"):
        _phosphorus_year(75, 50, 24, cuda_device)
    assert imex_cuda.phosphorus_year_launches == before


def _transport3d_years(case, device, shape=(6, 12, 10), n_steps=480):
    """(kernel year, plain f32 year, y0) of a small 3D family year with a
    masked column and a nonzero vertical transport"""
    nz, nlat, nlon = shape
    mask = np.ones(shape, np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = synthetic.gen_circulation(nz, nlat, nlon, mask=mask,
                                     n_seasons=4 if case == "seasonal" else None)
    rng = np.random.default_rng(17)
    circ["WTT"] = rng.uniform(-2.0e9, 2.0e9, circ["WTT"].shape)
    specs = ABIO_SPECS if case == "coupled" else FAMILY_SPECS
    coef, kv, dz_r, diag, src, couple = family_year_inputs(
        circ, specs, adv_type="centered" if case == "centred" else "upwind3")
    args = (kv, dz_r, diag, src, (0.0, transport3d_cuda.SEC_PER_YEAR),
            n_steps)
    coef32 = {key: None if arr is None else arr.to(device, torch.float32)
              for key, arr in coef.items()}
    y0 = torch.as_tensor(rng.uniform(0.0, 1.0, (diag.shape[0],) + shape)
                         * (mask > 0), dtype=torch.float32, device=device)
    return (transport3d_cuda.build_transport3d_year(coef, *args, couple,
                                                    device=device),
            transport3d_cuda.build_transport3d_year_plain(coef32, *args,
                                                          couple),
            y0)


# B4's layouts on a 13 x 11 grid, which no tile divides evenly: the card's
# own plan (every tile resident, one block each), resident tiles of many
# columns (7 blocks), and tiles walked by 8 blocks with their state in
# device memory (2000 bytes of shared memory a block)
T3D_LAYOUTS = {"fit": {}, "ragged": {"max_blocks": 7},
               "walk": {"smem_limit": 2000, "max_blocks": 8}}


@pytest.mark.parametrize("layout", sorted(T3D_LAYOUTS))
@pytest.mark.parametrize("case", ["steady", "coupled", "seasonal", "centred"])
def test_transport3d_year_kernel_matches_plain(cuda_device, case, layout,
                                               monkeypatch):
    card_plan = transport3d_cuda._card_plan
    monkeypatch.setattr(
        transport3d_cuda, "_card_plan",
        lambda *args: card_plan(*args[:6], **T3D_LAYOUTS[layout]))
    year_k, year_p, y0 = _transport3d_years(case, cuda_device, (6, 13, 11))
    plan = year_k.plan
    assert plan.resident == (layout != "walk")
    if layout == "ragged":
        assert (13 % plan.ty or 11 % plan.tx) and plan.grid <= 7
    before = transport3d_cuda.transport3d_year_launches
    y_k = year_k(y0)
    torch.cuda.synchronize()
    assert transport3d_cuda.transport3d_year_launches == before + 1
    y_p = year_p(y0)

    assert torch.isfinite(y_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float((y_k - y0).abs().max()) / scale > 1e-3  # the year moved y
    assert float(y_k[:, :, 3, 2].abs().max()) == 0.0  # land stays dry


@pytest.mark.parametrize("case", ["steady", "coupled"])
def test_transport3d_year_kernel_at_the_spinup_example_grid(cuda_device,
                                                            case):
    """phase 12's one-shard grid, 10 x 24 x 20"""
    year_k, year_p, y0 = _transport3d_years(case, cuda_device, (10, 24, 20),
                                            n_steps=365)
    y_k = year_k(y0)
    y_p = year_p(y0)
    scale = float(y_p.abs().max())
    assert torch.isfinite(y_k).all()
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float(y_k[:, :, 3, 2].abs().max()) == 0.0


def test_transport3d_year_kernel_rejects_what_it_cannot_take(cuda_device):
    year, _, y0 = _transport3d_years("steady", cuda_device, n_steps=8)
    before = transport3d_cuda.transport3d_year_launches
    for bad in (y0.double(), y0.cpu(), y0[:1], y0.transpose(2, 3).contiguous()
                .transpose(2, 3)):
        with pytest.raises(ValueError):
            year(bad)
    assert transport3d_cuda.transport3d_year_launches == before


def test_transport3d_kernel_runs_the_cuda_year(cuda_device):
    """F and the JVP of a float32 state on the card go through the kernel"""
    circ = synthetic.gen_circulation(6, 12, 10)
    kernel = ShardedTransport3dKernel(circ, FAMILY_SPECS, 480,
                                      device=cuda_device)
    assert kernel.use_kernel
    x = kernel.init_iterate()
    before = transport3d_cuda.transport3d_year_launches
    fcn = kernel.comp_fcn(x)
    kernel.jvp(x, fcn, fcn)
    torch.cuda.synchronize()
    assert transport3d_cuda.transport3d_year_launches == before + 2


# the bench's four-module gx1 family (bench.py:1226-1233): rates of the
# assemble_rate_fields form, which the stream kernel rebuilds from factors
GX1_FAMILY_SPECS = [
    {"name": "t0"},
    {"name": "t1", "sink_rate_per_year": 1.0 / 50.0},
    {"name": "t2", "source_per_year": 1.0e-3, "sink_rate_per_year": 0.02},
    {"name": "t3", "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0},
]
STREAM_CASES = ("dense", "shed", "coupled", "seasonal", "stencil", "bf16",
                "family")


def _stream_years(case, device, shape):
    """(kernel year, plain f32 year, y0, mask) of a small stream year with
    masked columns, a nonzero vertical transport and the case's mode"""
    nz, nlat, nlon = shape
    mask = np.ones(shape, np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = synthetic.gen_circulation(
        nz, nlat, nlon, mask=mask, n_seasons=4 if case == "seasonal" else None)
    rng = np.random.default_rng(23)
    circ["WTT"] = rng.uniform(-2.0e9, 2.0e9, circ["WTT"].shape)
    n_steps = max(480, synthetic.stable_steps_per_year(circ))
    specs = ABIO_SPECS if case == "coupled" else FAMILY_SPECS
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, specs)
    wet = (mask > 0).astype(np.float64)
    t_dim = diag.shape[0]
    kwargs = {"couple": couple}
    if case in ("dense", "seasonal", "stencil"):
        diag = -rng.uniform(0.0, 1.0e-7, diag.shape) * wet.reshape(nz, -1)
        src = rng.uniform(0.0, 1.0e-8, src.shape) * wet.reshape(nz, -1)
    if case == "shed":
        diag = src = None
        kwargs.update(recip_area=1.0 / circ["TAREA"], recip_dz=1.0 / circ["dz"],
                      t_dim=t_dim)
    if case in ("stencil", "bf16"):
        kwargs.update(stencil=True, coef_bf16=case == "bf16")
    if case == "family":
        diag, src, _ = assemble_rate_fields(
            GX1_FAMILY_SPECS, wet.reshape(nz, -1), float(circ["dz"][0]),
            transport3d_cuda.SEC_PER_YEAR)
        t_dim = diag.shape[0]
    args = (kv, dz_r, diag, src, (0.0, transport3d_cuda.SEC_PER_YEAR), n_steps)
    year_k = transport3d_stream_cuda.build_transport3d_year_stream(
        coef, *args, **kwargs, device=device)
    year_p = transport3d_stream_cuda.build_transport3d_year_stream_plain(
        {key: None if arr is None else arr.to(device)
         for key, arr in coef.items()},
        *args, **kwargs, dtype=torch.float32)
    y0 = torch.as_tensor(rng.uniform(0.0, 1.0, (t_dim,) + shape) * wet,
                         dtype=torch.float32, device=device)
    return year_k, year_p, y0, mask


@pytest.mark.parametrize("shape", [(4, 8, 6), (6, 37, 45), (60, 20, 36)])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_year_kernel_matches_plain(cuda_device, case, shape):
    """every mode of B5's fused step on a grid narrower than one tile
    (4 x 8 x 6: the longitude wraps several times inside a tile, and the
    rings load synchronously), on ragged tiles in latitude and longitude
    (6 x 37 x 45) and at gx1's 60 levels (the sweep factor of every level in
    shared memory, the rings staged by cp.async)"""
    year_k, year_p, y0, mask = _stream_years(case, cuda_device, shape)
    assert year_k.stream_diag == (case in ("dense", "seasonal", "stencil"))
    before = transport3d_stream_cuda.transport3d_stream_launches
    y_k = year_k(y0)
    torch.cuda.synchronize()
    assert transport3d_stream_cuda.transport3d_stream_launches == before + 1
    y_p = year_p(y0)

    assert y_k.dtype == torch.float32 and torch.isfinite(y_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float((y_k - y0).abs().max()) / scale > 1e-3  # the year moved y
    land = torch.as_tensor(mask == 0, device=cuda_device)
    assert float(y_k[:, land].abs().max()) == 0.0  # land stays dry


def test_stream_year_kernel_rejects_what_it_cannot_take(cuda_device):
    year, _, y0, _ = _stream_years("dense", cuda_device, (4, 8, 6))
    before = transport3d_stream_cuda.transport3d_stream_launches
    for bad in (y0.cpu(), y0[:1], y0.to(torch.int32), y0.cpu().numpy()):
        with pytest.raises((ValueError, TypeError)):
            year(bad)
    assert transport3d_stream_cuda.transport3d_stream_launches == before
    # a float64 state is cast to float32, as the JAX kernel casts it
    assert torch.equal(year(y0.double()), year(y0))
    # a coupled family whose surface states overflow one block's shared
    # memory is refused before any launch
    coef, kv, dz_r, _, _, _ = family_year_inputs(
        synthetic.gen_circulation(4, 8, 6), FAMILY_SPECS)
    t_dim = 96
    couple = np.zeros((t_dim, t_dim))
    couple[1, 0] = 1.0e-6
    with pytest.raises(ValueError, match="shared memory"):
        transport3d_stream_cuda.build_transport3d_year_stream(
            coef, kv, dz_r, None, None, (0.0, transport3d_cuda.SEC_PER_YEAR),
            480, couple=couple, t_dim=t_dim, device=cuda_device)


def _b3_window(c_dim, nz, nx, profile, noise=2.0, seed=29):
    """one closed window's static arrays for B3 and (y0, comp0): faces zero
    at the window's edges, restoring diag, uniform rates or surface-only
    depth profiles; y0 the initial iterate's depth profile plus uniform
    noise of amplitude `noise`"""
    depth, ypos = build_axes(nz, nx)
    grid = physics.make_grid(depth, ypos, MODELINFO, device="cpu",
                             dtype=torch.float32)
    vf = grid.vvel.numpy().copy()
    vf[:, 0] = vf[:, -1] = 0.0
    hf = np.zeros((nz, nx + 1), np.float32)
    hf[:, 1:-1] = grid.horiz_mix_coeff.numpy()
    rng = np.random.default_rng(seed)
    diag = np.zeros((c_dim, nz, nx), np.float32)
    diag[:, 0, :] = -surf_restore_rate(depth)
    if profile:
        source = np.zeros((c_dim, nz))
        source[:, 0] = rng.uniform(0.5, 2.0, c_dim) / (10.0 * 86400.0)
    else:
        source = rng.uniform(0.5, 2.0, c_dim) / physics.SEC_PER_YEAR
    bld_max = np.interp(grid.ypos_mid.double().numpy(), physics._BLD_YPOS,
                        physics._BLD_MAX)
    args = (vf, hf, grid.wvel.numpy(), diag, source, bld_max,
            grid.dy_r.numpy(), grid.dz_r.numpy(), grid.dz_mid.numpy(),
            grid.dz_mid_r.numpy(), grid.depth_mid.numpy())
    column = np.interp(depth.mid, [55.0, 200.0], [0.0, 2.0])
    y0 = column[None, :, None] + noise * rng.uniform(0.0, 1.0,
                                                     (c_dim, nz, nx))
    c0 = rng.uniform(-1e-7, 1e-7, (c_dim, nz, nx))
    return args, y0, c0


def _on(device, *arrs):
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrs]


@pytest.mark.parametrize("c_dim, nz, nx, j_steps, profile, noise, steps", [
    (4, 10, 20, 2, False, 2.0, 2920),
    (2, 24, 80, 8, True, 2.0, 2920),
    (3, 40, 300, 5, False, 2.0, 2920),
    (2, 256, 60, 3, False, 1e-3, 12615),
    (2, 256, 60, 3, True, 1e-3, 12615),
])
@pytest.mark.parametrize("t_start", [0.0, 1.3e7])
def test_step_block_kernel_matches_plain(cuda_device, c_dim, nz, nx, j_steps,
                                         profile, noise, steps, t_start):
    """B3 against its plain version on all nx columns, in the shallow
    season and in the deep mixed layer; nz = 256 takes tiles and one step
    a launch.  Its surface layers are 1.6 m thick: noise there makes the CN
    right-hand sides some 1e4 times the state, and float32 Thomas and PCR
    then part by ~1e-4, so at 256 levels it starts nearly smooth and takes
    the bench's step there (12,615 a year), as phase 9's year does"""
    args, y0, c0 = _b3_window(c_dim, nz, nx, profile, noise)
    dt = physics.SEC_PER_YEAR / steps
    y, c = _on(cuda_device, y0, c0)
    block = imex_block_cuda.build_iage_step_block(*args, dt, j_steps,
                                                  device=cuda_device)
    before = imex_block_cuda.iage_block_launches
    y_k, c_k = block(y, c, t_start)
    torch.cuda.synchronize()
    assert imex_block_cuda.iage_block_launches - before == 1
    y_p, c_p = imex_block_cuda.build_iage_step_block_plain(
        *args, dt, j_steps, device=cuda_device)(y, c, t_start)
    assert torch.isfinite(y_k).all() and torch.isfinite(c_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float(((y_k + c_k) - (y_p + c_p)).abs().max()) / scale < TOL
    assert float((y_k - y).abs().max()) / scale > 1e-5  # the block moved y


@pytest.mark.parametrize("nx, smem_columns, plan", [
    (20, 20, (1, 16)),   # tiles of 16 and a ragged 4; a step an interval
    (50, 24, (2, 16)),   # three tiles of 16 and a ragged 2; two steps
])
def test_step_block_tiles_and_split_steps_match_one_block(
        cuda_device, nx, smem_columns, plan):
    """a shared-memory budget that forces shorter intervals between halo
    exchanges gives, on every column, exactly what the card's own plan
    gives: the halo's error never reaches an owned column"""
    c_dim, nz, j_steps = 3, 10, 4
    args, y0, c0 = _b3_window(c_dim, nz, nx, False)
    dt = physics.SEC_PER_YEAR / 2920
    y, c = _on(cuda_device, y0, c0)
    whole = imex_block_cuda.build_iage_step_block(*args, dt, j_steps,
                                                  device=cuda_device)
    assert whole.plan == (4, 16)
    limit = imex_block_cuda._library().iage_block_smem_bytes(nz,
                                                             smem_columns)
    tiled = imex_block_cuda.build_iage_step_block(
        *args, dt, j_steps, device=cuda_device, smem_limit=limit)
    assert tiled.plan == plan
    y_w, c_w = whole(y, c, 1.0e7)
    y_t, c_t = tiled(y, c, 1.0e7)
    torch.cuda.synchronize()
    assert torch.equal(y_t, y_w) and torch.equal(c_t, c_w)


def test_step_block_kernel_rejects_what_it_cannot_take(cuda_device):
    args, y0, c0 = _b3_window(2, 8, 12, False)
    block = imex_block_cuda.build_iage_step_block(*args, 100.0, 2,
                                                  device=cuda_device)
    y, c = _on(cuda_device, y0, c0)
    before = imex_block_cuda.iage_block_launches
    for bad in (y.double(), y.cpu(), y[:1], y.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            block(bad, c, 0.0)
    assert imex_block_cuda.iage_block_launches == before


def test_blocked_year_kernel_matches_plain_and_one_shard(cuda_device):
    """the blocked year on B3 against the same year on B3's plain version,
    and four shards on the one card against one"""
    nz, ny, n_steps, k = 12, 32, 73, 3
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((2, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    aging = np.full((2, 2), 1.0 / physics.SEC_PER_YEAR, np.float32)
    args = (depth, ypos, MODELINFO, diag, aging,
            (0.0, physics.SEC_PER_YEAR), n_steps)
    y0 = torch.as_tensor(np.random.default_rng(31).uniform(
        0.0, 2.0, (2, 2, nz, ny)), dtype=torch.float32, device=cuda_device)
    one = port_mesh.make_mesh(1, 1, devices=[cuda_device])
    four = port_mesh.make_mesh(1, 4, devices=[cuda_device] * 4)
    before = imex_block_cuda.iage_block_launches
    y1 = build_sharded_year_blocked(one, *args, block_steps=k)(y0)
    torch.cuda.synchronize()
    # the year's interior in one launch
    assert imex_block_cuda.iage_block_launches - before == 1
    y_p = build_sharded_year_blocked_plain(one, *args, block_steps=k)(y0)
    y4 = build_sharded_year_blocked(four, *args, block_steps=k)(y0)
    scale = float(y_p.abs().max())
    assert torch.isfinite(y1).all() and y1.device == y0.device
    assert float((y1 - y_p).abs().max()) / scale < TOL
    assert float((y4 - y1).abs().max()) / scale < TOL


@pytest.mark.parametrize("nz, n_steps, k", [(24, 30, 4), (256, 20, 3)])
@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 4), (1, 8)])
def test_blocked_year_one_launch_matches_per_shard_launches(
        cuda_device, shape, nz, n_steps, k):
    """every shard of the card in one launch for the year's interior, bit
    for bit the year whose shards each run their own launch a block of k
    steps with host-filled ghost slabs (as shards on different cards do),
    with a remainder block"""
    ny = 64
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    batch = shape[0]
    diag = np.zeros((batch, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    aging = np.full((batch, 2), 1.0 / physics.SEC_PER_YEAR, np.float32)
    span = (0.0, n_steps * physics.SEC_PER_YEAR / 2920.0)
    args = (depth, ypos, MODELINFO, diag, aging, span, n_steps)
    assert (n_steps - 1) % k
    mesh = port_mesh.make_mesh(*shape, devices=[cuda_device] * (shape[0]
                                                               * shape[1]))
    y0 = torch.as_tensor(np.random.default_rng(43).uniform(
        0.0, 2.0, (batch, 2, nz, ny)), dtype=torch.float32, device=cuda_device)
    before = imex_block_cuda.iage_block_launches
    y_one = build_sharded_year_blocked(mesh, *args, block_steps=k)(y0)
    torch.cuda.synchronize()
    assert imex_block_cuda.iage_block_launches - before == 1
    before = imex_block_cuda.iage_block_launches
    # a launch group a shard, as if each shard lay on its own card
    y_each = sharded_year._build_blocked(
        mesh, *args, k, True, group_of=lambda mi, sj, dev: (mi, sj))(y0)
    torch.cuda.synchronize()
    n_shards = shape[0] * shape[1]
    # one shard alone has no ghost slabs: its interior is one launch
    per_shard = 1 if n_shards == 1 else n_shards * -(-(n_steps - 1) // k)
    assert imex_block_cuda.iage_block_launches - before == per_shard
    assert torch.isfinite(y_one).all()
    assert torch.equal(y_one, y_each)


def test_blocked_year_kernel_deep_columns_from_noise(cuda_device):
    """B3's blocked year at 256 levels from seeded noise (phase 9's rough
    check on 64 columns and 300 steps of the bench's 12,615 a year)
    against the float64 per-step year: the column solves in float64 keep
    it within phase 9's 5e-5 of max|y|"""
    nz, ny, n_steps = 256, 64, 300
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((1, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    span = (0.0, n_steps * physics.SEC_PER_YEAR / 12615.0)
    one = port_mesh.make_mesh(1, 1, devices=[cuda_device])
    y0 = torch.as_tensor(np.random.default_rng(61).standard_normal(
        (1, 2, nz, ny)), dtype=torch.float32, device=cuda_device)
    args = (depth, ypos, MODELINFO, diag, np.zeros((1, 2), np.float32), span,
            n_steps)
    before = imex_block_cuda.iage_block_launches
    y_k = build_sharded_year_blocked(one, *args, block_steps=8)(y0)
    torch.cuda.synchronize()
    assert imex_block_cuda.iage_block_launches > before
    y_64 = build_sharded_year(
        one, ShardedYearData(depth, ypos, MODELINFO, 1), diag,
        np.zeros((1, 2, 1, 1)), span, n_steps)(y0.double())
    y_p = build_sharded_year_blocked_plain(one, *args, block_steps=8)(y0)
    scale = float(y_64.abs().max())
    assert torch.isfinite(y_k).all()
    assert float((y_k.double() - y_64).abs().max()) / scale < 5e-5
    assert float((y_p.double() - y_64).abs().max()) / scale < 5e-5


def test_sharded_iage_kernel_runs_b3(cuda_device):
    """F and the JVP of the family kernel's float32 state go through B3"""
    depth, ypos = build_axes(8, 8)
    kernel = ShardedIageKernel(
        port_mesh.make_mesh(1, 2, devices=[cuda_device] * 2), depth, ypos,
        MODELINFO, (1.0 + 0.25 * np.arange(4)) / physics.SEC_PER_YEAR,
        n_steps=36, use_kernel=True, block_steps=2)
    x = kernel.init_iterate()
    assert x.device == cuda_device and x.dtype == torch.float32
    before = imex_block_cuda.iage_block_launches
    fcn = kernel.comp_fcn(x)
    kernel.jvp(x, fcn, fcn)
    torch.cuda.synchronize()
    # both shards of the card and the year's interior in one launch a year
    assert imex_block_cuda.iage_block_launches - before == 2


# B6's cases: upwind3 with dense and factored rates, the float32 stencil,
# and a seasonal circulation with the surface coupling (k = 1 only)
SWEEP_CASES = ("dense", "factored", "stencil", "seasonal_coupled")


def _sweep_years(case, n_space, k, device, shape=(4, 32, 40)):
    """(kernel year on n_space shards of the card, the same year through
    stream_sweep_plain, y0, mask): a grid whose 40 longitudes take a ragged
    tile, masked columns, a nonzero vertical transport"""
    nz, nlat, nlon = shape
    mask = np.ones(shape, np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 17, 33] = 0
    seasonal = case == "seasonal_coupled"
    circ = synthetic.gen_circulation(nz, nlat, nlon, mask=mask,
                                     n_seasons=4 if seasonal else None)
    rng = np.random.default_rng(41)
    circ["WTT"] = rng.uniform(-2.0e9, 2.0e9, circ["WTT"].shape)
    n_steps = 2 * max(240, -(-synthetic.stable_steps_per_year(circ) // 2))
    coef, kv, dz_r, diag, src, couple = family_year_inputs(
        circ, ABIO_SPECS if seasonal else FAMILY_SPECS)
    wet = (mask > 0).astype(np.float64)
    if case in ("dense", "stencil"):
        diag = -rng.uniform(0.0, 1.0e-7, diag.shape) * wet.reshape(nz, -1)
        src = rng.uniform(0.0, 1.0e-8, src.shape) * wet.reshape(nz, -1)
    kwargs = dict(block_rows=8, steps_per_sweep=k, couple=couple,
                  stencil=case == "stencil")
    if case == "factored":
        kwargs.update(recip_area=1.0 / circ["TAREA"], recip_dz=1.0 / circ["dz"])
    args = (coef, kv, dz_r, diag, src, (0.0, transport3d_cuda.SEC_PER_YEAR),
            n_steps)
    mesh = port_mesh.make_mesh(1, n_space, devices=[device] * n_space)
    year_k = build_sharded_transport3d_year_stream(mesh, *args, **kwargs)
    year_p = build_sharded_transport3d_year_stream(mesh, *args, **kwargs,
                                                   plain=True)
    y0 = torch.as_tensor(rng.uniform(0.0, 1.0, (diag.shape[0],) + shape)
                         * wet, dtype=torch.float32)
    return year_k, year_p, y0, mask


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n_space", [1, 2, 4])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_sweep_year_kernel_matches_plain(cuda_device, case, n_space, k):
    """B6's sharded year on 1, 2 and 4 shards of the card against the same
    year through the plain sweep; a halo one row short would show here,
    at k = 2 on shards with neighbours"""
    if case == "seasonal_coupled" and k != 1:
        pytest.skip("a seasonal year streams one step a sweep")
    year_k, year_p, y0, mask = _sweep_years(case, n_space, k, cuda_device)
    y0 = y0.to(cuda_device)
    assert year_k.stream_diag == (case in ("dense", "stencil"))
    before = transport3d_sweep_cuda.transport3d_sweep_launches
    y_k = year_k(y0)
    torch.cuda.synchronize()
    assert (transport3d_sweep_cuda.transport3d_sweep_launches - before
            == n_space * year_k.n_sweeps)
    y_p = year_p(y0)
    assert y_k.device == cuda_device and torch.isfinite(y_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float((y_k - y0).abs().max()) / scale > 1e-3  # y moved
    land = torch.as_tensor(mask == 0, device=cuda_device)
    assert float(y_k[:, land].abs().max()) == 0.0  # land stays dry


def test_sweep_kernel_on_one_shard_is_b5(cuda_device):
    """one shard at k = 1 repeats B5's arithmetic on the same inputs"""
    nz, nlat, nlon = 6, 32, 40
    circ = synthetic.gen_circulation(nz, nlat, nlon)
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    args = (coef, kv, dz_r, None, None, (0.0, transport3d_cuda.SEC_PER_YEAR),
            480)
    factors = {"recip_area": 1.0 / circ["TAREA"], "recip_dz": 1.0 / circ["dz"],
               "t_dim": 1}
    y0 = torch.as_tensor(np.random.default_rng(43).uniform(
        0.0, 1.0, (1, nz, nlat, nlon)) * (circ["mask"] > 0),
        dtype=torch.float32, device=cuda_device)
    y5 = transport3d_stream_cuda.build_transport3d_year_stream(
        *args, **factors, device=cuda_device)(y0)
    y6 = build_sharded_transport3d_year_stream(
        port_mesh.make_mesh(1, 1, devices=[cuda_device]), *args,
        block_rows=8, **factors)(y0)
    assert float((y6 - y5).abs().max()) <= 1e-6 * float(y5.abs().max())


def test_sweep_kernel_rejects_what_it_cannot_take(cuda_device):
    """wrong device, dtype, shape or steps raise before any launch"""
    year, _, y0, _ = _sweep_years("dense", 2, 1, cuda_device)
    sweep = year.sweeps[0]
    shape = (y0.shape[0], y0.shape[1], y0.shape[2] // 2 + 2 * year.halo,
             y0.shape[3])
    y, c, spare = (torch.zeros(shape, device=cuda_device) for _ in range(3))
    before = transport3d_sweep_cuda.transport3d_sweep_launches
    for bad in (y.cpu(), y.double(), y[:, :, 1:], y.transpose(2, 3)
                .contiguous().transpose(2, 3)):
        with pytest.raises(ValueError):
            sweep(bad, c, spare, 0)
    with pytest.raises(ValueError, match="outside"):
        sweep(y, c, spare, year.n_sweeps * 10)
    with pytest.raises(ValueError):
        year(y0.numpy())
    assert transport3d_sweep_cuda.transport3d_sweep_launches == before


@pytest.mark.parametrize("n_y, n_x", [(4, None), (2, 2)])
def test_per_step_sharded_year_replays_on_the_card(cuda_device, n_y, n_x):
    """the per-step sharded year on shards of the card (one step captured
    in a CUDA graph and replayed) against the same year on CPU shards, in
    float64, seasonal and coupled"""
    nz, nlat, nlon = 4, 16, 12
    circ = synthetic.gen_circulation(nz, nlat, nlon, n_seasons=4)
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, ABIO_SPECS)
    args = (coef, kv, dz_r, diag, src, (0.0, transport3d_cuda.SEC_PER_YEAR),
            synthetic.stable_steps_per_year(circ), couple)
    y0 = torch.as_tensor(np.random.default_rng(47).uniform(
        0.0, 1.0, (2, nz, nlat, nlon)) * (circ["mask"] > 0))
    n = n_y * (n_x or 1)
    card = build_sharded_transport3d_year(port_mesh.make_mesh(
        1, n_y, devices=[cuda_device] * n, n_space_x=n_x), *args)
    cpu = build_sharded_transport3d_year(port_mesh.make_mesh(
        1, n_y, devices=["cpu"] * n, n_space_x=n_x), *args)
    y_card = card(y0.to(cuda_device))
    y_cpu = cpu(y0)
    assert y_card.device == cuda_device and y_card.dtype == torch.float64
    scale = float(y_cpu.abs().max())
    assert float((y_card.cpu() - y_cpu).abs().max()) <= 1e-12 * scale
    assert float((y_cpu - y0).abs().max()) > 1e-3 * scale  # the year moved y


# -- B7: k steps on a halo-extended latitude block ----------------------------

def _b7_window(nz, nlat, nlon, seed=53, land=()):
    """a (2, nz, nlat, nlon) window of a synthetic circulation, its
    coefficient stack and CN bands (float32, on the CPU), a rough state and
    a non-zero carry, rate fields and a coupling; the window is the whole
    grid, so its selectors are the ones B7 derives from wet.  land: more
    dry columns (row, column)"""
    mask = np.ones((nz, nlat, nlon), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, nlat - 5, nlon - 3] = 0
    for j, i in land:
        mask[:, j, i] = 0
    circ = synthetic.gen_circulation(nz, nlat, nlon, mask=mask)
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    names = [n for n, a in sorted(coef.items()) if a is not None]
    dlb, dub = transport3d_cuda._cn_bands(kv.numpy(), dz_r.numpy(), nz, nlat,
                                          nlon)
    wet = (mask > 0).astype(np.float64)
    rng = np.random.default_rng(seed)
    shape = (2, nz, nlat, nlon)

    def f32(arr):
        return torch.as_tensor(np.asarray(arr), dtype=torch.float32)

    return {
        "names": names, "wet": wet,
        "dt": transport3d_cuda.SEC_PER_YEAR
        / synthetic.stable_steps_per_year(circ),
        "stack": f32(torch.stack([coef[n] for n in names])),
        "dlb": f32(dlb), "dub": f32(dub),
        "y": f32(rng.uniform(0.0, 1.0, shape) * wet),
        "c": f32(rng.uniform(-1.0e-7, 1.0e-7, shape) * wet),
        "diag": f32(-rng.uniform(0.0, 1.0e-6, shape) * wet),
        "src": f32(rng.uniform(0.0, 1.0e-8, shape) * wet),
        "diag_fac": ([-2.0e-8, 0.0], [-3.0e-7, -1.0e-7]),
        "src_fac": ([1.0e-9, 3.0e-9], [0.0, 2.0e-9]),
        "couple": np.array([[-3.0e-7, 2.0e-7], [0.0, -1.0e-7]]),
    }


def _b7_call(w, k, rates, coupled, device, **kwargs):
    """(kernel fn or plain fn, its operands) for one B7 case"""
    kw = dict(has_diag=rates != "none", has_src=rates != "none",
              couple=w["couple"] if coupled else None)
    extras = []
    if rates == "factored":
        kw.update(diag_fac=w["diag_fac"], src_fac=w["src_fac"])
    elif rates == "dense":
        extras = [w["diag"], w["src"]]
    t_dim, nz, rows, nlon = w["y"].shape
    fn = transport3d_block_cuda.build_block3d_steps(
        w["names"], nz, rows, nlon, t_dim, w["dt"], k, **kw, device=device,
        **kwargs)
    ops = [w[key].to(device) for key in ("y", "c", "stack", "dlb", "dub")]
    return fn, ops + [e.to(device) for e in extras]


@pytest.mark.parametrize("nz, k, rates, coupled", [
    (3, 1, "none", False), (3, 2, "factored", True), (3, 4, "dense", True),
    (60, 1, "dense", False), (60, 2, "factored", True), (60, 4, "none", False),
])
def test_block3d_kernel_matches_plain(cuda_device, nz, k, rates, coupled):
    """B7 against block3d_steps_plain on the card, over the whole window
    (its edge rows included: both read zeros past it), from a rough state
    and a non-zero carry"""
    w = _b7_window(nz, 24, 40)
    fn, ops = _b7_call(w, k, rates, coupled, cuda_device)
    plain = transport3d_block_cuda.block3d_steps_plain(
        w["names"], nz, 24, 40, 2, w["dt"], k, has_diag=rates != "none",
        has_src=rates != "none",
        diag_fac=w["diag_fac"] if rates == "factored" else None,
        src_fac=w["src_fac"] if rates == "factored" else None,
        couple=w["couple"] if coupled else None)
    before = transport3d_block_cuda.transport3d_block_launches
    y_k, c_k = fn(*ops)
    torch.cuda.synchronize()
    # the k steps in one cooperative launch
    assert transport3d_block_cuda.transport3d_block_launches - before == 1
    y_p, c_p = plain(*ops)
    scale = float(y_p.abs().max())
    assert torch.isfinite(y_k).all()
    assert float((y_k - y_p).abs().max()) / scale < TOL
    assert float(((y_k + c_k) - (y_p + c_p)).abs().max()) / scale < TOL
    assert float((y_k - ops[0]).abs().max()) / scale > 1e-3  # y moved
    land = torch.as_tensor(w["wet"] == 0.0, device=cuda_device)
    assert float(y_k[:, land].abs().max()) == 0.0


@pytest.mark.parametrize("coupled", [False, True])
def test_block3d_tiles_and_split_steps_match_one_block(cuda_device, coupled):
    """k steps in one cooperative launch give, on every cell, exactly what
    k launches of one step give; and several shards' windows in one launch
    (ragged tiles, more tiles than co-resident blocks) exactly what each
    gives alone"""
    w = _b7_window(3, 20, 24)
    whole, ops = _b7_call(w, 4, "factored", coupled, cuda_device)
    one, _ = _b7_call(w, 1, "factored", coupled, cuda_device)
    y_w, c_w = whole(*ops)
    y_s, c_s = ops[0], ops[1]
    for _ in range(4):
        y_s, c_s = one(y_s, c_s, *ops[2:])
    torch.cuda.synchronize()
    assert torch.equal(y_s, y_w) and torch.equal(c_s, c_w)
    wins = [_b7_window(3, 20, 24, seed) for seed in (53, 54, 55)]
    calls = [[wn[key].to(cuda_device)
              for key in ("y", "c", "stack", "dlb", "dub")] for wn in wins]
    before = transport3d_block_cuda.transport3d_block_launches
    together = whole.many(calls)
    torch.cuda.synchronize()
    assert transport3d_block_cuda.transport3d_block_launches - before == 1
    for call, (y_t, c_t) in zip(calls, together):
        y_a, c_a = whole(*call)
        assert torch.equal(y_t, y_a) and torch.equal(c_t, c_a)


def test_block3d_kernel_rejects_what_it_cannot_take(cuda_device):
    """wrong device, dtype, shape or layout raise before any launch; a
    block that cannot hold one cell is refused, naming the limit and B6"""
    w = _b7_window(3, 16, 12)
    fn, ops = _b7_call(w, 2, "none", False, cuda_device)
    y, c = ops[:2]
    before = transport3d_block_cuda.transport3d_block_launches
    for bad in (y.cpu(), y.double(), y[:, :, 1:], y.transpose(2, 3)
                .contiguous().transpose(2, 3)):
        with pytest.raises(ValueError):
            fn(bad, c, *ops[2:])
    with pytest.raises(ValueError, match="coefficient operands"):
        fn(*ops, ops[0])
    assert transport3d_block_cuda.transport3d_block_launches == before
    names = w["names"]
    with pytest.raises(ValueError, match="shared memory.*year_stream"):
        transport3d_block_cuda.build_block3d_steps(
            names, 60, 392, 320, 96, 100.0, 1, couple=np.zeros((96, 96)),
            device=cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        fn(*ops, sel=torch.zeros(ops[2].shape[1:], device=cuda_device))
    assert transport3d_block_cuda.transport3d_block_launches == before
    # the fused step's tile and shared memory (rings, face tiles, carries,
    # and when coupled a tracer's surface stage states), the same in the
    # three libraries that build it; tests/test_torch_block3d.py's
    # schedule tests take these numbers
    lib = transport3d_block_cuda._library()
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    lib.transport3d_block_tile(ctypes.byref(rows), ctypes.byref(cols))
    assert (rows.value, cols.value) == transport3d_sweep_cuda.step_tile() \
        == (16, 32)
    for t_dim, coupled in ((1, 0), (2, 1), (4, 1), (4, 0)):
        smem = 4 * (25608 + (512 * t_dim if coupled else 0))
        assert lib.transport3d_block_smem_bytes(t_dim, coupled) == smem
        assert transport3d_stream_cuda._library().transport3d_stream_smem_bytes(
            t_dim, coupled) == smem
        assert transport3d_sweep_cuda._library().transport3d_sweep_smem_bytes(
            t_dim, coupled) == smem
    assert lib.transport3d_block_max_shards() == transport3d_block_cuda.MAX_SHARDS


def test_block3d_kernel_selectors_follow_each_stack(cuda_device):
    """one fn called on freshly allocated coefficient stacks with different
    wet masks (the caching allocator may hand the second the first's
    address) reads each stack's own selectors, as the plain version does;
    selectors passed as sel give the same bits"""
    fn = None
    for land in ((), ((10, 7), (11, 7), (5, 30)), ((0, 0), (23, 39))):
        w = _b7_window(3, 24, 40, land=land)
        fn_w, ops = _b7_call(w, 2, "factored", True, cuda_device)
        fn = fn or fn_w
        plain = transport3d_block_cuda.block3d_steps_plain(
            w["names"], 3, 24, 40, 2, w["dt"], 2, has_diag=True,
            has_src=True, diag_fac=w["diag_fac"], src_fac=w["src_fac"],
            couple=w["couple"])
        y_k, c_k = fn(*ops)
        y_s, c_s = fn(*ops, sel=transport3d_stream_cuda.pack_selectors(
            ops[2][w["names"].index("wet")]))
        torch.cuda.synchronize()
        y_p, _ = plain(*ops)
        assert torch.equal(y_k, y_s) and torch.equal(c_k, c_s)
        assert float((y_k - y_p).abs().max()) / float(y_p.abs().max()) < TOL
        land_mask = torch.as_tensor(w["wet"] == 0.0, device=cuda_device)
        assert float(y_k[:, land_mask].abs().max()) == 0.0
        del ops, y_k, c_k, y_s, c_s


@pytest.mark.parametrize("n_space, k", [(2, 1), (4, 1), (8, 1), (4, 2),
                                        (2, 3)])
def test_blocked_3d_year_kernel_matches_plain_and_one_shard(cuda_device,
                                                            n_space, k):
    """the blocked 3D year on n shards of the card against 1 shard (JAX's
    contract, 1e-6) and against the same mesh through block3d_steps_plain;
    8 shards at k = 1 and 4 at k = 2 have shards of exactly 4 k rows, where
    B7's selectors, derived from the slab's wet mask, must still be exact;
    the coupled pair with factored rates, many blocks from a carry"""
    nz, nlat, nlon = 4, 32, 40
    circ = synthetic.gen_circulation(nz, nlat, nlon)
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, ABIO_SPECS)
    n_steps = synthetic.stable_steps_per_year(circ)
    args = (coef, kv, dz_r, diag, src, (0.0, transport3d_cuda.SEC_PER_YEAR),
            n_steps)
    y0 = torch.as_tensor(np.random.default_rng(59).uniform(
        0.0, 1.0, (2, nz, nlat, nlon)) * (circ["mask"] > 0),
        dtype=torch.float32, device=cuda_device)

    def mesh(n):
        return port_mesh.make_mesh(1, n, devices=[cuda_device] * n)

    one = build_sharded_transport3d_year_blocked(mesh(1), *args,
                                                 block_steps=k, couple=couple)
    many = build_sharded_transport3d_year_blocked(
        mesh(n_space), *args, block_steps=k, couple=couple)
    before = transport3d_block_cuda.transport3d_block_launches
    y_n = many(y0)
    torch.cuda.synchronize()
    launches = transport3d_block_cuda.transport3d_block_launches - before
    m_blocks, r_steps = divmod(n_steps - 1, k)
    # every shard of the card in one launch a block
    assert launches == many.launches == m_blocks + (r_steps > 0)
    assert many.smem_bytes > 0
    y_1 = one(y0)
    y_p = build_sharded_transport3d_year_blocked(
        mesh(n_space), *args, block_steps=k, couple=couple, plain=True)(y0)
    scale = float(y_p.abs().max())
    assert y_n.device == cuda_device and torch.isfinite(y_n).all()
    assert float((y_n - y_1).abs().max()) / scale <= 1e-6
    assert torch.equal(y_n, y_1)  # each interior cell's arithmetic is one
    assert float((y_n - y_p).abs().max()) / scale < TOL
    assert float((y_n * torch.as_tensor(circ["mask"] == 0,
                                        device=cuda_device)).abs().max()) == 0


# -- B1v1: the iage year with PCR column solves --------------------------------

@pytest.mark.parametrize("nz, ny, n_steps, years", IAGE_SHAPES)
@pytest.mark.parametrize("aging", [True, False])
def test_iage_year_v1_kernel_matches_plain_and_b1(cuda_device, nz, ny,
                                                  n_steps, years, aging):
    grid, diag = _setup(nz, ny, cuda_device)
    source = np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR if aging else 0.0)
    span = (0.0, years * physics.SEC_PER_YEAR)
    y0 = torch.as_tensor(np.random.default_rng(7).uniform(0.0, 2.0,
                                                          (2, nz, ny)),
                         dtype=torch.float32, device=cuda_device)
    before = imex_cuda.iage_year_v1_launches
    y_v1 = imex_cuda.build_iage_year_v1(grid, diag, source, span, n_steps,
                                        device=cuda_device)(y0)
    torch.cuda.synchronize()
    assert imex_cuda.iage_year_v1_launches == before + 1
    y_b1 = imex_cuda.build_iage_year(grid, diag, source, span, n_steps,
                                     device=cuda_device)(y0)
    y_p = imex_cuda.build_iage_year_plain(grid, diag, source, span,
                                          n_steps)(y0)
    scale = float(y_p.abs().max())
    assert torch.isfinite(y_v1).all()
    assert float((y_v1 - y_p).abs().max()) / scale < TOL
    assert float((y_v1 - y_b1).abs().max()) / scale < TOL


# -- the banded LU (csrc/banded_lu.cu) ------------------------------------------

# the kernel against its plain twin, relative to the plain result's max: the
# same eliminations, FMA contraction and another order of the solves' sums
BANDED_TOL = {torch.float64: 1e-12, torch.complex128: 1e-12,
              torch.float32: 1e-5, torch.complex64: 1e-5}
# (blocks, rows, half-width): ci_py_driver_2d_iage's stage systems (2 x
# 900 x 61), ci_py_driver_2d_iage_column_regions' (2 x 60 x 7), phosphorus
# at 30 x 30 (1 x 2700 x 181), the sharded 2D year's vertical
# preconditioner (tracers x columns of nz rows, 7 bands), iage at 40 x 50;
# then the half-widths at each threshold of csrc/banded_lu.cu's shapes (a
# factor's rows a lane: 32 S >= bw + 2, a solve's: 32 S >= bw + 1; memory
# windows from bw = 94, complex128 from 63; kMaxBandwidth), fewer rows
# than the window, one row
BANDED_SHAPES = [(2, 900, 30), (2, 60, 3), (1, 2700, 90), (96, 24, 3),
                 (2, 2000, 40), (1, 50, 0), (2, 40, 1), (1, 300, 31),
                 (1, 300, 32), (1, 400, 62), (1, 400, 63), (1, 400, 64),
                 (1, 500, 94), (1, 500, 118), (1, 500, 119), (1, 600, 179),
                 (2, 20, 30), (2, 1, 5)]
# the pair launches' systems: a real dtype and its complex twin
BANDED_PAIRS = [(torch.float64, torch.complex128),
                (torch.float32, torch.complex64)]


def _dominant_bands(rng, n_blocks, m, bw, dtype):
    """(n_blocks, m, 2bw+1) diagonally dominant row-band matrices, zero
    outside the matrix"""
    cplx = dtype.is_complex
    vals = rng.uniform(-1.0, 1.0, (n_blocks, m, 2 * bw + 1))
    if cplx:
        vals = vals + 1j * rng.uniform(-1.0, 1.0, vals.shape)
    rows = np.arange(m)[:, None] + np.arange(2 * bw + 1)[None, :] - bw
    vals[:, (rows < 0) | (rows >= m)] = 0.0
    vals[:, :, bw] = np.abs(vals).sum(axis=-1) + 1.0
    return vals


def _banded_rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("dtype", list(BANDED_TOL))
@pytest.mark.parametrize("n_blocks, m, bw", BANDED_SHAPES)
def test_banded_lu_kernel_matches_plain(cuda_device, n_blocks, m, bw, dtype):
    rng = np.random.default_rng(m + bw)
    bands = torch.as_tensor(_dominant_bands(rng, n_blocks, m, bw, dtype),
                            dtype=dtype, device=cuda_device)
    rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, n_blocks, m)),
                          dtype=dtype, device=cuda_device)
    f0, s0 = banded_cuda.launch_counts()
    lu = banded.banded_lu_factor_blocks(bands)
    x = banded.banded_lu_solve_blocks(lu, rhs)
    torch.cuda.synchronize()
    assert banded_cuda.launch_counts() == (f0 + 1, s0 + 1)
    lu_p = banded.banded_lu_factor_plain(bands)
    x_p = banded.banded_lu_solve_plain(lu_p, rhs)
    tol = BANDED_TOL[dtype]
    assert _banded_rel(lu, lu_p) < tol
    assert _banded_rel(x, x_p) < tol
    # one right-hand side a block, and the kernel's solve on the plain
    # factors
    x1 = banded.banded_lu_solve_blocks(lu, rhs[0])
    assert _banded_rel(x1, x_p[0]) < tol
    assert _banded_rel(banded.banded_lu_solve_blocks(lu_p, rhs), x_p) < tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_banded_lu_kernel_window_off_shared_memory(cuda_device, dtype):
    """phosphorus's complex system at 40 x 50 (1 x 6000 x 241): the
    complex128 window does not fit in shared memory and the factor works
    in device memory; the float64 one fits"""
    rng = np.random.default_rng(3)
    m, bw = 6000, 120
    _threads, where, _smem, scratch = banded_cuda.factor_plan(dtype, bw,
                                                              cuda_device)
    assert where == ("shared" if dtype == torch.float64 else "device")
    assert (scratch > 0) == (where == "device")
    bands = torch.as_tensor(_dominant_bands(rng, 1, m, bw, dtype),
                            dtype=dtype, device=cuda_device)
    rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, (8, 1, m)), dtype=dtype,
                          device=cuda_device)
    lu = banded.banded_lu_factor_blocks(bands)
    x = banded.banded_lu_solve_blocks(lu, rhs)
    lu_p = banded.banded_lu_factor_plain(bands)
    assert _banded_rel(lu, lu_p) < BANDED_TOL[dtype]
    assert _banded_rel(x, banded.banded_lu_solve_plain(lu_p, rhs)) < \
        BANDED_TOL[dtype]


def test_banded_lu_kernel_factors_and_solves_only_where_due(cuda_device):
    """the flags the Radau stages pass: nothing factored where due is
    False, rhs returned unsolved where active is False"""
    rng = np.random.default_rng(5)
    bands = torch.as_tensor(_dominant_bands(rng, 2, 60, 3, torch.float64),
                            device=cuda_device)
    out = torch.full_like(bands, 7.0)
    no = torch.zeros((), dtype=torch.bool, device=cuda_device)
    banded.banded_lu_factor_blocks(bands, out=out, due=no)
    assert bool((out == 7.0).all())
    banded.banded_lu_factor_blocks(bands, out=out, due=~no)
    assert torch.equal(out, banded.banded_lu_factor_blocks(bands))
    rhs = torch.ones((2, 60), dtype=torch.float64, device=cuda_device)
    assert torch.equal(banded.banded_lu_solve_blocks(out, rhs, active=no), rhs)
    assert torch.equal(banded.banded_lu_solve_blocks(out, rhs, active=~no),
                       banded.banded_lu_solve_blocks(out, rhs))


def test_banded_lu_kernel_rejects_what_it_cannot_take(cuda_device):
    bands = torch.as_tensor(_dominant_bands(np.random.default_rng(1), 2, 20,
                                            3, torch.float64),
                            device=cuda_device)
    rhs = torch.ones((2, 20), dtype=torch.float64, device=cuda_device)
    before = banded_cuda.launch_counts()
    with pytest.raises(ValueError, match="takes"):
        banded_cuda.factor_blocks(bands.to(torch.float16))
    with pytest.raises(ValueError, match="cpu"):
        banded_cuda.factor_blocks(bands.cpu())
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.factor_blocks(bands[0])
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.factor_blocks(bands[..., :6])
    with pytest.raises(ValueError, match="contiguous"):
        banded_cuda.factor_blocks(bands.transpose(0, 1).contiguous()
                                  .transpose(0, 1))
    with pytest.raises(ValueError, match="half-width"):
        banded_cuda.factor_blocks(torch.zeros(
            (1, 400, 2 * banded_cuda.MAX_BANDWIDTH + 3), dtype=torch.float64,
            device=cuda_device))
    lu = banded_cuda.factor_blocks(bands)
    before = (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="rhs is"):
        banded_cuda.solve_blocks(lu, rhs.to(torch.float32))
    with pytest.raises(ValueError, match="rhs is"):
        banded_cuda.solve_blocks(lu, rhs.cpu())
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.solve_blocks(lu, rhs[:, :19])
    with pytest.raises(ValueError, match="contiguous"):
        banded_cuda.solve_blocks(lu, torch.ones((20, 2), dtype=torch.float64,
                                                device=cuda_device).T)
    with pytest.raises(ValueError, match="due"):
        banded_cuda.factor_blocks(bands, out=torch.empty_like(bands),
                                  due=torch.ones((), device=cuda_device))
    with pytest.raises(ValueError, match="out"):
        banded_cuda.factor_blocks(bands, out=bands)
    with pytest.raises(ValueError, match="active"):
        banded_cuda.solve_blocks(lu, rhs, active=torch.ones((2,), dtype=torch.bool,
                                                            device=cuda_device))
    assert banded_cuda.launch_counts() == before


@pytest.mark.parametrize("dtypes", BANDED_PAIRS, ids=lambda d: str(d))
@pytest.mark.parametrize("n_blocks, m, bw", BANDED_SHAPES)
def test_banded_lu_pair_matches_plain(cuda_device, n_blocks, m, bw, dtypes):
    """both stage systems in one launch of the factor and one of the
    solves, each against its plain twin; a pair counts as one launch"""
    rng = np.random.default_rng(m + 2 * bw)
    bands = [torch.as_tensor(_dominant_bands(rng, n_blocks, m, bw, dtype),
                             dtype=dtype, device=cuda_device)
             for dtype in dtypes]
    rhs = [torch.as_tensor(rng.uniform(-1.0, 1.0, (2, n_blocks, m)),
                           dtype=dtype, device=cuda_device) for dtype in dtypes]
    f0, s0 = banded_cuda.launch_counts()
    lus = banded.banded_lu_factor_pair(*bands)
    xs = banded.banded_lu_solve_pair(lus[0], rhs[0], lus[1], rhs[1])
    torch.cuda.synchronize()
    assert banded_cuda.launch_counts() == (f0 + 1, s0 + 1)
    for dtype, band, lu, rh, x in zip(dtypes, bands, lus, rhs, xs):
        lu_p = banded.banded_lu_factor_plain(band)
        tol = BANDED_TOL[dtype]
        assert lu.dtype == dtype and x.dtype == dtype
        assert _banded_rel(lu, lu_p) < tol
        assert _banded_rel(x, banded.banded_lu_solve_plain(lu_p, rh)) < tol


def test_banded_lu_pair_only_where_due(cuda_device):
    """one false flag leaves both outputs as they were"""
    rng = np.random.default_rng(8)
    bands_r = torch.as_tensor(_dominant_bands(rng, 2, 900, 30, torch.float64),
                              device=cuda_device)
    bands_c = torch.as_tensor(
        _dominant_bands(rng, 2, 900, 30, torch.complex128), device=cuda_device)
    out_r = torch.full_like(bands_r, 7.0)
    out_c = torch.full_like(bands_c, 7.0)
    no = torch.zeros((), dtype=torch.bool, device=cuda_device)
    banded.banded_lu_factor_pair(bands_r, bands_c, out_r=out_r, out_c=out_c,
                                 due=no)
    assert bool((out_r == 7.0).all()) and bool((out_c == 7.0).all())
    banded.banded_lu_factor_pair(bands_r, bands_c, out_r=out_r, out_c=out_c,
                                 due=~no)
    assert torch.equal(out_r, banded.banded_lu_factor_blocks(bands_r))
    assert torch.equal(out_c, banded.banded_lu_factor_blocks(bands_c))
    rhs_r = torch.ones((2, 900), dtype=torch.float64, device=cuda_device)
    rhs_c = torch.ones((2, 900), dtype=torch.complex128, device=cuda_device)
    x_r, x_c = banded.banded_lu_solve_pair(out_r, rhs_r, out_c, rhs_c,
                                           active=no)
    assert torch.equal(x_r, rhs_r) and torch.equal(x_c, rhs_c)
    x_r, x_c = banded.banded_lu_solve_pair(out_r, rhs_r, out_c, rhs_c,
                                           active=~no)
    assert torch.equal(x_r, banded.banded_lu_solve_blocks(out_r, rhs_r))
    assert torch.equal(x_c, banded.banded_lu_solve_blocks(out_c, rhs_c))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_banded_lu_many_right_hand_sides(cuda_device, dtype):
    """ops/eigen.py's solves: many right-hand sides against one matrix
    (phosphorus at 30 x 30), a warp each"""
    rng = np.random.default_rng(11)
    bands = torch.as_tensor(_dominant_bands(rng, 1, 2700, 90, dtype),
                            dtype=dtype, device=cuda_device)
    rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, (40, 1, 2700)), dtype=dtype,
                          device=cuda_device)
    lu = banded.banded_lu_factor_blocks(bands)
    x = banded.banded_lu_solve_blocks(lu, rhs)
    lu_p = banded.banded_lu_factor_plain(bands)
    assert _banded_rel(x, banded.banded_lu_solve_plain(lu_p, rhs)) < \
        BANDED_TOL[dtype]


def test_banded_lu_pair_rejects_what_it_cannot_take(cuda_device):
    rng = np.random.default_rng(2)
    bands_r = torch.as_tensor(_dominant_bands(rng, 2, 20, 3, torch.float64),
                              device=cuda_device)
    bands_c = bands_r.to(torch.complex128)
    rhs_r = torch.ones((2, 20), dtype=torch.float64, device=cuda_device)
    rhs_c = rhs_r.to(torch.complex128)
    before = banded_cuda.launch_counts()
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        banded_cuda.factor_pair(bands_r, bands_c.to(torch.complex64))
    with pytest.raises(ValueError, match="float64 \\+ complex128"):
        banded_cuda.factor_pair(bands_c, bands_r)
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.factor_pair(bands_r, bands_c[:1])
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.factor_pair(bands_r, bands_c[:, :19].contiguous())
    with pytest.raises(ValueError, match="distinct"):
        banded_cuda.factor_pair(bands_r, bands_c, out_r=torch.empty_like(bands_r),
                                out_c=bands_c)
    lu_r, lu_c = banded_cuda.factor_pair(bands_r, bands_c)
    before = (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="shape"):
        banded_cuda.solve_pair(lu_r, rhs_r, lu_c[:1], rhs_c[:1])
    with pytest.raises(ValueError, match="rhs"):
        banded_cuda.solve_pair(lu_r, rhs_r, lu_c, rhs_c[:, :19])
    with pytest.raises(ValueError, match="rhs is"):
        banded_cuda.solve_pair(lu_r, rhs_r, lu_c, rhs_r)
    with pytest.raises(ValueError, match="active"):
        banded_cuda.solve_pair(lu_r, rhs_r, lu_c, rhs_c,
                               active=torch.ones((), device=cuda_device))
    assert banded_cuda.launch_counts() == before
