"""the CUDA year kernels (csrc/iage_year.cu, csrc/phosphorus_year.cu,
csrc/transport3d_year.cu) against their plain PyTorch versions; need an
NVIDIA Hopper card and nvcc, and skip without a card

    python -m pytest tests/test_torch_kernels.py -q     # on the card
"""

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
from newton_krylov_ooc_tpu_torch.ops import imex_cuda, transport3d_cuda
from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (
    ShardedTransport3dKernel,
    family_year_inputs,
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


@pytest.mark.parametrize("nz, ny, n_steps", [(8, 6, 24), (40, 50, 8760)])
@pytest.mark.parametrize("aging", [True, False])
def test_year_kernel_matches_plain(cuda_device, nz, ny, n_steps, aging):
    grid, diag = _setup(nz, ny, cuda_device)
    source = np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR if aging else 0.0)
    span = (0.0, physics.SEC_PER_YEAR)
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
    year = imex_cuda.build_iage_year(grid, diag, np.zeros((2, 1, 1)),
                                     (0.0, physics.SEC_PER_YEAR), 24,
                                     device=cuda_device)
    y0 = torch.ones((2, 8, 6), dtype=torch.float32, device=cuda_device)
    before = imex_cuda.iage_year_launches
    for bad in (y0.double(), y0.cpu(), y0[:1], y0.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            year(bad)
    assert imex_cuda.iage_year_launches == before


def _phosphorus_year(nz, ny, n_steps, device):
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=device,
                             dtype=torch.float32)
    light = phosphorus.light_lim_2d(depth, ypos, device=device,
                                    dtype=torch.float32)
    args = (grid, phosphorus.DEFAULT_PARAMS, light,
            (0.0, physics.SEC_PER_YEAR), n_steps)
    return (imex_cuda.build_phosphorus_year(*args, device=device),
            imex_cuda.build_phosphorus_year_plain(*args))


@pytest.mark.parametrize("nz, ny, n_steps", [(8, 6, 24), (40, 50, 8760)])
def test_phosphorus_year_kernel_matches_plain(cuda_device, nz, ny, n_steps):
    year_k, year_p = _phosphorus_year(nz, ny, n_steps, cuda_device)
    rng = np.random.default_rng(9)
    y0 = torch.as_tensor(rng.uniform(0.0, 2.0, (3, nz, ny)), dtype=torch.float32,
                         device=cuda_device)

    before = imex_cuda.phosphorus_year_launches
    y_k = year_k(y0)
    torch.cuda.synchronize()
    assert imex_cuda.phosphorus_year_launches == before + 1
    y_p = year_p(y0)

    assert torch.isfinite(y_k).all()
    scale = float(y_p.abs().max())
    assert float((y_k - y_p).abs().max()) / scale < TOL


def test_phosphorus_year_kernel_rejects_what_it_cannot_take(cuda_device):
    year, _ = _phosphorus_year(8, 6, 24, cuda_device)
    y0 = torch.ones((3, 8, 6), dtype=torch.float32, device=cuda_device)
    before = imex_cuda.phosphorus_year_launches
    for bad in (y0.double(), y0.cpu(), y0[:2], y0.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            year(bad)
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
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, specs)
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


@pytest.mark.parametrize("case", ["steady", "coupled", "seasonal"])
def test_transport3d_year_kernel_matches_plain(cuda_device, case):
    year_k, year_p, y0 = _transport3d_years(case, cuda_device)
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
