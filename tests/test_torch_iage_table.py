"""the table of an iage year's CN solves (ops/imex_cuda.py::build_iage_table,
csrc/iage_year.cu's table kernel) in plain PyTorch: kv against the JAX
package's vert_mixing_coeff, the CN increment from the table's Thomas
factors against the JAX package's cn_vertical_increment (float64), the year
through that increment against the JAX package's Pallas kernel in interpret
mode (float32), and the table's layout against the kernel source's"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.ops.imex import (  # noqa: E402
    cn_vertical_increment as jax_cn_increment,
)
from newton_krylov_ooc_tpu.ops.imex_pallas import (  # noqa: E402
    build_iage_year_pallas_v2,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (  # noqa: E402
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.ops import imex_cuda  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
YEAR = physics.SEC_PER_YEAR
SPAN = (0.0, YEAR)
# (nz, ny, n_steps): the JAX in-core tests' grid, and one whose columns
# fill no power of two
SHAPES = [(8, 6, 24), (12, 10, 36)]


def _setup(nz, ny, dtype=torch.float64):
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((2, nz, ny))
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    grid = physics.make_grid(depth, ypos, MODELINFO, device=CPU, dtype=dtype)
    return depth, ypos, diag, grid


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
def test_table_kv_matches_jax(nz, ny, n_steps):
    """kv of every solve of a year (at its own time) is the JAX package's
    vert_mixing_coeff, float64"""
    depth, ypos, diag, grid = _setup(nz, ny)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    times, h = imex_cuda.solve_times(SPAN, n_steps)
    kv, m, w, cp = imex_cuda.iage_table_plain(grid, diag, times, h)
    assert kv.shape == (n_steps + 1, nz - 1, ny)
    assert m.shape == w.shape == cp.shape == (n_steps + 1, 2, nz, ny)
    assert times[0] == 0.0 and times[-1] == pytest.approx(YEAR)
    assert h[0] == h[-1] == pytest.approx(0.5 * YEAR / n_steps)
    for s in (0, 1, n_steps // 3, n_steps - 1, n_steps):
        ref = jax_physics.vert_mixing_coeff(jgrid, times[s])
        assert _rel(kv[s].numpy(), ref) < 1e-12


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
def test_factored_cn_increment_matches_jax(nz, ny, n_steps):
    """the CN increment from the table's factors (B1's chain: r' = rhs w,
    gp = r' - m gp, x = gp - cp x) is the JAX package's PCR increment,
    float64, for a merged dt solve and the trailing dt/2"""
    depth, ypos, diag, grid = _setup(nz, ny)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    times, h = imex_cuda.solve_times(SPAN, n_steps)
    kv, m, w, cp = imex_cuda.iage_table_plain(grid, diag, times, h)
    y0 = np.random.default_rng(5).uniform(0.0, 2.0, (2, nz, ny))
    for s in (n_steps // 2, n_steps):
        ours = imex_cuda.cn_increment_factored(
            kv[s], m[s], w[s], cp[s], torch.as_tensor(diag), grid.dz_r,
            torch.as_tensor(y0), float(h[s]))
        for ch in range(2):
            ref = jax_cn_increment(jnp.asarray(kv[s].numpy()),
                                   jnp.asarray(diag[ch]), jgrid.dz_r,
                                   jnp.asarray(y0[ch]), float(h[s]))
            assert _rel(ours[ch].numpy(), ref) < 1e-12


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
@pytest.mark.parametrize("aging", [True, False])
def test_factored_year_matches_pallas_kernel_f32(nz, ny, n_steps, aging):
    """the year through the factored CN step (B1's arithmetic in plain
    PyTorch) against the JAX package's Pallas kernel in interpret mode,
    float32, within the JAX test's own bound for its kernel"""
    depth, ypos, diag, grid = _setup(nz, ny, torch.float32)
    source = np.full((2, 1, 1), 1.0 / YEAR if aging else 0.0)
    y0 = np.random.default_rng(11).uniform(0.0, 2.0, (2, nz, ny))
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    ref = build_iage_year_pallas_v2(
        jgrid, diag.astype(np.float32), source.astype(np.float32), SPAN,
        n_steps,
    )(jnp.asarray(y0, jnp.float32), interpret=True)
    ours = imex_cuda.build_iage_year_factored(grid, diag, source, SPAN,
                                              n_steps)(
        torch.as_tensor(y0, dtype=torch.float32))
    assert ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) < 5e-5


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES + [(40, 50, 3)])
def test_table_layout_matches_the_kernel_source(nz, ny, n_steps):
    """the wrapper's table layout (offsets, bytes) is the one
    csrc/iage_year.cu counts (its layout in csrc/imex_table.cuh): each part
    padded to its kAlign floats, kFactors fields a channel; packing and
    unpacking are inverse"""
    source = (imex_cuda.CSRC / "imex_table.cuh").read_text()
    assert '#include "imex_table.cuh"' in (
        imex_cuda.CSRC / "iage_year.cu").read_text()
    align = int(re.search(r"constexpr int kAlign = (\d+);", source).group(1))
    factors = int(re.search(r"constexpr int kFactors = (\d+);",
                            source).group(1))
    assert (align, factors) == (imex_cuda._TABLE_ALIGN,
                                imex_cuda._TABLE_FACTORS)
    layout = imex_cuda.table_layout(2, nz, ny, n_steps)
    kv_floats = -(-(nz - 1) * ny // align) * align
    factor_floats = -(-factors * nz * ny // align) * align
    assert layout["kv_floats"] == kv_floats
    assert layout["factor_floats"] == factor_floats
    assert layout["solve_floats"] == kv_floats + 2 * factor_floats
    assert layout["floats"] == (n_steps + 1) * layout["solve_floats"]
    assert layout["bytes"] == 4 * layout["floats"]
    for part in ("kv_floats", "factor_floats", "solve_floats"):
        assert layout[part] % align == 0  # 16-byte aligned bulk copies

    _, _, diag, grid = _setup(nz, ny, torch.float32)
    table = imex_cuda.build_iage_table(grid, diag, SPAN, n_steps,
                                       device="cpu")
    assert table.tensor.dtype == torch.float32
    assert table.nbytes == layout["bytes"]
    times, h = imex_cuda.solve_times(SPAN, n_steps)
    plain = imex_cuda.iage_table_plain(grid, diag, times, h)
    unpacked = imex_cuda.unpack_table(table.tensor, 2, nz, ny, n_steps)
    for ours, ref in zip(unpacked, plain):
        assert torch.equal(ours, ref)
    with pytest.raises(ValueError):
        imex_cuda.unpack_table(table.tensor, 2, nz, ny, n_steps + 1)


def test_table_refuses_another_year():
    """a year checks that a shared table was built for it: same grid,
    implicit diagonal, span, steps and device"""
    nz, ny, n_steps = SHAPES[0]
    _, _, diag, grid = _setup(nz, ny, torch.float32)
    table = imex_cuda.build_iage_table(grid, diag, SPAN, n_steps,
                                       device="cpu")
    key = imex_cuda._table_key(grid, torch.as_tensor(diag))
    t0, dt = imex_cuda._time_step(SPAN, n_steps)
    table.check(key, (2, nz, ny), n_steps, t0, dt, CPU)
    other = torch.as_tensor(diag) * 2.0
    for args in ((imex_cuda._table_key(grid, other), (2, nz, ny), n_steps,
                  t0, dt, CPU),
                 (key, (2, nz, ny), n_steps + 1, t0, dt, CPU),
                 (key, (2, nz, ny), n_steps, t0, 2.0 * dt, CPU)):
        with pytest.raises(ValueError, match="another year"):
            table.check(*args)
    with pytest.raises(ValueError, match="at least one step"):
        imex_cuda._time_step(SPAN, 0)
    with pytest.raises(ValueError, match="no launch"):
        table.build_ms()
