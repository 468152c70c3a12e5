"""the phosphorus year on B1's table (ops/imex_cuda.py::
build_phosphorus_table, csrc/phosphorus_year.cu's design) in plain PyTorch,
on the CPU: the zero-diagonal table's factored CN increment against the JAX
package's cn_vertical_increment (float64, each tracer, serial chain and the
kernel's scans); B2's step in plain PyTorch (build_phosphorus_year_factored)
against the JAX package's Pallas kernel in interpret mode (float32, each
tracer) and its float64 scan year, with total phosphorus; the kernel's lane
rule against its source; PhosphorusKernel on the CPU; and whether B1's
float32 table or its scan order moves its year from float64
(cli/table_precision.py)"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    phosphorus as jax_phosphorus,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    PhosphorusKernel as JaxPhosphorusKernel,
)
from newton_krylov_ooc_tpu.ops.imex import (  # noqa: E402
    cn_vertical_increment as jax_cn_increment,
)
from newton_krylov_ooc_tpu.ops.imex_pallas import (  # noqa: E402
    build_phosphorus_year_pallas,
)
from newton_krylov_ooc_tpu_torch.cli import table_precision  # noqa: E402
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import (  # noqa: E402
    phosphorus,
    physics,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import imex_cuda  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
YEAR = physics.SEC_PER_YEAR
SPAN = (0.0, YEAR)
# (nz, ny, n_steps): the JAX in-core tests' grid, and one whose columns
# fill no power of two
SHAPES = [(8, 6, 24), (12, 10, 36)]
F32_TOL = 5e-5   # of each tracer's max: the JAX test's kernel-vs-scan bound
F64_TOL = 1e-4   # of each tracer's max: chip_smoke.py phase 4's f64 gate
# total phosphorus over a float32 year, relative: the scheme conserves it,
# float32 rounding of the increments does not (the plain float32 year
# drifts 2.2e-7 at 8x6x24 and 1.3e-6 at 12x10x36 on these inputs)
P_DRIFT_TOL = 5e-6


def _inputs(nz, ny, dtype):
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=CPU, dtype=dtype)
    light = phosphorus.light_lim_2d(depth, ypos, device=CPU, dtype=dtype)
    return depth, ypos, grid, light


def _state(depth, ypos, seed):
    """the initial iterate times seeded noise: po4, dop and pop orders of
    magnitude apart"""
    init = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU,
                            dtype=torch.float64, n_steps=24).init_iterate()
    rng = np.random.default_rng(seed)
    return init.numpy() * (1.0 + 0.5 * rng.uniform(size=init.shape))


def _rel_by_tracer(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return [np.abs(ours[tr] - ref[tr]).max() / np.abs(ref[tr]).max()
            for tr in range(3)]


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
@pytest.mark.parametrize("chain", ["serial", "scan"])
def test_zero_diagonal_factored_increment_matches_jax(nz, ny, n_steps, chain):
    """the CN increment from the zero-diagonal table's factors (one channel
    serving po4, dop and pop) is the JAX package's increment with diag = 0,
    float64, for each tracer, a merged dt solve and the trailing dt/2"""
    depth, ypos, grid, _ = _inputs(nz, ny, torch.float64)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    times, h = imex_cuda.solve_times(SPAN, n_steps)
    diag = torch.zeros((1, nz, ny), dtype=torch.float64)
    kv, m, w, cp = imex_cuda.iage_table_plain(grid, diag, times, h)
    assert m.shape == (n_steps + 1, 1, nz, ny)
    lanes = imex_cuda.phosphorus_lanes(ny) if chain == "scan" else None
    y = _state(depth, ypos, 3)
    for s in (n_steps // 2, n_steps):
        ours = imex_cuda.cn_increment_factored(
            kv[s], m[s], w[s], cp[s], diag, grid.dz_r, torch.as_tensor(y),
            float(h[s]), lanes)
        for tr in range(3):
            ref = np.asarray(jax_cn_increment(
                jnp.asarray(kv[s].numpy()), jnp.zeros((nz, ny)), jgrid.dz_r,
                jnp.asarray(y[tr]), float(h[s])))
            err = np.abs(ours[tr].numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-12, (s, tr)


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
def test_factored_year_matches_pallas_kernel_f32(nz, ny, n_steps):
    """B2's step in plain PyTorch (the table's factors, the kernel's scan
    order, the Kahan adds) against the JAX package's Pallas kernel in
    interpret mode, float32, within 5e-5 of each tracer's own max"""
    depth, ypos, grid, light = _inputs(nz, ny, torch.float32)
    y0 = _state(depth, ypos, 8).astype(np.float32)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    ref = build_phosphorus_year_pallas(
        jgrid, jax_phosphorus.DEFAULT_PARAMS,
        jax_phosphorus.light_lim_2d(depth, ypos), SPAN, n_steps,
    )(jnp.asarray(y0), interpret=True)
    year = imex_cuda.build_phosphorus_year_factored(
        grid, phosphorus.DEFAULT_PARAMS, light, SPAN, n_steps)
    ours = year(torch.as_tensor(y0))
    assert ours.dtype == torch.float32
    errs = _rel_by_tracer(ours.numpy(), ref)
    assert max(errs) < F32_TOL, errs
    with pytest.raises(ValueError):
        year(torch.as_tensor(y0).double())


@pytest.mark.parametrize("nz, ny, n_steps", SHAPES)
def test_factored_year_matches_jax_f64_scan_year(nz, ny, n_steps):
    """the same float32 year against the JAX package's float64 scan year,
    each tracer within 1e-4 of its own max, total phosphorus kept"""
    depth, ypos, grid, light = _inputs(nz, ny, torch.float32)
    jk = JaxPhosphorusKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                             n_steps=n_steps, use_pallas=False)
    y0 = torch.as_tensor(_state(depth, ypos, 13), dtype=torch.float32)
    ref = np.asarray(jk._year_fn(jnp.asarray(y0.double().numpy())))
    ours = imex_cuda.build_phosphorus_year_factored(
        grid, phosphorus.DEFAULT_PARAMS, light, SPAN, n_steps)(
        y0).double().numpy()
    errs = _rel_by_tracer(ours, ref)
    assert max(errs) < F64_TOL, errs
    w = np.outer(depth.delta, ypos.delta)
    p0, p1 = (w * y0.double().numpy()).sum(), (w * ours).sum()
    assert abs(p1 - p0) < P_DRIFT_TOL * abs(p0)


def test_kernel_lanes_match_the_kernel_source():
    """the wrapper's copy of csrc/phosphorus_year.cu's cluster (kCtas blocks
    of kThreads threads at most) and of the lanes rule, and the table
    layout constants B1 and B2 share (csrc/imex_table.cuh)"""
    source = (imex_cuda.CSRC / "phosphorus_year.cu").read_text()
    ctas = int(re.search(r"constexpr int kCtas = (\d+);", source).group(1))
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            source).group(1))
    assert (ctas, threads) == (imex_cuda._PHOS_CTAS, imex_cuda._PHOS_THREADS)
    iage = (imex_cuda.CSRC / "iage_year.cu").read_text()
    assert (int(re.search(r"constexpr int kThreads = (\d+);", iage).group(1))
            == imex_cuda._IAGE_THREADS)
    header = (imex_cuda.CSRC / "imex_table.cuh").read_text()
    assert "column_lanes(int ny, int threads)" in header
    for ny in (1, 6, 10, 25, 27, 50, 53, 400):
        lanes = imex_cuda.column_lanes(ny, threads)
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert lanes == 1 or -(-lanes * ny // 32) * 32 + 32 <= threads
        assert lanes == 32 or -(-2 * lanes * ny // 32) * 32 + 32 > threads
    # 40 x 50: four blocks of 13 columns, 16 lanes and 3 levels a lane
    assert imex_cuda.phosphorus_lanes(50) == 16
    for name in ("imex_common.cuh", "imex_table.cuh"):
        assert name in imex_cuda.INCLUDES["phosphorus_year"]
        assert name in imex_cuda.INCLUDES["iage_year"]


def test_phosphorus_table_is_b1s_zero_diagonal_table():
    """build_phosphorus_table on the CPU: B1's table layout at one channel,
    the plain factors of a zero diagonal, refusing another year"""
    nz, ny, n_steps = SHAPES[1]
    _, _, grid, _ = _inputs(nz, ny, torch.float32)
    table = imex_cuda.build_phosphorus_table(grid, SPAN, n_steps, device="cpu")
    layout = imex_cuda.table_layout(1, nz, ny, n_steps)
    assert table.nbytes == layout["bytes"]
    assert table.shape == (1, nz, ny)
    times, h = imex_cuda.solve_times(SPAN, n_steps)
    plain = imex_cuda.iage_table_plain(grid, np.zeros((1, nz, ny)), times, h)
    for ours, ref in zip(imex_cuda.unpack_table(table.tensor, 1, nz, ny,
                                                n_steps), plain):
        assert torch.equal(ours, ref)
    key = imex_cuda._table_key(grid, torch.zeros((1, nz, ny)))
    t0, dt = imex_cuda._time_step(SPAN, n_steps)
    table.check(key, (1, nz, ny), n_steps, t0, dt, CPU)
    nonzero = imex_cuda._table_key(grid, torch.full((1, nz, ny), -1e-6))
    for args in ((nonzero, (1, nz, ny), n_steps, t0, dt, CPU),
                 (key, (1, nz, ny), n_steps, t0, 0.5 * dt, CPU)):
        with pytest.raises(ValueError, match="another year"):
            table.check(*args)


def test_phosphorus_kernel_on_the_cpu_runs_the_plain_year():
    """PhosphorusKernel on the CPU: the plain year for F, no table built"""
    depth, ypos = build_axes(8, 6)
    tables = imex_cuda.iage_table_launches
    years = imex_cuda.phosphorus_year_launches
    kernel = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU,
                              dtype=torch.float32, n_steps=24)
    assert not kernel.use_kernel
    assert kernel._year_fn is kernel._year_plain
    assert getattr(kernel, "table", None) is None
    x = kernel.init_iterate()
    fcn = kernel.comp_fcn(x)
    assert torch.isfinite(fcn).all()
    assert imex_cuda.iage_table_launches == tables
    assert imex_cuda.phosphorus_year_launches == years


def test_table_and_scan_chain_stay_within_the_plain_f32_year():
    """B1's table and scan chain, which B2 shares, against float64
    (cli/table_precision.py): at phase 2's grid over the first tenth of the
    year from its JVP-route input, B1's step with its table's factors
    formed in float32 or in float64, and its chain serial or in the
    kernel's scan order, is no further from the float64 year than the plain
    float32 year is -- largest and RMS difference -- so neither the table's
    rounding nor the scan's order moves B1's year from float64 beyond
    float32's own noise"""
    errs = table_precision.compare(40, 50, 876, seed=0)
    plain_max, plain_rms = errs.pop("plain f32 (PCR)")
    assert set(errs) == set(table_precision.variants(50))
    assert plain_max < 2e-5
    for name, (worst, rms) in errs.items():
        assert worst <= plain_max, (name, worst, plain_max)
        assert rms <= plain_rms, (name, rms, plain_rms)
