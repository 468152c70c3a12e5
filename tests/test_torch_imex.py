"""the port's IMEX year (plain PyTorch) against the JAX package's scan year
and its Pallas kernel (interpret mode), on the 8x6 grid with 24 steps"""

import os
import shutil

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
from newton_krylov_ooc_tpu.ops.imex import imex_year as jax_imex_year  # noqa: E402
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
from newton_krylov_ooc_tpu_torch.ops.imex import (  # noqa: E402
    cn_vertical_increment,
    imex_year,
)

torch.set_num_threads(1)

NZ, NY, N_STEPS = 8, 6, 24
CPU = torch.device("cpu")
YEAR = physics.SEC_PER_YEAR
SPAN = (0.0, YEAR)


@pytest.fixture(scope="module")
def setup():
    depth, ypos = build_axes(NZ, NY)
    rate = surf_restore_rate(depth)
    diag = np.zeros((2, NZ, NY))
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    rng = np.random.default_rng(11)
    y0 = rng.uniform(0.0, 2.0, (2, NZ, NY))
    return depth, ypos, diag, y0


def _grid(depth, ypos, dtype):
    return physics.make_grid(depth, ypos, MODELINFO, device=CPU, dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_cn_increment_matches_jax(setup):
    depth, ypos, diag, y0 = setup
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    grid = _grid(depth, ypos, torch.float64)
    kv = physics.vert_mixing_coeff(grid, 0.3 * YEAR)
    ours = cn_vertical_increment(kv, torch.as_tensor(diag[0]), grid.dz_r,
                                 torch.as_tensor(y0[0]), 3600.0)
    ref = jax_cn_increment(jnp.asarray(kv.numpy()), jnp.asarray(diag[0]),
                           jgrid.dz_r, jnp.asarray(y0[0]), 3600.0)
    assert _rel(ours.numpy(), ref) < 1e-12


def test_imex_year_matches_jax_f64(setup):
    """(a) the same scheme in float64: roundoff only"""
    depth, ypos, diag, y0 = setup
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)

    def jax_tend(t, y):
        def one(v):
            return jax_physics.advection_tend(jgrid, v) + jax_physics.horiz_mix_tend(
                jgrid, v
            )

        return jax.vmap(one)(y) + 1.0 / YEAR

    ref = jax_imex_year(
        jax_tend, lambda t: jax_physics.vert_mixing_coeff(jgrid, t),
        jnp.asarray(diag), jgrid.dz_r, jnp.asarray(y0), SPAN, N_STEPS,
    )

    grid = _grid(depth, ypos, torch.float64)

    def tend(t, y):
        return physics.advection_tend(grid, y) + physics.horiz_mix_tend(grid, y) + (
            1.0 / YEAR
        )

    ours = imex_year(tend, lambda t: physics.vert_mixing_coeff(grid, t),
                     torch.as_tensor(diag), grid.dz_r, torch.as_tensor(y0), SPAN,
                     N_STEPS)
    assert _rel(ours.numpy(), ref) < 1e-12


@pytest.mark.parametrize("aging", [True, False])
def test_plain_year_matches_pallas_kernel_f32(setup, aging):
    """(b) the kernel's plain version against the JAX package's Pallas
    kernel in interpret mode, float32; (c) and against the float64 plain
    version (Kahan keeps f32 near f64)"""
    depth, ypos, diag, y0 = setup
    source = np.full((2, 1, 1), 1.0 / YEAR if aging else 0.0)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    ref = build_iage_year_pallas_v2(
        jgrid, diag.astype(np.float32), source.astype(np.float32), SPAN, N_STEPS
    )(jnp.asarray(y0, jnp.float32), interpret=True)

    plain32 = imex_cuda.build_iage_year_plain(
        _grid(depth, ypos, torch.float32), diag, source, SPAN, N_STEPS
    )(torch.as_tensor(y0, dtype=torch.float32))
    plain64 = imex_cuda.build_iage_year_plain(
        _grid(depth, ypos, torch.float64), diag, source, SPAN, N_STEPS
    )(torch.as_tensor(y0))
    assert plain32.dtype == torch.float32
    # the JAX test's own bound for its kernel against the scan
    assert _rel(plain32.numpy(), ref) < 5e-5
    assert _rel(plain32.numpy(), plain64.numpy()) < 1e-4


def test_wrapper_cpu_is_plain_and_cuda_never_falls_back(setup, monkeypatch):
    """(d) on the CPU the wrapper is the plain f32 year; a CUDA request
    without a card raises, and never returns a CPU result"""
    depth, ypos, diag, y0 = setup
    source = np.full((2, 1, 1), 1.0 / YEAR)
    grid64 = _grid(depth, ypos, torch.float64)
    y32 = torch.as_tensor(y0, dtype=torch.float32)
    year = imex_cuda.build_iage_year(grid64, diag, source, SPAN, N_STEPS,
                                     device="cpu")
    plain = imex_cuda.build_iage_year_plain(
        _grid(depth, ypos, torch.float32), diag, source, SPAN, N_STEPS
    )
    before = imex_cuda.iage_year_launches
    assert torch.equal(year(y32), plain(y32))
    assert imex_cuda.iage_year_launches == before
    with pytest.raises(ValueError):
        year(y32.double())
    with pytest.raises(ValueError):
        year(y32[:, :, :-1])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        imex_cuda.build_iage_year(grid64, diag, source, SPAN, N_STEPS,
                                  device="cuda")


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o file and a ptxas line; fails on the
# source named in FAIL_ON
out=""
src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *.cu) src="$1"; shift ;;
    *) shift ;;
  esac
done
echo "ptxas info    : Used 7 registers" >&2
if [ -n "$FAIL_ON" ]; then
  case "$src" in *"$FAIL_ON"*) exit 3 ;; esac
fi
echo built > "$out"
"""


def test_build_libraries_one_nvcc_per_source(tmp_path, monkeypatch):
    """the kernel build: one nvcc per source, each library keyed on its
    source, the headers it includes and the flags, the ptxas report beside
    it, nothing rebuilt while the sources hold, and a failure that names
    its source once every nvcc has ended"""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(FAKE_NVCC)
    (bindir / "nvcc").chmod(0o755)
    csrc = tmp_path / "csrc"
    shutil.copytree(imex_cuda.CSRC, csrc)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("FAIL_ON", raising=False)
    monkeypatch.setattr(imex_cuda, "CSRC", csrc)
    monkeypatch.setattr(imex_cuda, "BUILD_DIR", tmp_path / "build")

    built = imex_cuda.build_libraries()
    assert sorted(built) == ["banded_lu", "iage_block", "iage_year",
                             "phosphorus_year", "transport3d_block",
                             "transport3d_stream", "transport3d_sweep",
                             "transport3d_year"]
    for name, (path, seconds) in built.items():
        assert path.parent == tmp_path / "build" and path.name.startswith(name)
        assert path.exists() and seconds > 0.0
        assert "registers" in path.with_suffix(".log").read_text()
    again = imex_cuda.build_libraries()
    assert again == {name: (path, 0.0) for name, (path, _) in built.items()}

    # a kernel's own source keys only its library
    src = csrc / "phosphorus_year.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = imex_cuda.build_libraries()
    assert again["iage_year"] == (built["iage_year"][0], 0.0)
    assert again["phosphorus_year"][0] != built["phosphorus_year"][0]

    # the shared 3D header keys the four 3D kernels and neither 2D one
    header3d = csrc / "transport3d_common.cuh"
    header3d.write_text(header3d.read_text() + "\n// edited\n")
    again = imex_cuda.build_libraries()
    for name in ("transport3d_year", "transport3d_stream", "transport3d_sweep",
                 "transport3d_block"):
        assert again[name][0] != built[name][0] and again[name][1] > 0.0
    assert again["iage_year"] == (built["iage_year"][0], 0.0)
    built = again

    # the fused step keys the stream year, the sweep and B7, not B4
    passes = csrc / "transport3d_stream_passes.cuh"
    passes.write_text(passes.read_text() + "\n// edited\n")
    again = imex_cuda.build_libraries()
    for name in ("transport3d_stream", "transport3d_sweep",
                 "transport3d_block"):
        assert again[name][0] != built[name][0] and again[name][1] > 0.0
    assert again["transport3d_year"] == (built["transport3d_year"][0], 0.0)
    built = again

    # the shared 2D header keys the three 2D kernels and neither 3D one; a
    # failing source is named, the others built
    header = csrc / "imex_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    monkeypatch.setenv("FAIL_ON", "phosphorus_year")
    with pytest.raises(RuntimeError, match="phosphorus_year.cu") as failed:
        imex_cuda.build_libraries()
    assert "iage_year.cu" not in str(failed.value)
    for name in ("transport3d_year", "transport3d_stream", "transport3d_sweep",
                 "transport3d_block"):
        assert imex_cuda._library_path(name) == built[name][0]
    assert imex_cuda._library_path("iage_year") != built["iage_year"][0]
    assert imex_cuda._library_path("iage_year").exists()
    assert imex_cuda._library_path("iage_block") != built["iage_block"][0]
    assert imex_cuda._library_path("iage_block").exists()
    assert not imex_cuda._library_path("phosphorus_year").exists()
