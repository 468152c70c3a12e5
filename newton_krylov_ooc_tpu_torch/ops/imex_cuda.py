"""the py_driver_2d iage year as one hand-written CUDA kernel, and its plain
PyTorch version.

`build_iage_year` is the port of
newton_krylov_ooc_tpu/ops/imex_pallas.py::build_iage_year_pallas_v2: the
same signature, (grid, vert_diag, source, t_span, n_steps) ->
year(y0) with y0 of shape (T, nz, ny), the same float32 numerics, and the
whole year in one launch of csrc/iage_year.cu (see the note at the top of
that file for the design).  Linear models only: with the source zeroed the
year is its own exact tangent map, so IageKernel's JVP runs through it too.

`build_iage_year_plain` returns the same year over ops/imex.py::imex_year.
The wrapper takes the plain version only for tensors on the CPU; for a CUDA
float32 tensor it launches the kernel or raises.

The kernel is compiled from csrc/ with nvcc at first use into
<repo>/build/torch_kernels/, keyed on a hash of the sources and flags, into
a shared library with a plain C interface that ctypes loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models.py_driver_2d import physics
from .compute import resolve_device
from .imex import imex_year

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "iage_year.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEADER = 16  # scalars ahead of the constant fields (csrc/iage_year.cu)

# launches of the CUDA year kernel in this process (one per year(y0) call
# on a CUDA tensor); callers reset it to 0 to count a run's launches
iage_year_launches = 0

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (cuda_home, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def build_library():
    """compile csrc/iage_year.cu into BUILD_DIR unless this source and flag
    set was built before; returns (path of the .so, seconds spent building).
    The ptxas report (registers, shared memory, spills) is kept beside it
    in a .log file."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"iage_year_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    seconds = time.perf_counter() - start
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, seconds


def _library():
    global _lib
    if _lib is None:
        lib_path, _ = build_library()
        lib = ctypes.CDLL(str(lib_path))
        lib.iage_year_fields_len.argtypes = [ctypes.c_int] * 3
        lib.iage_year_fields_len.restype = ctypes.c_long
        lib.iage_year_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.iage_year_smem_bytes.restype = ctypes.c_long
        lib.iage_year_smem_optin.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ]
        lib.iage_year_smem_optin.restype = ctypes.c_int
        lib.iage_year_error_string.argtypes = [ctypes.c_int]
        lib.iage_year_error_string.restype = ctypes.c_char_p
        lib.iage_year_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.iage_year_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cuda_error(lib, err, what):
    msg = lib.iage_year_error_string(err).decode()
    return RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _grid_to(grid, device, dtype):
    return physics.Grid2D(*(f.to(device=device, dtype=dtype) for f in grid))


def _channels(vert_diag, source, nz, ny):
    """(T, nz, ny) implicit diagonal and (T,) source as float64 tensors on
    the CPU"""
    def cpu64(arr):
        if isinstance(arr, torch.Tensor):
            return arr.detach().cpu().to(torch.float64)
        return torch.as_tensor(np.asarray(arr), dtype=torch.float64)

    diag = cpu64(vert_diag)
    t_dim = diag.shape[0]
    diag = diag.reshape(t_dim, nz, ny)
    src = cpu64(source).reshape(-1)
    if src.shape[0] != t_dim:
        raise ValueError(f"source has {src.shape[0]} channels, vert_diag {t_dim}")
    return diag, src


def _check_state(y0, shape, dtype, device):
    if not isinstance(y0, torch.Tensor):
        raise TypeError(f"y0 must be a torch.Tensor, got {type(y0).__name__}")
    if y0.device != device or y0.dtype != dtype:
        raise ValueError(
            f"y0 is {y0.dtype} on {y0.device}; this year takes {dtype} on {device}"
        )
    if tuple(y0.shape) != shape:
        raise ValueError(f"y0 has shape {tuple(y0.shape)}, expected {shape}")
    if not y0.is_contiguous():
        raise ValueError("y0 must be contiguous")


def build_iage_year_plain(grid, vert_diag, source, t_span, n_steps):
    """year(y0: (T, nz, ny)) -> y(t_end) over ops/imex.py::imex_year, in the
    grid's dtype and on the grid's device

    vert_diag: (T, nz, ny) linear local rates folded into the implicit
    solve; source: (T, 1, 1) constant explicit source (zeros for the
    tangent year)
    """
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    diag, src = _channels(vert_diag, source, nz, ny)
    t_dim = diag.shape[0]
    diag = diag.to(device=device, dtype=dtype)
    src = src.to(device=device, dtype=dtype).reshape(t_dim, 1, 1)

    def explicit_tend(t, y):
        return (
            physics.advection_tend(grid, y) + physics.horiz_mix_tend(grid, y)
            + src
        )

    def vert_coeff(t):
        return physics.vert_mixing_coeff(grid, t)

    def year(y0):
        _check_state(y0, (t_dim, nz, ny), dtype, device)
        return imex_year(explicit_tend, vert_coeff, diag, grid.dz_r, y0,
                         t_span, n_steps)

    return year


def _pack_fields(grid, diag, src):
    """the kernel's packed float32 constants, in csrc/iage_year.cu's order:
    header (bld_min, log_shallow, log_deep, tfrac[4], ffrac[4], padding),
    ca, cb (nz, ny-1); wv (nz-1, ny); dy_r; dz_r; dz_mid; dz_mid_r;
    depth_mid; bld_max; src (T); diag (T, nz, ny)"""
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    f32 = _grid_to(grid, torch.device("cpu"), torch.float32)
    tfrac = np.asarray(physics._BLD_TFRAC, np.float64)
    ffrac = np.asarray(physics._BLD_FRAC, np.float64)
    header = np.zeros(_HEADER)
    header[:3] = (physics.BLD_MIN, physics.VERT_MIX_LOG_SHALLOW,
                  physics.VERT_MIX_LOG_DEEP)
    header[3:3 + len(tfrac)] = tfrac
    header[3 + len(tfrac):3 + 2 * len(tfrac)] = ffrac
    vvel_int = f32.vvel[:, 1:-1]
    hmc = f32.horiz_mix_coeff.expand(nz, ny - 1)
    # fused lateral flux G = 0.5(y_l+y_r)v - K(y_r-y_l) = ca*y_l + cb*y_r
    ca = 0.5 * vvel_int + hmc
    cb = 0.5 * vvel_int - hmc
    bld_max = physics.interp(
        grid.ypos_mid.detach().cpu().to(torch.float64),
        physics._BLD_YPOS, physics._BLD_MAX,
    )
    parts = [
        torch.as_tensor(header), ca, cb, f32.wvel[1:-1, :], f32.dy_r, f32.dz_r,
        f32.dz_mid, f32.dz_mid_r, f32.depth_mid, bld_max, src, diag,
    ]
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def build_iage_year(grid, vert_diag, source, t_span, n_steps, *, device):
    """year(y0: (T, nz, ny) float32) -> y(t_end), the whole year in one
    launch of the CUDA kernel on a CUDA `device`; on the CPU, the plain
    version in float32.

    grid: physics.Grid2D (any dtype; the kernel's constants are float32);
    vert_diag: (T, nz, ny) linear local rates folded into the implicit
    solve; source: (T, 1, 1) constant explicit source (zeros for the
    tangent year).  Raises ValueError when the shared-memory plan of one
    channel exceeds what one block may use on the card.
    """
    device = resolve_device(device)
    if device.type == "cpu":
        return build_iage_year_plain(
            _grid_to(grid, device, torch.float32), vert_diag, source, t_span,
            n_steps,
        )

    nz, ny = int(grid.depth_mid.shape[0]), int(grid.ypos_mid.shape[0])
    diag, src = _channels(vert_diag, source, nz, ny)
    t_dim = diag.shape[0]
    fields = _pack_fields(grid, diag, src).to(device)
    lib = _library()
    if lib.iage_year_fields_len(t_dim, nz, ny) != fields.numel():
        raise RuntimeError("packed constants disagree with csrc/iage_year.cu")
    smem = lib.iage_year_smem_bytes(nz, ny)
    limit = ctypes.c_int(0)
    err = lib.iage_year_smem_optin(device.index, ctypes.byref(limit))
    if err:
        raise _cuda_error(lib, err, "querying the shared-memory opt-in limit")
    if smem > limit.value:
        raise ValueError(
            f"the year kernel keeps one {nz}x{ny} channel in shared memory: "
            f"{smem} bytes, over the {limit.value} bytes one block may use on "
            f"{torch.cuda.get_device_name(device)}; grids this large need a "
            "multi-block design"
        )
    t0 = float(t_span[0])
    dt = float((t_span[1] - t_span[0]) / n_steps)
    shape = (t_dim, nz, ny)

    def year(y0):
        global iage_year_launches
        _check_state(y0, shape, torch.float32, device)
        out = torch.empty_like(y0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.iage_year_launch(
                y0.data_ptr(), out.data_ptr(), fields.data_ptr(),
                t_dim, nz, ny, int(n_steps), t0, dt, stream,
            )
        if err:
            raise _cuda_error(lib, err, "iage_year_kernel launch")
        iage_year_launches += 1
        return out

    return year
