"""the py_driver_2d years as hand-written CUDA kernels, each beside its plain
PyTorch version.

`build_iage_year` is the port of
newton_krylov_ooc_tpu/ops/imex_pallas.py::build_iage_year_pallas_v2: the
same signature, (grid, vert_diag, source, t_span, n_steps) ->
year(y0) with y0 of shape (T, nz, ny), the same float32 numerics, and the
whole year in one launch of csrc/iage_year.cu (see the note at the top of
that file for the design).  Linear models only: with the source zeroed the
year is its own exact tangent map, so IageKernel's JVP runs through it too.

`build_iage_year_plain` returns the same year over ops/imex.py::imex_year.

`build_iage_table` builds, with csrc/iage_year.cu's table kernel, what
every CN solve of one such year needs apart from the state: kv on the
interior edges and the Thomas factors (m, w, cp) of each distinct implicit
diagonal (a slot), for each of the year's n_steps + 1 solves.  B1 and B1v1
stream it a step ahead, each channel the factors of its slot (the channel
map in the packed constants); one table serves every year of the same
grid, span and steps whose channels' diagonals are among its slots
(IageKernel's F and JVP years, and the year-operator probe's many channels
of the same two diagonals).  `iage_table_plain` is its plain version,
`cn_increment_factored` the CN increment from its factors (B1's and B2's
chain, serial or in the kernels' scan order) and
`build_iage_year_factored` the year through that increment, in plain
PyTorch.

`build_iage_year_v1` is the port of imex_pallas.py::build_iage_year_pallas,
the first layout of the same year: the same arguments and numerics, the
whole year in one launch of B1v1, csrc/iage_year.cu's PCR variant, whose
CN solves are divide-form PCR as the JAX kernel's.  Its plain version is
build_iage_year_plain, whose ops/tridiag.py::pcr_solve is divide-form PCR.

`build_phosphorus_year` is the port of
newton_krylov_ooc_tpu/ops/imex_pallas.py::build_phosphorus_year_pallas:
(grid, params, light_lim, t_span, n_steps) -> year(y0) with y0 the
(3, nz, ny) po4/dop/pop state, the whole coupled year in one launch of
csrc/phosphorus_year.cu.  It streams B1's table of one channel with a zero
implicit diagonal (`build_phosphorus_table`), whose factors serve the three
tracers.  Forward only: the model is nonlinear, so its Jacobian-vector
products go through forward-mode AD of the plain year
(models/py_driver_2d/incore.py::PhosphorusKernel.jvp), as the JAX package
keeps them off its kernel.  `build_phosphorus_year_plain` is imex_year over
models/py_driver_2d/phosphorus.py::explicit_tend with a zero implicit
diagonal; `build_phosphorus_year_factored` is the kernel's step in plain
PyTorch (the table's factors, the scan chain, the Kahan adds).

Each wrapper takes the plain version only on the CPU; for a CUDA float32
tensor it launches its kernel or raises.  Each kernel source is compiled
with nvcc at first use into <repo>/build/torch_kernels/, keyed on a hash of
its sources and flags, into a shared library with a plain C interface that
ctypes loads.  The build knows every kernel source of the port (SOURCES),
the 3D transport years of ops/transport3d_cuda.py and
ops/transport3d_stream_cuda.py, the IMEX step block of
ops/imex_block_cuda.py, the stream sweep of
ops/transport3d_sweep_cuda.py and the 3D step block of
ops/transport3d_block_cuda.py included, so one build_libraries() call
compiles them all at once.
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

from ..models.py_driver_2d import phosphorus, physics
from .compute import resolve_device
from .imex import imex_year

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# kernel name -> its source, and the headers under csrc/ that it includes
SOURCES = {
    "iage_year": "iage_year.cu",
    "phosphorus_year": "phosphorus_year.cu",
    "transport3d_year": "transport3d_year.cu",
    "transport3d_stream": "transport3d_stream.cu",
    "iage_block": "iage_block.cu",
    "transport3d_sweep": "transport3d_sweep.cu",
    "transport3d_block": "transport3d_block.cu",
}
INCLUDES = {
    "iage_year": ("imex_common.cuh", "imex_table.cuh"),
    "phosphorus_year": ("imex_common.cuh", "imex_table.cuh"),
    "transport3d_year": ("transport3d_common.cuh",),
    "transport3d_stream": ("transport3d_stream_passes.cuh",
                           "transport3d_common.cuh"),
    "iage_block": ("imex_common.cuh",),
    "transport3d_sweep": ("transport3d_stream_passes.cuh",
                          "transport3d_common.cuh"),
    "transport3d_block": ("transport3d_stream_passes.cuh",
                          "transport3d_common.cuh"),
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEADER = 16  # scalars ahead of the constant fields (csrc/imex_common.cuh)
_PARAMS = 8   # phosphorus scalars after them (csrc/phosphorus_year.cu)
_PHOS_TRACERS = 3  # po4, dop, pop
# csrc/phosphorus_year.cu's cluster: kCtas blocks of kThreads threads at most;
# csrc/iage_year.cu's block: kThreads
_PHOS_CTAS = 4
_PHOS_THREADS = 256
_IAGE_THREADS = 864

# launches of each CUDA year kernel in this process (one per year(y0) call
# on a CUDA tensor); callers reset them to 0 to count a run's launches
iage_year_launches = 0
iage_year_v1_launches = 0
iage_table_launches = 0
phosphorus_year_launches = 0

_libs = {}

# how many shape ints <name>_fields_len and <name>_launch take: t_dim, nz,
# ny (and n_slots after t_dim in the launch) for iage; nz, ny for phosphorus
_SHAPE_ARGS = {"iage_year": 3, "phosphorus_year": 2}
# csrc/iage_year.cu's table: each part padded to _TABLE_ALIGN floats (its
# kAlign); _TABLE_FACTORS (kFactors) fields a channel: m, w, cp
_TABLE_ALIGN = 4
_TABLE_FACTORS = 3


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (cuda_home, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _library_path(name):
    """where kernel `name`'s library goes: keyed on its source, the headers
    it includes and the flags"""
    digest = hashlib.sha256()
    for fname in (SOURCES[name], *INCLUDES[name]):
        digest.update((CSRC / fname).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names=tuple(SOURCES)):
    """compile each named kernel source that was not built before, one nvcc
    process each, all started together; returns {name: (path of the .so,
    seconds spent building it)}.  Each ptxas report (registers, shared
    memory, spills) is kept beside its library in a .log file."""
    running = {}
    todo = [name for name in names if not _library_path(name).exists()]
    built = {name: (_library_path(name), 0.0) for name in names
             if name not in todo}
    nvcc = _nvcc() if todo else None
    for name in todo:
        lib_path = _library_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[name] = (proc, lib_path, tmp, time.perf_counter())
    failures = []
    for name, (proc, lib_path, tmp, start) in running.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - start
        lib_path.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) on "
                            f"{SOURCES[name]}:\n{err}")
            continue
        os.replace(tmp, lib_path)
        built[name] = (lib_path, seconds)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def load_library(name, signatures):
    """kernel `name`'s library (built first if needed), loaded once with
    ctypes; signatures: {suffix: (argtypes, restype)} of its C functions
    <name>_<suffix>, besides <name>_error_string, which every kernel has"""
    if name not in _libs:
        lib_path, _ = build_libraries((name,))[name]
        lib = ctypes.CDLL(str(lib_path))
        signatures = {**signatures,
                      "error_string": ([ctypes.c_int], ctypes.c_char_p)}
        for suffix, (argtypes, restype) in signatures.items():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes, restype
        _libs[name] = lib
    return _libs[name]


def _library(name):
    c_int, c_ptr, c_long = ctypes.c_int, ctypes.c_void_p, ctypes.c_long
    c_float = ctypes.c_float
    shape = [c_int] * _SHAPE_ARGS[name]
    # y0, out, fields, table, shape (t_dim, n_slots, nz, ny for iage),
    # n_steps, then t0 and dt (iage) or dt (phosphorus), stream
    iage = name == "iage_year"
    times = [c_float] * (2 if iage else 1)
    launch = ([c_ptr] * 4 + shape + [c_int] * (2 if iage else 1) + times
              + [c_ptr], c_int)
    signatures = {
        "fields_len": (shape, c_long),
        "smem_bytes": ([c_int] * 2, c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        "levels": ([c_int] * 2, c_int),
        "launch": launch,
    }
    if name == "iage_year":
        # B1v1, the PCR variant, and the table kernel in the same library
        signatures.update(
            v1_smem_bytes=([c_int] * 2, c_long),
            v1_launch=launch,
            kv_floats=([c_int] * 2, c_long),
            factor_floats=([c_int] * 2, c_long),
            table_floats=([c_int] * 4, c_long),
            table_launch=([c_ptr] * 2 + [c_int] * 4 + [c_float] * 2
                          + [c_ptr], c_int),
        )
    return load_library(name, signatures)


def cuda_error(lib, name, err, what):
    msg = getattr(lib, f"{name}_error_string")(err).decode()
    return RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check_smem(lib, name, nz, ny, device, what, variant=""):
    """raise ValueError when kernel `name`'s shared-memory plan at nz x ny
    (counted by its <name>_<variant>smem_bytes) exceeds the card's opt-in
    limit"""
    smem = getattr(lib, f"{name}_{variant}smem_bytes")(nz, ny)
    limit = ctypes.c_int(0)
    err = getattr(lib, f"{name}_smem_optin")(device.index, ctypes.byref(limit))
    if err:
        raise cuda_error(lib, name, err,
                          "querying the shared-memory opt-in limit")
    if smem > limit.value:
        raise ValueError(
            f"the {name} kernel keeps {what} in shared memory: {smem} bytes "
            f"at {nz}x{ny}, over the {limit.value} bytes one block may use "
            f"on {torch.cuda.get_device_name(device)}; grids this large need "
            "a multi-block design"
        )


def _grid_to(grid, device, dtype):
    return physics.Grid2D(*(f.to(device=device, dtype=dtype) for f in grid))


def _cpu64(arr):
    """a numpy array or tensor as a float64 tensor on the CPU"""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().to(torch.float64)
    return torch.as_tensor(np.asarray(arr), dtype=torch.float64)


def _channels(vert_diag, source, nz, ny):
    """(T, nz, ny) implicit diagonal and (T,) source as float64 tensors on
    the CPU"""
    diag = _cpu64(vert_diag)
    t_dim = diag.shape[0]
    diag = diag.reshape(t_dim, nz, ny)
    src = _cpu64(source).reshape(-1)
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


def mixing_header():
    """the scalars every 2D kernel starts with (csrc/imex_common.cuh's
    Header): bld_min, log_shallow, log_deep, tfrac[4], ffrac[4], padding"""
    tfrac = np.asarray(physics._BLD_TFRAC, np.float64)
    ffrac = np.asarray(physics._BLD_FRAC, np.float64)
    header = np.zeros(_HEADER)
    header[:3] = (physics.BLD_MIN, physics.VERT_MIX_LOG_SHALLOW,
                  physics.VERT_MIX_LOG_DEEP)
    header[3:3 + len(tfrac)] = tfrac
    header[3 + len(tfrac):3 + 2 * len(tfrac)] = ffrac
    return torch.as_tensor(header)


def _header_and_grid(grid):
    """the packed float32 constants both kernels start with, in
    csrc/imex_common.cuh's order: header, ca, cb (nz, ny-1); wv (nz-1, ny);
    dy_r; dz_r; dz_mid; dz_mid_r; depth_mid; bld_max -- header first, grid
    after"""
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    f32 = _grid_to(grid, torch.device("cpu"), torch.float32)
    vvel_int = f32.vvel[:, 1:-1]
    hmc = f32.horiz_mix_coeff.expand(nz, ny - 1)
    # fused lateral flux G = 0.5(y_l+y_r)v - K(y_r-y_l) = ca*y_l + cb*y_r
    ca = 0.5 * vvel_int + hmc
    cb = 0.5 * vvel_int - hmc
    bld_max = physics.interp(
        grid.ypos_mid.detach().cpu().to(torch.float64),
        physics._BLD_YPOS, physics._BLD_MAX,
    )
    grid_parts = [
        ca, cb, f32.wvel[1:-1, :], f32.dy_r, f32.dz_r, f32.dz_mid,
        f32.dz_mid_r, f32.depth_mid, bld_max,
    ]
    return mixing_header(), grid_parts


def _flat32(parts):
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def _pack_fields(grid, diag, src, slot_map):
    """the iage kernel's packed float32 constants: header, grid fields,
    src (T), diag (T, nz, ny), and each channel's factor slot (T, integers
    as floats)"""
    header, grid_parts = _header_and_grid(grid)
    return _flat32([header, *grid_parts, src, diag,
                    torch.as_tensor(slot_map, dtype=torch.float64)])


def _align(floats):
    return -(-floats // _TABLE_ALIGN) * _TABLE_ALIGN


def table_layout(t_dim, nz, ny, n_steps):
    """csrc/iage_year.cu's table layout of t_dim slots, in floats: each of
    the n_steps + 1 solves holds kv (nz-1, ny), then each slot's m, w, cp
    (nz, ny) in turn, each part padded to _TABLE_ALIGN floats"""
    kv = _align((nz - 1) * ny)
    factors = _align(_TABLE_FACTORS * nz * ny)
    solve = kv + t_dim * factors
    floats = (n_steps + 1) * solve
    return {"kv_floats": kv, "factor_floats": factors, "solve_floats": solve,
            "solves": n_steps + 1, "floats": floats, "bytes": 4 * floats}


def solve_times(t_span, n_steps):
    """(times, h) of a year's n_steps + 1 CN solves, as float64 arrays: the
    leading dt/2 at t0, the merged dt solve after each step i < n_steps - 1
    at t0 + (i + 1) dt, the trailing dt/2 at the year's end"""
    t0 = float(t_span[0])
    dt = (float(t_span[1]) - t0) / n_steps
    times = t0 + dt * np.arange(n_steps + 1)
    h = np.full(n_steps + 1, dt)
    h[0] = h[-1] = 0.5 * dt
    return times, h


def iage_table_plain(grid, vert_diag, times, h, factor_dtype=None):
    """(kv, m, w, cp) of CN solves at `times` over steps `h`, in the grid's
    dtype and on its device: kv (S, nz-1, ny) from
    physics.vert_mixing_coeff, and the Thomas factors (S, T, nz, ny) of each
    channel's (I - h/2 (Lz + diag)): m = a / denom, w = 1 / denom,
    cp = c / denom, with denom = b - a cp of the level above -- csrc/
    iage_year.cu's iage_table_kernel in plain PyTorch.  factor_dtype: the
    dtype the factors are formed in from kv, dz_r and diag (by default the
    grid's), each rounded once to the grid's dtype"""
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    work = dtype if factor_dtype is None else factor_dtype
    diag = _cpu64(vert_diag).reshape(-1, nz, ny).to(device=device,
                                                    dtype=dtype).to(work)
    kv = torch.stack([physics.vert_mixing_coeff(grid, float(t))
                      for t in times])
    kv_w, dz_r = kv.to(work), grid.dz_r.to(work)
    half = 0.5 * torch.as_tensor(np.asarray(h), dtype=work,
                                 device=device)[:, None, None, None]
    zero = kv_w.new_zeros(kv.shape[0], 1, ny)
    du = torch.cat([kv_w * dz_r[:-1, None], zero], dim=1)[:, None]
    dl = torch.cat([zero, kv_w * dz_r[1:, None]], dim=1)[:, None]
    dmain = -(du + dl) + diag
    a = (-half * dl).expand_as(dmain)
    b = 1.0 - half * dmain
    c = (-half * du).expand_as(dmain)
    m, w, cp = (torch.empty_like(dmain) for _ in range(3))
    cp_prev = torch.zeros_like(dmain[..., 0, :])
    for k in range(nz):
        denom = b[..., k, :] - a[..., k, :] * cp_prev
        cp_prev = c[..., k, :] / denom
        m[..., k, :] = a[..., k, :] / denom
        w[..., k, :] = 1.0 / denom
        cp[..., k, :] = cp_prev
    return kv, m.to(dtype), w.to(dtype), cp.to(dtype)


def pack_table(kv, m, w, cp):
    """the float32 table of iage_table_plain's fields in csrc/iage_year.cu's
    layout (table_layout), padding zero"""
    n_solves, t_dim, nz, ny = m.shape
    layout = table_layout(t_dim, nz, ny, n_solves - 1)
    solves = torch.zeros((n_solves, layout["solve_floats"]),
                         dtype=torch.float32, device=m.device)
    solves[:, :(nz - 1) * ny] = kv.reshape(n_solves, -1)
    factors = solves[:, layout["kv_floats"]:].view(
        n_solves, t_dim, layout["factor_floats"])
    factors[..., :_TABLE_FACTORS * nz * ny] = torch.stack(
        [m, w, cp], dim=2).reshape(n_solves, t_dim, -1)
    return solves.reshape(-1)


def unpack_table(table, t_dim, nz, ny, n_steps):
    """(kv (S, nz-1, ny), m, w, cp (S, T, nz, ny)) views of a table in
    csrc/iage_year.cu's layout"""
    layout = table_layout(t_dim, nz, ny, n_steps)
    if table.numel() != layout["floats"]:
        raise ValueError(f"a table of {table.numel()} floats; this layout "
                         f"holds {layout['floats']}")
    solves = table.view(layout["solves"], layout["solve_floats"])
    kv = solves[:, :(nz - 1) * ny].reshape(-1, nz - 1, ny)
    factors = solves[:, layout["kv_floats"]:].reshape(
        -1, t_dim, layout["factor_floats"])[..., :_TABLE_FACTORS * nz * ny]
    m, w, cp = factors.reshape(-1, t_dim, _TABLE_FACTORS, nz, ny).unbind(2)
    return kv, m, w, cp


class IageTable:
    """the state-independent part of every CN solve of an iage year
    (csrc/iage_year.cu's table), for the year functions that share it

    tensor: the float32 table on its device (table_layout); key: the packed
    float32 grid and slot diagonals it was built from (_table_key); shape
    (S, nz, ny): its S slots, one a distinct implicit diagonal; n_steps,
    t0, dt: the year's.
    """

    def __init__(self, tensor, key, shape, n_steps, t0, dt, events=None):
        self.tensor = tensor
        self.key = key
        self.shape = shape
        self.n_steps = n_steps
        self.t0 = t0
        self.dt = dt
        self._events = events

    @property
    def nbytes(self):
        return self.tensor.numel() * self.tensor.element_size()

    def build_ms(self):
        """ms of the table kernel's launch on the card (waits for it)"""
        if self._events is None:
            raise ValueError("a table built on the CPU has no launch to time")
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def check(self, key, shape, n_steps, t0, dt, device):
        """the channel map of a year of these constants on this table: a
        (T,) int64 tensor, each channel's slot, the first whose diagonal is
        the channel's.  Raises ValueError unless the grid, span, steps and
        device are the table's and every channel's diagonal is one of its
        slots.

        key: _table_key(grid, diag) of the year's (T, nz, ny) diagonal;
        shape: (T, nz, ny)"""
        t_dim, nz, ny = shape
        n = nz * ny
        grid_len = key.numel() - t_dim * n
        slots = self.shape[0]
        if (self.tensor.device == device and self.shape[1:] == (nz, ny)
                and self.n_steps == n_steps and self.t0 == t0
                and self.dt == dt
                and self.key.numel() - slots * n == grid_len
                and torch.equal(self.key[:grid_len], key[:grid_len])):
            rows = key[grid_len:].view(t_dim, n)
            match = (rows[:, None, :]
                     == self.key[grid_len:].view(slots, n)[None]).all(-1)
            if bool(match.any(dim=1).all()):
                return match.to(torch.int64).argmax(dim=1)
        raise ValueError(
            "the table was built for another year (grid, implicit "
            "diagonal, span, steps or device)")


def _time_step(t_span, n_steps):
    """(t0, dt) of a year of n_steps, refusing n_steps < 1"""
    if int(n_steps) < 1:
        raise ValueError(f"a year takes at least one step, got {n_steps}")
    return float(t_span[0]), float((t_span[1] - t_span[0]) / n_steps)


def _table_key(grid, diag):
    header, grid_parts = _header_and_grid(grid)
    return _flat32([header, *grid_parts, diag])


def table_slots(diag):
    """the distinct float32 channel diagonals of a (T, nz, ny) implicit
    diagonal in the order they first appear, as a (S, nz, ny) float64
    tensor: a table's slots (IageTable.check maps each channel to one)"""
    rows = _cpu64(diag)
    flat = rows.reshape(rows.shape[0], -1).to(torch.float32)
    firsts = []
    for ch, row in enumerate(flat):
        if not any(torch.equal(flat[first], row) for first in firsts):
            firsts.append(ch)
    return rows[firsts]


def check_table_bytes(nbytes, free, total, device_name):
    """raise ValueError when a table of `nbytes` does not fit the `free` of
    `total` bytes on a card, before it is allocated"""
    if nbytes > free:
        raise ValueError(
            f"the iage table needs {nbytes} bytes ({nbytes / 2**30:.2f} GiB); "
            f"{free} of {total} bytes are free on {device_name}: fewer "
            "distinct implicit diagonals, steps or cells, or more room, "
            "are needed")


def build_iage_table(grid, vert_diag, t_span, n_steps, *, device):
    """the table of a year's n_steps + 1 CN solves, one slot for each
    distinct channel diagonal of vert_diag (table_slots): one launch of
    csrc/iage_year.cu's table kernel on a CUDA `device` (one thread a solve
    and column, over every SM), after checking that the card has room for
    it; on the CPU, iage_table_plain's fields packed in float32.  grid,
    vert_diag, t_span and n_steps as build_iage_year's; the table serves
    every year of them, whatever its source, and every year whose channels'
    diagonals are among its slots."""
    global iage_table_launches
    device = resolve_device(device)
    nz, ny = int(grid.depth_mid.shape[0]), int(grid.ypos_mid.shape[0])
    diag = table_slots(_cpu64(vert_diag).reshape(-1, nz, ny))
    t0, dt = _time_step(t_span, n_steps)
    t_dim = diag.shape[0]
    shape, n_steps = (t_dim, nz, ny), int(n_steps)
    key = _table_key(grid, diag)
    layout = table_layout(t_dim, nz, ny, n_steps)
    if device.type == "cpu":
        times, h = solve_times(t_span, n_steps)
        tensor = pack_table(*iage_table_plain(
            _grid_to(grid, device, torch.float32), diag, times, h))
        return IageTable(tensor, key, shape, n_steps, t0, dt)

    lib = _library("iage_year")
    for part in ("kv_floats", "factor_floats"):
        if getattr(lib, f"iage_year_{part}")(nz, ny) != layout[part]:
            raise RuntimeError("the table layout disagrees with "
                               "csrc/iage_year.cu")
    if lib.iage_year_table_floats(t_dim, nz, ny, n_steps) != layout["floats"]:
        raise RuntimeError("the table layout disagrees with csrc/iage_year.cu")
    check_table_bytes(layout["bytes"], *torch.cuda.mem_get_info(device),
                      torch.cuda.get_device_name(device))
    fields = _pack_fields(grid, diag, torch.zeros(t_dim),
                          torch.arange(t_dim)).to(device)
    tensor = torch.zeros(layout["floats"], dtype=torch.float32, device=device)
    events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        events[0].record(stream)
        err = lib.iage_year_table_launch(
            fields.data_ptr(), tensor.data_ptr(), t_dim, nz, ny, n_steps, t0,
            dt, stream.cuda_stream)
        events[1].record(stream)
    if err:
        raise cuda_error(lib, "iage_year", err, "iage_table_kernel launch")
    iage_table_launches += 1
    return IageTable(tensor, key, shape, n_steps, t0, dt, events)


def column_lanes(ny, threads=_IAGE_THREADS):
    """lanes a column (G) of csrc/iage_year.cu and csrc/phosphorus_year.cu
    (csrc/imex_table.cuh's column_lanes): the largest power of two <= 32
    with the columns' warps and the producer warp within `threads` (their
    kThreads)"""
    lanes = 32
    while lanes > 1 and -(-lanes * ny // 32) * 32 + 32 > threads:
        lanes //= 2
    return lanes


def _fma(a, b, c):
    """a b + c rounded once, as the card's fmaf: float32 operands multiply
    exactly in float64"""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def _scan_recurrence(v, mult, lanes, reverse):
    """x_k = v_k + mult_k x_{k-1} (x_{k+1} if reverse) down the level axis
    (-2) of v, in the kernels' order: the levels dealt to `lanes` lanes, M
    contiguous levels each; each lane composes its levels' affine maps,
    log2(lanes) Hillis-Steele rounds over the lanes give each its carry,
    and the lane applies its maps from it (fmaf as the card rounds it)"""
    nz = v.shape[-2]
    levels = -(-nz // lanes)
    pad = lanes * levels - nz
    # lane l owns levels l M .. l M + M - 1; levels past nz hold 0
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    mult = torch.nn.functional.pad(mult.expand(v.shape[:-2] + (nz, -1)),
                                   (0, 0, 0, pad))
    if reverse:
        v, mult = v.flip(-2), mult.flip(-2)
    shape = v.shape[:-2] + (lanes, levels, v.shape[-1])
    vl, ml = v.reshape(shape), mult.reshape(shape)
    big_a = torch.ones_like(vl[..., 0, :])
    big_b = torch.zeros_like(big_a)
    for lvl in range(levels):
        big_b = _fma(ml[..., lvl, :], big_b, vl[..., lvl, :])
        big_a = ml[..., lvl, :] * big_a
    lane = torch.arange(lanes, device=v.device)[:, None]
    dist = 1
    while dist < lanes:
        prev_a = torch.roll(big_a, dist, dims=-2)
        prev_b = torch.roll(big_b, dist, dims=-2)
        on = lane >= dist
        big_b = torch.where(on, _fma(big_a, prev_b, big_b), big_b)
        big_a = torch.where(on, big_a * prev_a, big_a)
        dist *= 2
    x = torch.roll(big_b, 1, dims=-2)
    x = torch.where(lane == 0, torch.zeros_like(x), x)
    out = torch.empty_like(vl)
    for lvl in range(levels):
        x = _fma(ml[..., lvl, :], x, vl[..., lvl, :])
        out[..., lvl, :] = x
    out = out.reshape(v.shape)
    return (out.flip(-2) if reverse else out)[..., :nz, :]


def cn_increment_factored(kv, m, w, cp, diag, dz_r, v, h, lanes=None):
    """the Crank-Nicolson increment of ops/imex.py::cn_vertical_increment
    from a table's factors, as B1 and B2 compute it: r' = h (Lz + diag) v w,
    gp_k = r'_k - m_k gp_{k-1} down the column, x_k = gp_k - cp_k x_{k+1}
    up it -- serially (lanes None), or as the kernels' affine-map scans
    over `lanes` lanes a column (_scan_recurrence)

    kv: (nz-1, ny); m, w, cp, diag, v: (..., nz, ny), leading axes batched
    """
    flux = kv * (v[..., 1:, :] - v[..., :-1, :])
    zrow = v.new_zeros(v.shape[:-2] + (1, v.shape[-1]))
    rhs = h * (dz_r[:, None] * (torch.cat([flux, zrow], dim=-2)
                                - torch.cat([zrow, flux], dim=-2)) + diag * v)
    r = rhs * w
    if lanes is not None:
        gp = _scan_recurrence(r, -m, lanes, reverse=False)
        return _scan_recurrence(gp, -cp, lanes, reverse=True)
    nz = v.shape[-2]
    gp = torch.empty_like(r)
    g = torch.zeros_like(r[..., 0, :])
    for k in range(nz):
        g = r[..., k, :] - m[..., k, :] * g
        gp[..., k, :] = g
    x = torch.empty_like(r)
    xk = torch.zeros_like(g)
    for k in range(nz - 1, -1, -1):
        xk = gp[..., k, :] - cp[..., k, :] * xk
        x[..., k, :] = xk
    return x


def _factored_year(tend, grid, diag, shape, t_span, n_steps, factor_dtype,
                   lanes):
    """year(y0) of ops/imex.py::imex_year's scheme with each CN solve from
    iage_table_plain's factors (cn_increment_factored) and the explicit
    tendency tend(y), in the grid's dtype and on its device"""
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    times, h = solve_times(t_span, n_steps)
    kv, m, w, cp = iage_table_plain(grid, diag, times, h, factor_dtype)
    dt = (float(t_span[1]) - float(t_span[0])) / n_steps

    def kahan(y, comp, delta):
        adj = delta + comp
        y_new = y + adj
        return y_new, adj - (y_new - y)

    def cn(s, y):
        return cn_increment_factored(kv[s], m[s], w[s], cp[s], diag,
                                     grid.dz_r, y, float(h[s]), lanes)

    def year(y0):
        _check_state(y0, shape, dtype, device)
        y, comp = kahan(y0, torch.zeros_like(y0), cn(0, y0))
        for step in range(n_steps):
            f1 = tend(y)
            f2 = tend(y + dt * f1)
            y, comp = kahan(y, comp, 0.5 * dt * (f1 + f2))
            y, comp = kahan(y, comp, cn(step + 1, y))
        return y

    return year


def build_iage_year_factored(grid, vert_diag, source, t_span, n_steps,
                             factor_dtype=None, lanes=None):
    """year(y0: (T, nz, ny)) -> y(t_end) in the grid's dtype and on its
    device: B1's step in plain PyTorch -- ops/imex.py::imex_year's scheme
    with each CN solve from iage_table_plain's factors
    (cn_increment_factored).  factor_dtype: the dtype the table's factors
    are formed in (by default the grid's); lanes: None for the serial
    chain, else the kernel's scan over that many lanes a column"""
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    diag, src = _channels(vert_diag, source, nz, ny)
    t_dim = diag.shape[0]
    diag = diag.to(device=device, dtype=dtype)
    src = src.to(device=device, dtype=dtype).reshape(t_dim, 1, 1)

    def tend(y):
        return (physics.advection_tend(grid, y)
                + physics.horiz_mix_tend(grid, y) + src)

    return _factored_year(tend, grid, diag, (t_dim, nz, ny), t_span, n_steps,
                          factor_dtype, lanes)


def build_iage_year(grid, vert_diag, source, t_span, n_steps, *, device,
                    table=None):
    """year(y0: (T, nz, ny) float32) -> y(t_end), the whole year in one
    launch of the CUDA kernel on a CUDA `device`; on the CPU, the plain
    version in float32.

    grid: physics.Grid2D (any dtype; the kernel's constants are float32);
    vert_diag: (T, nz, ny) linear local rates folded into the implicit
    solve; source: (T, 1, 1) constant explicit source (zeros for the
    tangent year); table: an IageTable of build_iage_table for the same
    grid, t_span and n_steps whose slots hold every channel's diagonal,
    shared with other years (by default the year builds its own, a slot for
    each distinct diagonal); each channel streams the factors of its slot
    (IageTable.check's map).  Raises ValueError when the table does not
    serve this year, the shared-memory plan of one channel exceeds what one
    block may use on the card, or a lane would own more levels than the
    kernel takes.
    """
    return _iage_year(grid, vert_diag, source, t_span, n_steps, device, "",
                      table)


def build_iage_year_v1(grid, vert_diag, source, t_span, n_steps, *, device,
                       table=None):
    """year(y0: (T, nz, ny) float32) -> y(t_end), build_iage_year_pallas's
    year: the whole year in one launch of B1v1 (its CN solves by PCR over
    each column's lanes) on a CUDA `device`; on the CPU, the plain version
    in float32, whose column solves are divide-form PCR.  Arguments and
    refusals as build_iage_year's."""
    return _iage_year(grid, vert_diag, source, t_span, n_steps, device, "v1_",
                      table)


def _iage_year(grid, vert_diag, source, t_span, n_steps, device, variant,
               table):
    """the iage year on B1 (variant "") or B1v1 (variant "v1_")"""
    device = resolve_device(device)
    if device.type == "cpu":
        return build_iage_year_plain(
            _grid_to(grid, device, torch.float32), vert_diag, source, t_span,
            n_steps,
        )

    nz, ny = int(grid.depth_mid.shape[0]), int(grid.ypos_mid.shape[0])
    diag, src = _channels(vert_diag, source, nz, ny)
    t0, dt = _time_step(t_span, n_steps)
    t_dim = diag.shape[0]
    shape, n_steps = (t_dim, nz, ny), int(n_steps)
    lib = _library("iage_year")
    if not lib.iage_year_levels(nz, ny):
        raise ValueError(
            f"the iage_year kernel takes columns of 2 to 256 levels, each on "
            f"at most 32 lanes of one block and 8 levels a lane: {nz}x{ny} "
            "does not fit")
    _check_smem(lib, "iage_year", nz, ny, device, "one channel's year",
                variant)
    if table is None:
        table = build_iage_table(grid, diag, t_span, n_steps, device=device)
    slot_map = table.check(_table_key(grid, diag), shape, n_steps, t0, dt,
                           device)
    n_slots = table.shape[0]
    fields = _pack_fields(grid, diag, src, slot_map).to(device)
    if lib.iage_year_fields_len(t_dim, nz, ny) != fields.numel():
        raise RuntimeError("packed constants disagree with csrc/iage_year.cu")
    launch = getattr(lib, f"iage_year_{variant}launch")

    def year(y0):
        global iage_year_launches, iage_year_v1_launches
        _check_state(y0, shape, torch.float32, device)
        out = torch.empty_like(y0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = launch(
                y0.data_ptr(), out.data_ptr(), fields.data_ptr(),
                table.tensor.data_ptr(), t_dim, n_slots, nz, ny, n_steps, t0,
                dt, stream,
            )
        if err:
            raise cuda_error(lib, "iage_year", err,
                             f"iage_year_kernel {variant}launch")
        if variant:
            iage_year_v1_launches += 1
        else:
            iage_year_launches += 1
        return out

    return year


def _light_field(light_lim, nz, ny):
    return _cpu64(light_lim).reshape(nz, ny)


def build_phosphorus_year_plain(grid, params, light_lim, t_span, n_steps):
    """year(y0: (3, nz, ny)) -> y(t_end) over ops/imex.py::imex_year with
    the phosphorus explicit tendency and no implicit diagonal, in the grid's
    dtype and on the grid's device (the JAX in-core kernel's scan year,
    models/py_driver_2d/incore.py:349-385)

    params: the phosphorus parameter dict; light_lim: (nz, ny) light
    limitation (numpy array or tensor)
    """
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    light = _light_field(light_lim, nz, ny).to(device=device, dtype=dtype)
    params = {key: float(val) for key, val in params.items()}
    diag = torch.zeros((), dtype=dtype, device=device)
    shape = (_PHOS_TRACERS, nz, ny)

    def explicit_tend(t, y):
        return phosphorus.explicit_tend(grid, params, light, y)

    def vert_coeff(t):
        return physics.vert_mixing_coeff(grid, t)

    def year(y0):
        _check_state(y0, shape, dtype, device)
        return imex_year(explicit_tend, vert_coeff, diag, grid.dz_r, y0,
                         t_span, n_steps)

    return year


def _pack_phosphorus_fields(grid, params, light):
    """the phosphorus kernel's packed float32 constants, in
    csrc/phosphorus_year.cu's order: header; params (po4_halfsat,
    max_uptake_rate, sigma, 1 - sigma, dop_remin_rate, pop_remin_rate,
    pop_sink_vel, padding); grid fields; light (nz, ny)"""
    header, grid_parts = _header_and_grid(grid)
    scalars = np.zeros(_PARAMS)
    scalars[:7] = (
        params["po4_halfsat"], params["max_uptake_rate"], params["sigma"],
        1.0 - params["sigma"], params["dop_remin_rate"],
        params["pop_remin_rate"], params["pop_sink_vel"],
    )
    return _flat32([header, torch.as_tensor(scalars), *grid_parts, light])


def _zero_diag(nz, ny):
    """the phosphorus year's implicit diagonal: none, one channel"""
    return torch.zeros((1, nz, ny), dtype=torch.float64)


def build_phosphorus_table(grid, t_span, n_steps, *, device):
    """the table of a phosphorus year's n_steps + 1 CN solves: B1's table
    (build_iage_table) of one channel with a zero implicit diagonal, whose
    factors serve the three tracers"""
    nz, ny = int(grid.depth_mid.shape[0]), int(grid.ypos_mid.shape[0])
    return build_iage_table(grid, _zero_diag(nz, ny), t_span, n_steps,
                            device=device)


def phosphorus_lanes(ny):
    """lanes a column (G) of csrc/phosphorus_year.cu at ny columns: its
    kCtas blocks each own ceil(ny / kCtas) columns within kThreads"""
    return column_lanes(-(-ny // _PHOS_CTAS), _PHOS_THREADS)


def build_phosphorus_year_factored(grid, params, light_lim, t_span, n_steps):
    """year(y0: (3, nz, ny)) -> y(t_end) in the grid's dtype and on its
    device: B2's step in plain PyTorch -- the plain year's scheme and
    tendency with each CN solve from the zero-diagonal table's factors,
    the chain as the kernel's scans over its lanes a column
    (phosphorus_lanes) and the Kahan adds"""
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    dtype, device = grid.depth_mid.dtype, grid.depth_mid.device
    light = _light_field(light_lim, nz, ny).to(device=device, dtype=dtype)
    params = {key: float(val) for key, val in params.items()}
    diag = _zero_diag(nz, ny).to(device=device, dtype=dtype)

    def tend(y):
        return phosphorus.explicit_tend(grid, params, light, y)

    return _factored_year(tend, grid, diag, (_PHOS_TRACERS, nz, ny), t_span,
                          n_steps, None, phosphorus_lanes(ny))


def build_phosphorus_year(grid, params, light_lim, t_span, n_steps, *,
                          device, table=None):
    """year(y0: (3, nz, ny) float32) -> y(t_end), the whole coupled year in
    one launch of the CUDA kernel on a CUDA `device`; on the CPU, the plain
    version in float32.

    grid: physics.Grid2D (any dtype; the kernel's constants are float32);
    params: the phosphorus parameter dict; light_lim: (nz, ny) light
    limitation; table: an IageTable of build_phosphorus_table for the same
    grid, t_span and n_steps, shared with other years (by default the year
    builds its own).  Raises ValueError when the grid does not fit the
    kernel's lanes or its shared-memory plan exceeds what one block may use
    on the card.
    """
    device = resolve_device(device)
    if device.type == "cpu":
        return build_phosphorus_year_plain(
            _grid_to(grid, device, torch.float32), params, light_lim, t_span,
            n_steps,
        )

    nz, ny = int(grid.depth_mid.shape[0]), int(grid.ypos_mid.shape[0])
    light = _light_field(light_lim, nz, ny)
    fields = _pack_phosphorus_fields(grid, params, light).to(device)
    lib = _library("phosphorus_year")
    if lib.phosphorus_year_fields_len(nz, ny) != fields.numel():
        raise RuntimeError(
            "packed constants disagree with csrc/phosphorus_year.cu"
        )
    if not lib.phosphorus_year_levels(nz, ny):
        raise ValueError(
            f"the phosphorus_year kernel takes columns of at least 2 levels "
            f"on at most 32 lanes of its blocks and 4 levels a lane, and at "
            f"least {_PHOS_CTAS} columns: {nz}x{ny} does not fit")
    _check_smem(lib, "phosphorus_year", nz, ny, device,
                "the 3-tracer year's slots and published state")
    t0, dt = _time_step(t_span, n_steps)
    shape, n_steps = (_PHOS_TRACERS, nz, ny), int(n_steps)
    if table is None:
        table = build_phosphorus_table(grid, t_span, n_steps, device=device)
    else:
        table.check(_table_key(grid, _zero_diag(nz, ny)), (1, nz, ny),
                    n_steps, t0, dt, device)

    def year(y0):
        global phosphorus_year_launches
        _check_state(y0, shape, torch.float32, device)
        out = torch.empty_like(y0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.phosphorus_year_launch(
                y0.data_ptr(), out.data_ptr(), fields.data_ptr(),
                table.tensor.data_ptr(), nz, ny, n_steps, dt, stream,
            )
        if err:
            raise cuda_error(lib, "phosphorus_year", err,
                              "phosphorus_year_kernel launch")
        phosphorus_year_launches += 1
        return out

    return year
