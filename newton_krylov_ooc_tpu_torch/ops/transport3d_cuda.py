"""the 3D offline IRF-transport year as a hand-written CUDA kernel (B4),
beside its plain PyTorch version.

`build_transport3d_year` is the port of
newton_krylov_ooc_tpu/ops/transport3d_pallas.py::build_transport3d_year_pallas:
(coef, kv, dz_r, diag, src, t_span, n_steps, couple) -> year(y0) with y0 of
shape (T, nz, nlat, nlon), float32, steady or seasonal circulation, and the
optional (T, T) surface gas-exchange coupling.  One call runs the whole
year as one cooperative launch of csrc/transport3d_year.cu on PyTorch's
current stream (see the note at the top of that file for the design), laid
out by `year_plan` (tiles of whole columns, resident in shared memory when
every tile fits the card at once, else walked); it counts its calls in
`transport3d_year_launches`.  Its selector bytes are packed once a built year
(`pack_selectors`) and its month table (`month_table`) lies in device
memory.

`build_transport3d_year_plain` is the single-device content of the JAX
package's parallel/sharded_transport3d.py::build_sharded_transport3d_year
without the halo exchange: ops/imex.py::imex_year over
ops/transport3d.py::transport_tend + src, the coupling term added at the
surface, and seasonal coefficients and kv interpolated at the time of year
of each stage.  It works in the coefficients' dtype on their device.  Given
the 13 fields of transport_stencil_coef, it applies stencil_tend instead
(the stencil mode of ops/transport3d_stream_cuda.py).

The wrapper takes the plain version only on the CPU; for a CUDA tensor it
launches the kernel or raises.  The kernel source is built with the
others by ops/imex_cuda.py::build_libraries.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .compute import resolve_device
from .imex import imex_year
from .imex_cuda import _check_state, cuda_error, load_library
from .transport3d import (
    interp_month,
    interp_transport_coef,
    month_bracket,
    pack_selectors,
    stencil_tend,
    transport_coef_n_time,
    transport_tend,
)

SEC_PER_YEAR = 365.0 * 86400.0

# the kernel's operand slots, in csrc/transport3d_year.cu's order
_SLOTS = ("wet", "recip_vol", "t_e", "t_n", "t_t", "cond_e", "cond_n", "kv",
          "dz_r", "diag", "src", "couple")

# launches of the CUDA year in this process (one per year(y0) call on a
# CUDA tensor); callers reset it to 0 to count a run's launches
transport3d_year_launches = 0


def cuda_launches_per_year(n_steps):
    """CUDA kernel launches one year enqueues: one cooperative launch runs
    the whole year"""
    return 1


def grid_syncs_per_year(n_steps):
    """grid-wide barriers in one year's launch: after the first CN half
    step, and after each step's two stages but the last"""
    return 2 * int(n_steps)


def year_frac(t, period=SEC_PER_YEAR):
    """fraction of the period (by default the calendar year) at time t (a
    tensor), by true division on t's device"""
    return torch.remainder(t / torch.full_like(t, period), 1.0)


def _season(coef, kv):
    """the number of months of a seasonal circulation (None if steady);
    kv and the face fields must agree"""
    n_time = transport_coef_n_time(coef)
    if kv.ndim == 3:
        if n_time is not None and kv.shape[0] != n_time:
            raise ValueError(
                "seasonal kv and coefficient time axes disagree: "
                f"{kv.shape[0]} vs {n_time}"
            )
        n_time = n_time or kv.shape[0]
    elif kv.ndim != 2:
        raise ValueError("kv must be (nz-1, nh) or seasonal (n_time, nz-1, nh)")
    return n_time


def _tensor(arr, dtype, device):
    """a tensor or a numpy array (copied: it may be read-only) as a tensor"""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)


def _rates(diag, src, t_dim, nz, nh, dtype, device):
    """(T, nz, nh) implicit rates and explicit sources as tensors"""
    def field(arr):
        return _tensor(arr, dtype, device).reshape(t_dim, nz, nh).contiguous()
    return field(diag), field(src)


def _cn_bands(kv2, dz_r_np, nz, nlat, nlon):
    """(dl_b, du_b) float64 band fields of one vertical-mixing sample,
    each (nz, nlat, nlon): the Crank-Nicolson operator of
    ops/imex.py::cn_vertical_increment expanded, (M y)[k] = dl[k] y[k-1] +
    dmain[k] y[k] + du[k] y[k+1] with dmain = -(du + dl) + diag"""
    kv3 = np.asarray(kv2, np.float64).reshape(nz - 1, nlat, nlon)
    dz_r_np = np.asarray(dz_r_np, np.float64)
    up = kv3 * dz_r_np[:-1, None, None]
    lo = kv3 * dz_r_np[1:, None, None]
    zrow = np.zeros((1, nlat, nlon))
    du_b = np.concatenate([up, zrow], axis=0)
    dl_b = np.concatenate([zrow, lo], axis=0)
    return dl_b, du_b


def _couple(couple, t_dim, dtype, device):
    if couple is None:
        return None
    couple = _tensor(couple, dtype, device)
    if tuple(couple.shape) != (t_dim, t_dim):
        raise ValueError("couple must be (tracer, tracer)")
    return couple


def build_transport3d_year_plain(coef, kv, dz_r, diag, src, t_span, n_steps,
                                 couple=None, period=SEC_PER_YEAR, *,
                                 stencil=None):
    """year(y0: (T, nz, nlat, nlon)) -> y(t_end) over ops/imex.py::imex_year,
    in the coefficients' dtype and on their device

    coef: the port's transport coefficient dict (ops/transport3d.py::
    build_transport3d, or models/irf_offline/convert.py::coef_from_numpy);
    face fields may be seasonal (n_time, nz, nlat, nlon)
    kv: (nz-1, nlat*nlon) vertical-mixing coupling, or seasonal
        (n_time, nz-1, nlat*nlon); dz_r: (nz,)
    diag, src: (T, nz, nlat*nlon) implicit local rates and explicit sources
    couple: optional (T, T) surface gas-exchange coupling [1/s]
    period: the seasonal cycle's length [s] (the months span it)
    stencil: optional (13, nz, nlat, nlon) transport_stencil_coef fields of
        a steady circulation; the tendency is then stencil_tend of them
    """
    wet = coef["wet"]
    dtype, device = wet.dtype, wet.device
    nz, nlat, nlon = wet.shape
    nh = nlat * nlon
    t_dim = int(np.shape(diag)[0])
    coef = {key: None if arr is None else arr.to(device=device, dtype=dtype)
            for key, arr in coef.items()}
    kv = _tensor(kv, dtype, device)
    dz_r = _tensor(dz_r, dtype, device)
    _season(coef, kv)
    diag, src = _rates(diag, src, t_dim, nz, nh, dtype, device)
    couple = _couple(couple, t_dim, dtype, device)
    wet_surf = wet[0].reshape(-1)
    if stencil is not None:
        stencil = stencil.to(device=device, dtype=dtype)

    def explicit_tend(t, y):
        y4 = y.reshape(t_dim, nz, nlat, nlon)
        if stencil is None:
            c_t = interp_transport_coef(coef, year_frac(t, period))
            tend = transport_tend(c_t, y4)
        else:
            tend = stencil_tend(stencil, y4)
        tend = tend.reshape(y.shape) + src
        if couple is not None:
            tend[:, 0, :] += wet_surf * (couple @ y[:, 0, :])
        return tend

    if kv.ndim == 3:
        def vert_coeff(t):
            return interp_month(kv, year_frac(t, period))
    else:
        def vert_coeff(t):
            return kv

    def year(y0):
        _check_state(y0, (t_dim, nz, nlat, nlon), dtype, device)
        return imex_year(explicit_tend, vert_coeff, diag, dz_r,
                         y0.reshape(t_dim, nz, nh), t_span,
                         n_steps).reshape(y0.shape)

    return year


def season_samples(t_span, n_steps, n_time, period=SEC_PER_YEAR):
    """(m0, m1, w) of every time sample of a float32 year, as numpy int32,
    int32 and float32 arrays of length 2 n_steps + 1: sample 0 is t0 (the
    first CN half step); step i's are t_i = t0 + i dt (Heun stage 1) and
    t_i + dt (Heun stage 2 and the CN step after it).  The arithmetic is
    the plain year's (ops/imex.py::imex_year's times, year_frac,
    month_bracket) in float32 on the CPU, so kernel and plain year sample
    the same months with the same weights.  period: the seasonal cycle's
    length [s]."""
    if n_time is None:
        count = 2 * int(n_steps) + 1
        return (np.zeros(count, np.int32), np.zeros(count, np.int32),
                np.zeros(count, np.float32))
    f32 = torch.float32
    t0 = torch.tensor(t_span[0], dtype=f32)
    dt = torch.tensor((t_span[1] - t_span[0]) / n_steps, dtype=f32)
    t_a = t0 + torch.arange(n_steps, dtype=f32) * dt
    times = torch.cat([t0.reshape(1), torch.stack([t_a, t_a + dt], 1).reshape(-1)])
    m0, m1, w1 = month_bracket(year_frac(times, period), n_time)
    return (m0.numpy().astype(np.int32), m1.numpy().astype(np.int32),
            w1.numpy().astype(np.float32))


def _check_operands(operands, n_time, nz, nlat, nlon):
    """raise ValueError unless every operand has the shape the kernel reads
    it at: it indexes them without bounds checks"""
    grid = (nz, nlat, nlon)
    month = () if n_time is None else (n_time,)
    for name in ("wet", "recip_vol", "t_e", "t_n", "t_t", "cond_e", "cond_n"):
        arr = operands[name]
        shapes = {grid} if name in ("wet", "recip_vol") else {grid, month + grid}
        if arr is not None and tuple(arr.shape) not in shapes:
            raise ValueError(f"{name} has shape {tuple(arr.shape)}, expected "
                             f"one of {sorted(shapes)}")
    kv_shape = (nz - 1, nlat * nlon)
    if tuple(operands["kv"].shape) not in (kv_shape, month + kv_shape):
        raise ValueError(f"kv has shape {tuple(operands['kv'].shape)}, "
                         f"expected {kv_shape} or {month + kv_shape}")
    if tuple(operands["dz_r"].shape) != (nz,):
        raise ValueError(f"dz_r has shape {tuple(operands['dz_r'].shape)}, "
                         f"expected ({nz},)")


def month_table(t_span, n_steps, n_time, device, period=SEC_PER_YEAR):
    """season_samples as the kernel reads them: (m0, m1, w) int32, int32
    and float32 tensors on `device`, 2 n_steps + 1 samples each"""
    return tuple(torch.as_tensor(arr, device=device)
                 for arr in season_samples(t_span, n_steps, n_time, period))


# the tile of a year whose tiles do not all fit the card at once: its
# blocks walk several a stage, their state in device memory
WALK_TILE = (8, 32)


class Plan(NamedTuple):
    """how B4 lays a year on the card: tiles of ty x tx whole columns,
    resident (every tile's state in one block's shared memory for the whole
    year) or walking, and the launch's blocks"""
    ty: int
    tx: int
    resident: bool
    grid: int


def year_plan(smem_bytes, smem_limit, t_dim, nz, nlat, nlon, capacity):
    """the Plan of B4 for a (t_dim, nz, nlat, nlon) year: the tile of the
    fewest columns (then the least region) whose tiles all fit the card at
    once with their state resident -- tiles <= capacity(True, smem) -- and
    whose smem_bytes(t_dim, nz, ty, tx, resident) fit smem_limit bytes;
    otherwise WALK_TILE (halved until it fits) walked by
    capacity(False, smem) blocks.  Raises ValueError, naming the limit,
    when no tile fits."""
    best = None
    for ty in range(1, nlat + 1):
        for tx in range(1, nlon + 1):
            smem = smem_bytes(t_dim, nz, ty, tx, 1)
            if smem > smem_limit:
                break
            tiles = -(-nlat // ty) * -(-nlon // tx)
            if tiles <= capacity(True, smem):
                key = (ty * tx, (ty + 4) * (tx + 4))
                if best is None or key < best[0]:
                    best = (key, Plan(ty, tx, True, tiles))
                break
    if best is not None:
        return best[1]
    ty, tx = min(WALK_TILE[0], nlat), min(WALK_TILE[1], nlon)
    while smem_bytes(t_dim, nz, ty, tx, 0) > smem_limit and ty * tx > 1:
        ty, tx = (ty, max(1, tx // 2)) if tx >= ty else (max(1, ty // 2), tx)
    smem = smem_bytes(t_dim, nz, ty, tx, 0)
    held = capacity(False, smem) if smem <= smem_limit else 0
    if held < 1:
        raise ValueError(
            f"a transport3d_year tile of one column of {nz} levels and "
            f"{t_dim} tracers needs {smem} bytes of shared memory, over "
            f"the {smem_limit} one block may use"
        )
    tiles = -(-nlat // ty) * -(-nlon // tx)
    return Plan(ty, tx, False, min(tiles, held))


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("transport3d_year", {
        "smem_bytes": ([c_int] * 5, ctypes.c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        "occupancy": ([c_int, ctypes.c_long, ctypes.POINTER(c_int)], c_int),
        # y, ys, comp, f1, operand pointers, seasonal flags, sel, m0, m1, w,
        # t_dim, nz, nlat, nlon, upwind3, ty, tx, resident, grid, n_steps,
        # dt, stream
        "launch": ([c_ptr] * 10 + [c_int] * 10 + [ctypes.c_float, c_ptr],
                   c_int),
    })


def _card_plan(lib, device, t_dim, nz, nlat, nlon, smem_limit=None,
               max_blocks=None):
    """year_plan on the card: its shared-memory limit, SM count and the
    kernel's occupancy (smem_limit and max_blocks cap them, for tests)"""
    if smem_limit is None:
        limit = ctypes.c_int(0)
        err = lib.transport3d_year_smem_optin(device.index,
                                              ctypes.byref(limit))
        if err:
            raise cuda_error(lib, "transport3d_year", err,
                             "querying the shared-memory opt-in limit")
        smem_limit = limit.value
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count

    def capacity(resident, smem):
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.transport3d_year_occupancy(int(resident), smem,
                                                 ctypes.byref(per_sm))
        if err:
            raise cuda_error(lib, "transport3d_year", err,
                             "querying the kernel's occupancy")
        held = per_sm.value * n_sm
        return held if max_blocks is None else min(held, max_blocks)

    return year_plan(lib.transport3d_year_smem_bytes, smem_limit, t_dim, nz,
                     nlat, nlon, capacity)


def build_transport3d_year(coef, kv, dz_r, diag, src, t_span, n_steps,
                           couple=None, *, device):
    """year(y0: (T, nz, nlat, nlon) float32) -> y(t_end): the whole year
    enqueued by one call of the CUDA kernel's C loop on a CUDA `device`; on
    the CPU, the plain version in float32.

    Arguments as build_transport3d_year_plain's (any dtype; the kernel's
    operands are float32).  Raises ValueError, as the TPU kernel does, when
    a seasonal step is longer than one month interval (dt > year/n_time),
    when no tile fits the card (year_plan), and on a CUDA device for 2^31
    or more values of one state or one month.  year.plan is the launch's
    Plan (None on the CPU).
    """
    device = resolve_device(device)
    wet = coef["wet"]
    nz, nlat, nlon = wet.shape
    nh = nlat * nlon
    t_dim = int(np.shape(diag)[0])
    f32 = torch.float32
    kv = _tensor(kv, f32, device)
    n_time = _season(coef, kv)
    dt = float((t_span[1] - t_span[0]) / n_steps)
    if n_time is not None and dt > SEC_PER_YEAR / n_time:
        raise ValueError(
            f"a seasonal year needs dt <= year/n_time "
            f"({SEC_PER_YEAR / n_time:.0f} s); got dt={dt:.0f} s -- raise "
            "n_steps"
        )
    coef32 = {key: None if arr is None else arr.to(device=device, dtype=f32)
              for key, arr in coef.items()}
    diag, src = _rates(diag, src, t_dim, nz, nh, f32, device)
    operands = dict(coef32, kv=kv, diag=diag, src=src,
                    dz_r=_tensor(dz_r, f32, device),
                    couple=_couple(couple, t_dim, f32, device))
    operands = {name: None if operands.get(name) is None
                else operands[name].contiguous() for name in _SLOTS}
    _check_operands(operands, n_time, nz, nlat, nlon)
    if device.type == "cpu":
        year = build_transport3d_year_plain(coef32, kv, operands["dz_r"], diag,
                                            src, t_span, n_steps, couple)
        year.plan = None
        return year

    ptrs = (ctypes.c_void_p * len(_SLOTS))(*(
        None if operands[name] is None else operands[name].data_ptr()
        for name in _SLOTS
    ))
    seasonal = np.array(
        [int(name in ("t_e", "t_n", "t_t", "cond_e", "cond_n", "kv")
             and operands[name] is not None
             and operands[name].ndim == (4 if name != "kv" else 3))
         for name in _SLOTS], np.int32)
    if max(t_dim, n_time or 1) * nz * nh >= 2 ** 31:
        raise ValueError(
            f"the transport3d_year kernel indexes in 32 bits: "
            f"{max(t_dim, n_time or 1)} x {nz * nh} values is too many")
    months = month_table(t_span, n_steps, n_time, device)
    sel = pack_selectors(operands["wet"])
    upwind3 = int(coef.get("sel3p_e") is not None)
    lib = _library()
    plan = _card_plan(lib, device, t_dim, nz, nlat, nlon)
    shape = (t_dim, nz, nlat, nlon)
    dt32 = float(np.float32(dt))

    def year(y0):
        global transport3d_year_launches
        _check_state(y0, shape, f32, device)
        out = y0.clone()
        ys = torch.empty_like(y0)
        comp = f1 = None
        if not plan.resident:
            comp, f1 = torch.zeros_like(y0), torch.empty_like(y0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.transport3d_year_launch(
                out.data_ptr(), ys.data_ptr(),
                None if comp is None else comp.data_ptr(),
                None if f1 is None else f1.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p), seasonal.ctypes.data,
                sel.data_ptr(), *(arr.data_ptr() for arr in months), t_dim,
                nz, nlat, nlon, upwind3, plan.ty, plan.tx,
                int(plan.resident), plan.grid, int(n_steps), dt32, stream,
            )
        if err:
            raise cuda_error(lib, "transport3d_year", err,
                             "transport3d_year cooperative launch")
        transport3d_year_launches += 1
        return out

    # the operand tensors must outlive every launch that reads them
    year.operands = (operands, sel, months)
    year.plan = plan
    return year
