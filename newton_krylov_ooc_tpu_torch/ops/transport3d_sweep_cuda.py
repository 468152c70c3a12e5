"""one sweep of the latitude-sharded streaming 3D year on one shard's slab,
as a hand-written CUDA kernel (B6), beside its plain PyTorch version.

`build_stream_sweep` is the port of
newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py::build_stream_sweep,
the per-shard compute of parallel/sharded_transport3d.py::
build_sharded_transport3d_year_stream.  A shard's slab is its latitude
rows plus `halo` rows a side; its coefficient fields are the shard's
zero-padded latitude extension, in float32 on the shard's device.  The
returned sweep(y, c, y_spare, step0, first=False, last=False) advances the
slab state y (T, nz, rows, nlon) and its Kahan carry c by one sweep:

  * first: only the opening CN(dt/2), the carry zeroed first;
  * otherwise k_steps IMEX steps from global step step0, each Heun(dt)
    then CN(dt), the last of them CN(dt/2) when `last`.

It updates c in place and returns (state, spare): the tensor holding the
sweep's end, which is y or y_spare, and the other one, free for the next
sweep.  Only the interior rows are exact; rows within 4 k_steps of the
slab's edges are garbage.  The TPU kernel's params vector (the flags, and
month weights the caller precomputes) becomes step0 and the two flags:
the time samples are the year's table (ops/transport3d_cuda.py::
season_samples, `samples`), indexed by the global step as B5 indexes it.

Its modes are B5's: upwind3 or centred flux form with recip_vol read or
rebuilt from recip_area and recip_dz, or the 13-offset stencil (st, the
slab of the global transport_stencil_coef); dense rate fields or their
_factor_rate_field factors (diag_fac, src_fac); seasonal faces and kv;
the (T, T) surface coupling.  On a CUDA device one call enqueues the sweep
from a C loop in csrc/transport3d_sweep.cu (the note at the top of that
file gives the design) and counts one in `transport3d_sweep_launches`; on
the CPU it is `stream_sweep_plain`'s sweep.

`stream_sweep_plain` is the same sweep in plain PyTorch: transport_tend
(selectors from the slab's wet mask, as the kernel derives them) or
stencil_tend on the slab, the flux-form CN solve and the Kahan adds of
ops/imex.py, in the coefficients' dtype.  It reads the dense fields.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .compute import resolve_device
from .imex import _kahan_add, cn_vertical_increment
from .imex_cuda import cuda_error, load_library
from .transport3d import stencil_tend, transport_tend, upwind3_selectors
from .transport3d_cuda import _couple, _tensor
from .transport3d_stream_cuda import _FACES, _SLOTS, pack_operands

# launches of the CUDA sweep in this process (one per sweep call on a CUDA
# device); callers reset it to 0 to count a run's launches
transport3d_sweep_launches = 0


def _check_state(arrs, shape, device, dtype):
    for arr in arrs:
        if not isinstance(arr, torch.Tensor):
            raise TypeError(f"sweep state must be a torch.Tensor, got "
                            f"{type(arr).__name__}")
        if arr.device != device or arr.dtype != dtype:
            raise ValueError(f"sweep state is {arr.dtype} on {arr.device}; "
                             f"this sweep takes {dtype} on {device}")
        if tuple(arr.shape) != shape or not arr.is_contiguous():
            raise ValueError(f"sweep state has shape {tuple(arr.shape)}"
                             f"{'' if arr.is_contiguous() else ' (strided)'}, "
                             f"expected a contiguous {shape}")


def _check_step(step0, k_steps, first, n_samples):
    if not first and not (0 <= step0 and 2 * (step0 + k_steps) < n_samples):
        raise ValueError(f"steps {step0}..{step0 + k_steps - 1} lie outside "
                         f"the year's {(n_samples - 1) // 2} steps")


def stream_sweep_plain(coef, kv, dz_r, diag, src, dt, k_steps, samples, *,
                       couple=None, upwind3=True, st=None, t_dim=None):
    """sweep(y, c, y_spare, step0, first=False, last=False) -> (state,
    spare) in plain PyTorch, in the coefficients' dtype on their device.

    coef: the slab's wet, recip_vol and face fields (seasonal faces
    (n_time, nz, rows, nlon)); kv: (nz-1, rows*nlon) or seasonal (n_time,
    nz-1, rows*nlon); dz_r: (nz,); diag, src: dense (T, nz, rows*nlon) or
    None (zero); dt: the step [s]; samples: (m0, m1, w) of the year;
    upwind3: derive the upwind3 selectors from the slab's wet mask (else
    centred); st: the slab's 13 stencil fields, which replace the flux
    form.  The times and the arithmetic are the plain year's
    (ops/transport3d_cuda.py::build_transport3d_year_plain), so on the
    slab's interior one shard repeats it value for value.
    """
    wet = coef["wet"]
    dtype, device = wet.dtype, wet.device
    nz, rows, nlon = wet.shape
    nh = rows * nlon
    if t_dim is None:
        t_dim = int((diag if diag is not None else src).shape[0])
    shape = (t_dim, nz, rows, nlon)

    def field(arr):
        if arr is None:
            return torch.zeros((t_dim, nz, nh), dtype=dtype, device=device)
        return _tensor(arr, dtype, device).reshape(t_dim, nz, nh)

    diag, src = field(diag), field(src)
    kv = _tensor(kv, dtype, device)
    dz_r = _tensor(dz_r, dtype, device)
    couple = _couple(couple, t_dim, dtype, device)
    wet_surf = wet[0].reshape(-1)
    coef = {name: coef[name] for name in ("wet", "recip_vol", *_FACES)
            if coef.get(name) is not None}
    if upwind3:
        coef.update(upwind3_selectors(wet))
    m0 = torch.as_tensor(np.asarray(samples[0], np.int64), device=device)
    m1 = torch.as_tensor(np.asarray(samples[1], np.int64), device=device)
    w = torch.as_tensor(np.asarray(samples[2]), dtype=dtype, device=device)
    dt_t = torch.tensor(dt, dtype=dtype, device=device)

    def at(arr, q):
        """a seasonal operand at time sample q, as interp_month blends it"""
        a0 = torch.index_select(arr, 0, m0[q].reshape(1))[0]
        a1 = torch.index_select(arr, 0, m1[q].reshape(1))[0]
        return (1.0 - w[q]) * a0 + w[q] * a1

    def tend(q, y):
        y4 = y.reshape(shape)
        if st is None:
            c_q = {name: at(arr, q) if arr.ndim == 4 else arr
                   for name, arr in coef.items()}
            out = transport_tend(c_q, y4)
        else:
            out = stencil_tend(st, y4)
        out = out.reshape(y.shape) + src
        if couple is not None:
            out[:, 0, :] += wet_surf * (couple @ y[:, 0, :])
        return out

    def cn(q, y, h):
        kv_q = at(kv, q) if kv.ndim == 3 else kv
        return cn_vertical_increment(kv_q, diag, dz_r, y, h)

    def sweep(y, c, y_spare, step0, first=False, last=False):
        _check_state((y, c, y_spare), shape, device, dtype)
        _check_step(step0, k_steps, first, len(m0))
        y_f = y.reshape(t_dim, nz, nh)
        if first:
            y_f, c_f = _kahan_add(y_f, torch.zeros_like(y_f),
                                  cn(0, y_f, 0.5 * dt_t))
        else:
            c_f = c.reshape(t_dim, nz, nh)
            for j in range(k_steps):
                q1, q2 = 1 + 2 * (step0 + j), 2 + 2 * (step0 + j)
                f1 = tend(q1, y_f)
                f2 = tend(q2, y_f + dt_t * f1)
                y_f, c_f = _kahan_add(y_f, c_f, 0.5 * dt_t * (f1 + f2))
                h = 0.5 * dt_t if last and j == k_steps - 1 else dt_t
                y_f, c_f = _kahan_add(y_f, c_f, cn(q2, y_f, h))
        c.copy_(c_f.reshape(shape))
        y.copy_(y_f.reshape(shape))
        return y, y_spare

    return sweep


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("transport3d_sweep", {
        "smem_bytes": ([c_int] * 2, ctypes.c_long),
        "tile": ([ctypes.POINTER(c_int)] * 2, None),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        # y_a, y_b, comp, factors, fields, seasonal, opts, m0, m1, w, t_dim,
        # nz, rows, nlon, step0, k_steps, first, last, dt, stream
        "launch": ([c_ptr] * 10 + [c_int] * 8 + [ctypes.c_float, c_ptr],
                   c_int),
    })


def step_tile():
    """the fused step's tile (rows, columns), from the kernel's library
    (built first if needed)"""
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    _library().transport3d_sweep_tile(ctypes.byref(rows), ctypes.byref(cols))
    return rows.value, cols.value


def _check_smem(lib, t_dim, coupled, device):
    """raise ValueError when a step block's shared memory exceeds what one
    block may use on the card"""
    smem = lib.transport3d_sweep_smem_bytes(t_dim, int(coupled))
    limit = ctypes.c_int(0)
    err = lib.transport3d_sweep_smem_optin(device.index, ctypes.byref(limit))
    if err:
        raise cuda_error(lib, "transport3d_sweep", err,
                         "querying the shared-memory opt-in limit")
    if smem > limit.value:
        raise ValueError(
            f"the transport3d_sweep kernel needs {smem} bytes of shared "
            f"memory a block for {t_dim} tracers, over the "
            f"{limit.value} bytes one block may use on "
            f"{torch.cuda.get_device_name(device)}; split the family"
        )


def build_stream_sweep(coef, kv, dz_r, diag, src, dt, k_steps, samples, *,
                       couple=None, upwind3=True, st=None, diag_fac=None,
                       src_fac=None, recip_area=None, recip_dz=None,
                       t_dim=None, device):
    """sweep(y, c, y_spare, step0, first=False, last=False) -> (state,
    spare): B6 on a CUDA `device`, float32; on the CPU the plain sweep.

    Arguments as stream_sweep_plain's, the slab's fields on `device`;
    besides: diag_fac, src_fac: the rate fields' factors, which the kernel
    rebuilds them from instead of reading diag or src; recip_area (rows,
    nlon) with recip_dz (nz,): the factors the kernel rebuilds recip_vol
    from.  y, c and y_spare: contiguous float32 (T, nz, rows, nlon) on
    `device`.  The sweep carries operands (the tensors the kernel reads,
    kept alive with it).
    """
    device = resolve_device(device)
    if device.type == "cpu":
        return stream_sweep_plain(coef, kv, dz_r, diag, src, dt, k_steps,
                                  samples, couple=couple, upwind3=upwind3,
                                  st=st, t_dim=t_dim)

    f32 = torch.float32
    wet = coef["wet"]
    nz, rows, nlon = wet.shape
    if t_dim is None:
        t_dim = int((diag if diag is not None else src).shape[0])
    coef32 = {name: None if coef.get(name) is None
              else coef[name].to(device=device, dtype=f32)
              for name in ("wet", "recip_vol", *_FACES)}

    def dense(arr, fac):
        if arr is None or fac is not None:
            return None
        return _tensor(arr, f32, device).reshape(t_dim, nz, rows * nlon)

    couple32 = _couple(couple, t_dim, f32, device)
    operands, seasonal, opts = pack_operands(
        coef32, _tensor(kv, f32, device), _tensor(dz_r, f32, device),
        dense(diag, diag_fac), dense(src, src_fac), t_dim, diag_fac, src_fac,
        None if recip_area is None else _tensor(recip_area, f32, device),
        None if recip_dz is None else _tensor(recip_dz, f32, device),
        None if st is None else st.to(device=device, dtype=f32), couple32,
        upwind3, device)
    lib = _library()
    _check_smem(lib, t_dim, couple32 is not None, device)
    ptrs = (ctypes.c_void_p * len(_SLOTS))(*(
        None if operands[name] is None else operands[name].data_ptr()
        for name in _SLOTS
    ))
    m0, m1, w = (np.ascontiguousarray(samples[0], np.int32),
                 np.ascontiguousarray(samples[1], np.int32),
                 np.ascontiguousarray(samples[2], np.float32))
    shape = (t_dim, nz, rows, nlon)
    # the sweep factors gp and cp
    factors = torch.empty((2,) + shape, dtype=f32, device=device)

    def sweep(y, c, y_spare, step0, first=False, last=False):
        global transport3d_sweep_launches
        _check_state((y, c, y_spare), shape, device, f32)
        _check_step(step0, k_steps, first, len(m0))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.transport3d_sweep_launch(
                y.data_ptr(), y_spare.data_ptr(), c.data_ptr(),
                factors.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p),
                seasonal.ctypes.data, opts.ctypes.data, m0.ctypes.data,
                m1.ctypes.data, w.ctypes.data, t_dim, nz, rows, nlon,
                int(step0), int(k_steps), int(first), int(last), float(dt),
                stream,
            )
        if err:
            raise cuda_error(lib, "transport3d_sweep", err,
                             "transport3d_sweep kernel launch")
        transport3d_sweep_launches += 1
        if first or k_steps % 2 == 0:
            return y, y_spare
        return y_spare, y

    # the operand tensors must outlive every launch that reads them
    sweep.operands = operands
    return sweep
