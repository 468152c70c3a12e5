"""the streaming 3D transport year for grids past on-chip memory (POP gx1)
as a hand-written CUDA kernel (B5), beside its plain PyTorch version.

`build_transport3d_year_stream` is the port of
newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py::
build_transport3d_year_stream: the same arguments, the same checks with
the same words, and year(y0) with y0 of shape (T, nz, nlat, nlon) in any
float dtype, cast to float32.  Its modes:

  * upwind3 (or centred) flux form, steady or seasonal circulation, with
    recip_vol read or rebuilt from recip_area and recip_dz;
  * stencil=True: the collapsed 13-offset operator of
    ops/transport3d.py::transport_stencil_coef (steady circulations),
    computed in the coefficients' dtype and cast to float32;
    coef_bf16=True rounds it once to bfloat16;
  * rate fields (diag, src) of the form a_t wet + b_t wet_surf rebuilt from
    two scalars per tracer (_factor_rate_field), others read dense;
  * an optional (T, T) surface coupling.

One call enqueues the whole year on PyTorch's current stream from a C loop
in csrc/transport3d_stream.cu (the note at the top of that file gives the
design): 1 + n launches, one fused step each after the opening CN half
step, counted as one in `transport3d_stream_launches`.  `pack_selectors`
packs the wet mask and its six upwind3 selectors into the byte a cell the
kernel reads.
block_rows, prefetch, steps_per_sweep and tend_chunk choose the TPU
kernel's schedule and do not change its result; they are checked as the
JAX builder checks them, and the Hopper kernel picks its own tiling.

`build_transport3d_year_stream_plain` is the same year in plain PyTorch:
ops/transport3d_cuda.py::build_transport3d_year_plain over transport_tend,
or over stencil_tend of the collapsed operator.  Factored rates, factored
recip_vol and the CN bands rebuilt from kv do not change the function, so
it reads the dense fields.  The wrapper takes it only on the CPU; for a
CUDA device it launches the kernel or raises.

Not ported: plan_stream, stream_vmem_bytes and stream_hbm_bytes_per_step,
which plan and count the TPU schedule's VMEM and DMA traffic.  The year
carries the port's own counts instead: hbm_bytes_per_step and
est_flops_per_step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .compute import resolve_device
from .imex_cuda import cuda_error, load_library
from .transport3d import (  # noqa: F401 (SEL_BITS, pack_selectors: here too)
    SEL_BITS,
    STENCIL_OFFSETS,
    pack_selectors,
    transport_stencil_coef,
)
from .transport3d_cuda import (
    SEC_PER_YEAR,
    _check_operands,
    _couple,
    _season,
    _tensor,
    build_transport3d_year_plain,
    season_samples,
)

# the kernel's operand slots, in csrc/transport3d_stream.cu's order
_SLOTS = ("wet", "recip_vol", "recip_area", "recip_dz", "t_e", "t_n", "t_t",
          "cond_e", "cond_n", "st", "kv", "dz_r", "diag", "src", "rates",
          "couple", "sel", "dlb", "dub")
_FACES = ("t_e", "t_n", "t_t", "cond_e", "cond_n")
# csrc/transport3d_stream.cu's Mode and Rate
_FLUX, _STENCIL_F32, _STENCIL_BF16 = 0, 1, 2
_RATE_NONE, _RATE_DENSE, _RATE_FACTORED = 0, 1, 2

# float32 operations per cell, tracer and step that the year's arithmetic
# needs, counted once per cell from csrc/transport3d_stream.cu, each face
# once (three faces a cell and stage): two tendencies (flux form 81 and 83,
# as B4's, stage state included; stencil
# form a multiply per offset, an add per further offset and the source,
# 26 each, plus the stage state's 2), the Heun Kahan add (6) and the CN
# Thomas solve with its Kahan add (28)
FLUX_CELL_OPS = 81 + 83 + 6 + 28
STENCIL_CELL_OPS = 2 * 2 * len(STENCIL_OFFSETS) + 2 + 6 + 28

# launches of the CUDA stream year in this process (one per year(y0) call
# on a CUDA device); callers reset it to 0 to count a run's launches
transport3d_stream_launches = 0


def cuda_launches_per_year(n_steps):
    """CUDA kernel launches one year enqueues: the first CN half step, then
    one fused step (Heun and CN) a step"""
    return 1 + int(n_steps)


def _factor_rate_field(arr, wet):
    """try to factor per-tracer rate fields as a_t*wet + b_t*wet_surf.

    arr: (T, nz, nlat, nlon), wet: (nz, nlat, nlon), both compared in
    float32.  The family solves build their implicit rates and sources as
    constant rates times the wet mask plus a surface-only row
    (ops/transport3d.py::assemble_rate_fields); such fields carry two
    scalars per tracer, which the kernel rebuilds them from.  Returns
    (a, b) as per-tracer float lists, or None when any tracer's field is
    not of this form (it is then read dense).
    """
    arr = np.asarray(arr, np.float32)
    wet = np.asarray(wet, np.float32)
    a_list, b_list = [], []
    for t in range(arr.shape[0]):
        if np.any(arr[t][wet == 0.0] != 0.0):
            return None
        interior = arr[t, 1:][wet[1:] > 0.0]
        a_val = float(interior.flat[0]) if interior.size else 0.0
        if interior.size and np.any(interior != np.float32(a_val)):
            return None
        surf = arr[t, 0][wet[0] > 0.0]
        s_val = float(surf.flat[0]) if surf.size else a_val
        if surf.size and np.any(surf != np.float32(s_val)):
            return None
        a_list.append(a_val)
        b_list.append(s_val - a_val)
    return a_list, b_list


def _numpy(arr):
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _stencil_fields(coef, dtype, coef_bf16):
    """transport_stencil_coef in the coefficients' dtype, cast to `dtype`;
    with coef_bf16 cast to float32 first and rounded once to bfloat16 (the
    JAX kernel's float32 stack, transport3d_stream_pallas.py:1032, 1743)"""
    st = transport_stencil_coef(coef)
    if coef_bf16:
        st = st.to(torch.float32).to(torch.bfloat16)
    return st.to(dtype)


def _zeros_or(arr, t_dim, nz, nh):
    return np.zeros((t_dim, nz, nh)) if arr is None else arr


def build_transport3d_year_stream_plain(
    coef, kv, dz_r, diag, src, t_span, n_steps, couple=None, block_rows=16,
    prefetch=False, steps_per_sweep=1, recip_area=None, recip_dz=None,
    t_dim=None, period=SEC_PER_YEAR, factor_rates=True, tend_chunk=None,
    stencil=False, coef_bf16=False, *, dtype=None,
):
    """year(y0: (T, nz, nlat, nlon)) -> y(t_end) in plain PyTorch, on the
    coefficients' device, in `dtype` (default: the coefficients' dtype).

    Arguments as build_transport3d_year_stream's, unchecked.  The schedule
    (block_rows, prefetch, steps_per_sweep, tend_chunk) and the sheds
    (recip_area, recip_dz, factor_rates) do not change the year; diag or
    src None is zero.  With stencil, the operator is
    transport_stencil_coef of `coef` in its own dtype, cast to `dtype` (for
    the kernel's float32, as the JAX kernel casts it); coef_bf16 rounds it
    once to bfloat16 from float32.
    """
    wet = coef["wet"]
    dtype = wet.dtype if dtype is None else dtype
    nz, nlat, nlon = wet.shape
    if t_dim is None:
        t_dim = int(np.shape(diag if diag is not None else src)[0])
    diag = _zeros_or(diag, t_dim, nz, nlat * nlon)
    src = _zeros_or(src, t_dim, nz, nlat * nlon)
    st = _stencil_fields(coef, dtype, coef_bf16) if stencil else None
    coef_d = {key: None if arr is None else arr.to(dtype)
              for key, arr in coef.items()}
    return build_transport3d_year_plain(coef_d, kv, dz_r, diag, src, t_span,
                                        n_steps, couple, period, stencil=st)


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("transport3d_stream", {
        "smem_bytes": ([c_int] * 2, ctypes.c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        # y_pp, comp, factors, fields, seasonal, opts, m0, m1, w, t_dim, nz,
        # nlat, nlon, n_steps, dt, stream
        "launch": ([c_ptr] * 9 + [c_int] * 5 + [ctypes.c_float, c_ptr],
                   c_int),
    })


def _check_smem(lib, t_dim, coupled, device):
    """raise ValueError when a step block's shared memory (its rings, face
    tiles and carries, and the surface stage states of a coupled family)
    exceeds what one block may use on the card"""
    smem = lib.transport3d_stream_smem_bytes(t_dim, int(coupled))
    limit = ctypes.c_int(0)
    err = lib.transport3d_stream_smem_optin(device.index, ctypes.byref(limit))
    if err:
        raise cuda_error(lib, "transport3d_stream", err,
                         "querying the shared-memory opt-in limit")
    if smem > limit.value:
        raise ValueError(
            f"the transport3d_stream kernel needs {smem} bytes of shared "
            f"memory a block for {t_dim} tracers"
            f"{' (coupled)' if coupled else ''}, over the {limit.value} "
            f"bytes one block may use on "
            f"{torch.cuda.get_device_name(device)}; split the family"
        )


def pack_operands(coef32, kv32, dz_r32, diag, src, t_dim, diag_fac, src_fac,
                  recip_area, recip_dz, st, couple32, upwind3, device):
    """(operands, seasonal flags, opts) as csrc/transport3d_stream.cu's
    launch reads them, for B5's grid or B6's slab.

    coef32, kv32, dz_r32: the float32 coefficients on `device`; diag, src:
    the dense (T, nz, nh) float32 fields the kernel reads, or None (then
    diag_fac / src_fac, the _factor_rate_field factors, or none at all);
    recip_area, recip_dz: the factors the kernel rebuilds recip_vol from,
    or None to read it; st: the stencil fields (float32 or bfloat16) in
    stencil mode, else None; couple32: the (T, T) coupling or None.  The
    selector bytes (pack_selectors) come from coef32["wet"]; the CN bands
    dlb, dub are absent (B7's wrapper sets them)."""
    rates = None
    if diag_fac is not None or src_fac is not None:
        rows = np.zeros((4, t_dim), np.float32)
        for row, fac in ((0, diag_fac), (2, src_fac)):
            if fac is not None:
                rows[row], rows[row + 1] = fac
        rates = torch.tensor(rows, device=device)
    stencil = st is not None
    sep_rv = recip_area is not None and not stencil
    operands = {
        "wet": coef32["wet"],
        "recip_vol": None if stencil or sep_rv else coef32["recip_vol"],
        "recip_area": (torch.as_tensor(recip_area, device=device)
                       if sep_rv else None),
        "recip_dz": torch.as_tensor(recip_dz, device=device) if sep_rv else None,
        **{name: None if stencil else coef32.get(name) for name in _FACES},
        "st": st,
        "kv": kv32,
        "dz_r": dz_r32,
        "diag": diag,
        "src": src,
        "rates": rates,
        "couple": couple32,
        "sel": pack_selectors(coef32["wet"]),
        "dlb": None,
        "dub": None,
    }
    operands = {name: None if arr is None else arr.contiguous()
                for name, arr in operands.items()}
    seasonal_flags = np.array(
        [int(operands[name] is not None and (
            (name in _FACES and operands[name].ndim == 4)
            or (name == "kv" and operands[name].ndim == 3)))
         for name in _SLOTS], np.int32)

    def rate_mode(fac, dense_field):
        if fac is not None:
            return _RATE_FACTORED
        return _RATE_DENSE if dense_field is not None else _RATE_NONE

    if stencil:
        mode = _STENCIL_BF16 if st.dtype == torch.bfloat16 else _STENCIL_F32
    else:
        mode = _FLUX
    opts = np.array([mode, int(upwind3), rate_mode(diag_fac, diag),
                     rate_mode(src_fac, src)], np.int32)
    return operands, seasonal_flags, opts


def _hbm_bytes_per_step(operands, t_dim, n, seasonal):
    """bytes one step of the port's design moves if it reads each operand
    it uses once and writes each result once (the halo's re-reads counted
    as cache hits): the march reads the state, the Kahan carry, the
    selector bytes, the coefficient fields (both months of a seasonal one),
    kv, a dense src and diag and, for a factored diag or recip_vol, the wet
    mask, and writes the Heun state, the carry and the sweep factors cp and
    gp; the back substitution reads those four and writes the state and
    carry"""
    def size(name):
        arr = operands[name]
        if arr is None:
            return 0
        nbytes = arr.numel() * arr.element_size()
        if seasonal[_SLOTS.index(name)]:
            nbytes = 2 * nbytes // arr.shape[0]  # the months around a stage
        return nbytes

    state = 4 * t_dim * n
    factored = (operands["rates"] is not None
                or operands["recip_area"] is not None)
    return (12 * state + size("sel") + size("kv") + size("src")
            + size("diag") + (size("wet") if factored else 0)
            + sum(size(name) for name in ("recip_vol", "recip_area",
                                          "recip_dz", *_FACES, "st")))


def build_transport3d_year_stream(
    coef, kv, dz_r, diag, src, t_span, n_steps, couple=None, block_rows=16,
    prefetch=False, steps_per_sweep=1, recip_area=None, recip_dz=None,
    t_dim=None, period=SEC_PER_YEAR, factor_rates=True, tend_chunk=None,
    stencil=False, coef_bf16=False, *, device,
):
    """year(y0) -> y(t_end): the whole year enqueued by one call of the CUDA
    kernel's C loop on a CUDA `device`; on the CPU, the plain version in
    float32.

    coef: the port's coefficient dict (ops/transport3d.py::
    build_transport3d), face fields steady or seasonal; kv: (nz-1,
    nlat*nlon) or seasonal (n_time, nz-1, nlat*nlon); dz_r: (nz,);
    diag, src: (T, nz, nlat*nlon) or None (zero); couple: optional (T, T);
    recip_area (nlat, nlon) with recip_dz (nz,): the factors of
    coef["recip_vol"], which the kernel then rebuilds instead of reading;
    t_dim: the tracer count when diag and src are None; period: the
    seasonal cycle's length [s].  The other arguments as the JAX builder's
    (see the module note).  y0: (T, nz, nlat, nlon), any float dtype, on
    `device`; the result is float32.

    The year carries: stencil, coef_bf16; stream_diag and stream_src (a
    dense rate field is read, not rebuilt from its factors); operands (the
    tensors the kernel reads, kept alive with the year); hbm_bytes_per_step
    and est_flops_per_step, the port's own counts (_hbm_bytes_per_step;
    the operations the year's arithmetic needs per step, once per cell and
    face -- the step recomputes stage 1 on 1.41x the cells on top of it).
    """
    device = resolve_device(device)
    kv32 = _tensor(kv, torch.float32, device)
    n_time = _season(coef, kv32)
    seasonal = n_time is not None
    if block_rows % 8 or block_rows <= 0:
        raise ValueError("block_rows must be a positive multiple of 8")
    steps_per_sweep = int(steps_per_sweep)
    if steps_per_sweep < 1:
        raise ValueError("steps_per_sweep must be a positive integer")
    if int(n_steps) % steps_per_sweep:
        raise ValueError(
            f"steps_per_sweep={steps_per_sweep} must divide n_steps"
        )
    if seasonal:
        if steps_per_sweep != 1:
            raise ValueError("seasonal streaming needs steps_per_sweep=1")
        if float((t_span[1] - t_span[0]) / n_steps) > period / n_time:
            raise ValueError(
                "seasonal streaming needs dt <= period/n_time "
                f"({period / n_time:.0f} s) -- raise n_steps"
            )
    if stencil and seasonal:
        raise ValueError(
            "stencil streaming collapses a STEADY operator; a seasonal "
            "one would need 13 monthly stacks (3x the window traffic) -- "
            "use the upwind3 streaming path"
        )
    if coef_bf16 and not stencil:
        raise ValueError("coef_bf16 applies to the stencil mode only")

    wet = coef["wet"]
    nz, nlat, nlon = wet.shape
    nh = nlat * nlon
    has_diag = diag is not None and bool(np.any(_numpy(diag)))
    has_src = src is not None and bool(np.any(_numpy(src)))
    for arr in (diag, src):
        if t_dim is None and arr is not None:
            t_dim = int(np.shape(arr)[0])
    if t_dim is None:
        raise ValueError("t_dim is required when diag and src are None")
    n_steps = int(n_steps)
    dt = float((t_span[1] - t_span[0]) / n_steps)

    wet_np = _numpy(wet).astype(np.float32)
    diag_fac = src_fac = None
    if factor_rates and has_diag:
        diag_fac = _factor_rate_field(
            _numpy(diag).reshape(t_dim, nz, nlat, nlon), wet_np)
    if factor_rates and has_src:
        src_fac = _factor_rate_field(
            _numpy(src).reshape(t_dim, nz, nlat, nlon), wet_np)
    stream_diag = has_diag and diag_fac is None
    stream_src = has_src and src_fac is None
    chunk = int(tend_chunk) if tend_chunk else (t_dim if t_dim <= 2 else 1)
    if not 1 <= chunk <= t_dim:
        raise ValueError(f"tend_chunk={chunk} outside [1, {t_dim}]")

    # recip_vol is separable by construction; with the factors supplied the
    # kernel rebuilds it.  The stencil mode absorbs recip_vol: the factors
    # are accepted and unused.
    sep_rv = recip_area is not None and not stencil
    if sep_rv:
        if recip_dz is None:
            raise ValueError("recip_area requires recip_dz")
        recip_area = np.asarray(_numpy(recip_area), np.float32)
        recip_dz = np.asarray(_numpy(recip_dz), np.float32)
        # the kernel indexes the factors without bounds checks
        if recip_area.shape != (nlat, nlon) or recip_dz.shape != (nz,):
            raise ValueError(
                f"recip_area {recip_area.shape} and recip_dz {recip_dz.shape} "
                f"must be {(nlat, nlon)} and {(nz,)} to factor "
                "coef['recip_vol']"
            )
        rv_chk = wet_np * recip_dz[:, None, None] * recip_area[None]
        # atol must be 0: recip_vol is O(1e-19) in CGS
        if not np.allclose(rv_chk, _numpy(coef["recip_vol"]).astype(np.float32),
                           rtol=1e-5, atol=0.0):
            raise ValueError(
                "recip_area/recip_dz do not factor coef['recip_vol']"
            )
    if stencil and coef_bf16 and stream_src:
        raise ValueError(
            "coef_bf16 would round dense src windows; factor the "
            "rate fields or stream them in float32"
        )
    couple32 = _couple(couple, t_dim, torch.float32, device)

    f32 = torch.float32
    coef32 = {key: None if arr is None else arr.to(device=device, dtype=f32)
              for key, arr in coef.items()}
    dz_r32 = _tensor(dz_r, f32, device)
    _check_operands(dict(coef32, kv=kv32, dz_r=dz_r32), n_time, nz, nlat,
                    nlon)
    if diag is not None and int(np.size(_numpy(diag))) != t_dim * nz * nh:
        raise ValueError(f"diag has {np.size(_numpy(diag))} values, expected "
                         f"{t_dim * nz * nh}")
    if src is not None and int(np.size(_numpy(src))) != t_dim * nz * nh:
        raise ValueError(f"src has {np.size(_numpy(src))} values, expected "
                         f"{t_dim * nz * nh}")

    def dense(arr):
        return _tensor(arr, f32, device).reshape(t_dim, nz, nh).contiguous()

    st = None
    if stencil:
        st = _stencil_fields({key: None if arr is None else arr.to(device)
                              for key, arr in coef.items()}, f32, False)
        if coef_bf16:
            st = st.to(torch.bfloat16)
    operands, seasonal_flags, opts = pack_operands(
        coef32, kv32, dz_r32, dense(diag) if stream_diag else None,
        dense(src) if stream_src else None, t_dim, diag_fac, src_fac,
        recip_area if sep_rv else None, recip_dz if sep_rv else None, st,
        couple32, coef.get("sel3p_e") is not None, device)
    shape = (t_dim, nz, nlat, nlon)

    def state(y0):
        if not isinstance(y0, torch.Tensor):
            raise TypeError(f"y0 must be a torch.Tensor, got {type(y0).__name__}")
        if y0.device != device or not y0.is_floating_point():
            raise ValueError(f"y0 is {y0.dtype} on {y0.device}; this year takes "
                             f"a float tensor on {device}")
        if tuple(y0.shape) != shape:
            raise ValueError(f"y0 has shape {tuple(y0.shape)}, expected {shape}")
        return y0.to(f32)

    if device.type == "cpu":
        plain = build_transport3d_year_stream_plain(
            coef, kv32, dz_r32, None if diag is None else dense(diag),
            None if src is None else dense(src), t_span, n_steps, couple32,
            t_dim=t_dim, period=period, stencil=stencil, coef_bf16=coef_bf16,
            dtype=f32)

        def year(y0):
            return plain(state(y0).contiguous())
    else:
        lib = _library()
        _check_smem(lib, t_dim, couple32 is not None, device)
        ptrs = (ctypes.c_void_p * len(_SLOTS))(*(
            None if operands[name] is None else operands[name].data_ptr()
            for name in _SLOTS
        ))
        m0, m1, w = season_samples(t_span, n_steps, n_time, period)

        def year(y0):
            global transport3d_stream_launches
            y0 = state(y0)
            y_pp = torch.empty((2,) + shape, dtype=f32, device=device)
            y_pp[0].copy_(y0)
            comp = torch.zeros(shape, dtype=f32, device=device)
            # the sweep factors gp and cp
            factors = torch.empty((2,) + shape, dtype=f32, device=device)
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = lib.transport3d_stream_launch(
                    y_pp.data_ptr(), comp.data_ptr(), factors.data_ptr(),
                    ctypes.cast(ptrs, ctypes.c_void_p),
                    seasonal_flags.ctypes.data, opts.ctypes.data,
                    m0.ctypes.data, m1.ctypes.data, w.ctypes.data, t_dim, nz,
                    nlat, nlon, n_steps, dt, stream,
                )
            if err:
                raise cuda_error(lib, "transport3d_stream", err,
                                 "transport3d_stream kernel launch")
            transport3d_stream_launches += 1
            return y_pp[n_steps % 2]

    year.stencil = bool(stencil)
    year.coef_bf16 = bool(coef_bf16)
    year.stream_diag = stream_diag
    year.stream_src = stream_src
    # the operand tensors must outlive every launch that reads them
    year.operands = operands
    year.hbm_bytes_per_step = _hbm_bytes_per_step(
        operands, t_dim, nz * nh, seasonal_flags)
    year.est_flops_per_step = t_dim * nz * nh * (
        STENCIL_CELL_OPS if stencil else FLUX_CELL_OPS)
    return year
