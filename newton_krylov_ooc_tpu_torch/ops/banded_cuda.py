"""the pivot-free banded LU and its solves as a hand-written CUDA kernel
(csrc/banded_lu.cu), the card route of ops/banded.py.

`factor_blocks(bands)` factors B row-band matrices (B, m, 2bw+1) and
`solve_blocks(factored, rhs)` solves rhs (..., B, m) against them, extra
leading axes of rhs sharing the factors: the same storage and arithmetic
as the JAX package's banded_lu_factor / banded_lu_solve (ops/banded.py
there, a lax.scan over rows, vmapped over blocks), in float32, float64,
complex64 or complex128.  `factor_pair` and `solve_pair` do the same for a
real system and its complex twin of the same precision and shape (Radau's
two stage systems) in one launch; a pair launch counts as one launch.  The
kernel replaces no Pallas kernel: it stands for that scan on the card (the note at the top of the source gives the
design and what bounds it).  Its plain version is
ops/banded.py::banded_lu_factor_plain / banded_lu_solve_plain.

Both take contiguous CUDA tensors and launch on the current stream into
outputs allocated here (or the caller's `out`), so a CUDA graph captures
them; they refuse any other dtype, device, shape or layout, and launch
nothing then.  `factor_blocks(..., due=flag)` reads a device bool and
leaves `out` as it is where the flag is false, `solve_blocks(...,
active=flag)` returns rhs unsolved: a captured factorisation or solve
that runs only when a step needs it, with no read on the host.  The kernel
is compiled with nvcc at first use (ops/imex_cuda.py::build_libraries).
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches in this process (one per call on a CUDA tensor; a CUDA
# graph's replays are added by whoever replays it); callers reset them to 0
# to count a run's launches
banded_factor_launches = 0
banded_solve_launches = 0

# csrc/banded_lu.cu's dtype codes
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
# csrc/banded_lu.cu's kMaxBandwidth: the widest factor window, 6 rows a
# lane and 8 columns a thread in 23 warps
MAX_BANDWIDTH = 179
# the complex twin of each real dtype; csrc/banded_lu.cu's precision codes
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_PRECISION = {torch.float32: 0, torch.float64: 1, torch.complex64: 0,
              torch.complex128: 1}
# csrc/banded_lu.cu's window locations
_WHERE = ("registers", "shared", "device")
_plans = {}  # (dtype, bw, device index) -> factor_plan


def launch_counts():
    """(factor launches, solve launches) so far"""
    return banded_factor_launches, banded_solve_launches


def add_launches(factor, solve):
    """count launches that a CUDA graph replayed"""
    global banded_factor_launches, banded_solve_launches
    banded_factor_launches += factor
    banded_solve_launches += solve


def set_launch_counts(factor, solve):
    global banded_factor_launches, banded_solve_launches
    banded_factor_launches, banded_solve_launches = factor, solve


def _library():
    # imported here: ops/imex_cuda.py imports the py_driver_2d models, whose
    # physics imports ops/banded.py, which imports this module
    from .imex_cuda import load_library

    c_int, c_ptr, c_long = ctypes.c_int, ctypes.c_void_p, ctypes.c_long
    p_int, p_long = ctypes.POINTER(c_int), ctypes.POINTER(c_long)
    return load_library("banded_lu", {
        # dtype, bw -> threads, where, smem, scratch
        "factor_plan": ([c_int, c_int, p_int, p_int, p_long, p_long], c_int),
        # precision, in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m,
        # bw, stream
        "factor_launch": ([c_int, c_ptr, c_ptr, c_int, c_ptr, c_ptr, c_int,
                           c_ptr, c_ptr, c_int, c_int, c_ptr], c_int),
        # precision, lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c,
        # active, m, bw, stream
        "solve_launch": ([c_int, c_ptr, c_ptr, c_int, c_int, c_ptr, c_ptr,
                          c_int, c_int, c_ptr, c_int, c_int, c_ptr], c_int),
    })


def _check_bands(what, bands):
    """(B, m, bw) of a contiguous CUDA band tensor, or raise"""
    if not isinstance(bands, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor, got "
                        f"{type(bands).__name__}")
    if bands.device.type != "cuda":
        raise ValueError(f"{what} runs the CUDA kernel: the bands lie on "
                         f"{bands.device}")
    if bands.dtype not in _DTYPES:
        raise ValueError(f"{what} takes {sorted(map(str, _DTYPES))}, got "
                         f"{bands.dtype}")
    if bands.dim() != 3 or bands.shape[-1] % 2 != 1 or 0 in bands.shape:
        raise ValueError(f"{what} takes (B, m, 2bw+1) bands, got shape "
                         f"{tuple(bands.shape)}")
    if not bands.is_contiguous():
        raise ValueError(f"{what} takes contiguous bands")
    n_blocks, m, width = bands.shape
    bw = (width - 1) // 2
    if bw > MAX_BANDWIDTH:
        raise ValueError(f"{what}: half-width {bw} is over the kernel's "
                         f"{MAX_BANDWIDTH}")
    return n_blocks, m, bw


def check_pair(what, real, cplx):
    """refuse a real and a complex system that are not twins: the complex
    dtype of the real one's precision, the same blocks, rows and bands, the
    same device"""
    for name, arr in (("real", real), ("complex", cplx)):
        if not isinstance(arr, torch.Tensor):
            raise TypeError(f"{what} takes torch.Tensors, got "
                            f"{type(arr).__name__} for the {name} system")
    if real.dtype not in _COMPLEX_OF or cplx.dtype != _COMPLEX_OF[real.dtype]:
        raise ValueError(f"{what} takes float32 + complex64 or float64 + "
                         f"complex128 systems, got {real.dtype} + {cplx.dtype}")
    if real.shape != cplx.shape:
        raise ValueError(f"{what}: the real system has shape "
                         f"{tuple(real.shape)}, the complex one "
                         f"{tuple(cplx.shape)}")
    if real.device != cplx.device:
        raise ValueError(f"{what}: the real system lies on {real.device}, "
                         f"the complex one on {cplx.device}")


def check_distinct(what, outs, ins):
    """refuse an output that shares memory with an input or another
    output"""
    outs = [arr for arr in outs if arr is not None]
    for num, out in enumerate(outs):
        for other in list(ins) + outs[num + 1:]:
            if out.data_ptr() == other.data_ptr():
                raise ValueError(f"{what}: each out must be distinct from "
                                 "the bands and from the other out")


def _raise_on(lib, err, what):
    if err:
        msg = lib.banded_lu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _flag_ptr(what, name, flag, device):
    """the device address of a one-bool flag tensor, or None"""
    if flag is None:
        return None
    if (not isinstance(flag, torch.Tensor) or flag.dtype != torch.bool
            or flag.numel() != 1 or flag.device != device):
        raise ValueError(f"{what}: {name} must be one bool on the bands' "
                         "device")
    return flag.data_ptr()


def factor_plan(dtype, bw, device):
    """(threads a block, where the factor's window lives -- "registers",
    "shared" or "device" memory --, dynamic shared-memory bytes a block,
    device-memory window bytes a matrix) of a factorisation of `dtype` at
    half-width bw on a CUDA `device`"""
    device = torch.device(device)
    key = (dtype, bw, device.index)
    if key not in _plans:
        _plans[key] = _factor_plan(dtype, bw, device)
    return _plans[key]


def _factor_plan(dtype, bw, device):
    lib = _library()
    threads, where = ctypes.c_int(0), ctypes.c_int(0)
    smem, scratch = ctypes.c_long(0), ctypes.c_long(0)
    with torch.cuda.device(device):
        _raise_on(lib, lib.banded_lu_factor_plan(
            _DTYPES[dtype], bw, ctypes.byref(threads), ctypes.byref(where),
            ctypes.byref(smem), ctypes.byref(scratch)), "banded_lu_factor_plan")
    return threads.value, _WHERE[where.value], smem.value, scratch.value


def _out_for(what, bands, out):
    if out is None:
        return torch.empty_like(bands)
    if (not isinstance(out, torch.Tensor) or out.shape != bands.shape
            or out.dtype != bands.dtype or out.device != bands.device
            or not out.is_contiguous() or out.data_ptr() == bands.data_ptr()):
        raise ValueError(f"{what}: out must be a contiguous tensor like "
                         "bands, distinct from it")
    return out


def _factor(what, real, cplx, due):
    """one launch: real and cplx are (bands, out) or None"""
    global banded_factor_launches
    first = real if real is not None else cplx
    n_blocks, m, bw = _check_bands(what, first[0])
    device = first[0].device
    due_ptr = _flag_ptr(what, "due", due, device)
    scratch = 0
    for system in (real, cplx):
        if system is not None:
            scratch += system[0].shape[0] * factor_plan(
                system[0].dtype, bw, device)[3]
    buf = (torch.empty(scratch, dtype=torch.uint8, device=device)
           if scratch else None)

    def ptrs(system):
        if system is None:
            return None, None, 0
        return system[0].data_ptr(), system[1].data_ptr(), system[0].shape[0]

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.banded_lu_factor_launch(
            _PRECISION[first[0].dtype], *ptrs(real), *ptrs(cplx),
            None if buf is None else buf.data_ptr(), due_ptr, m, bw, stream)
    _raise_on(lib, err, what)
    banded_factor_launches += 1


def factor_blocks(bands, *, out=None, due=None):
    """LU of (B, m, 2bw+1) row-band matrices on the card: L's multipliers in
    the lower band, U in the diagonal and upper band.

    out: where the factors go (a new tensor if None), distinct from bands;
    due: a 0-d bool tensor on the same device, or None: where it holds
    False the kernel returns at once and `out` keeps what it held.
    """
    what = "banded_lu_factor_blocks"
    _check_bands(what, bands)
    out = _out_for(what, bands, out)
    system = (bands, out)
    if bands.dtype.is_complex:
        _factor(what, None, system, due)
    else:
        _factor(what, system, None, due)
    return out


def factor_pair(bands_r, bands_c, *, out_r=None, out_c=None, due=None):
    """factor_blocks of a real system and its complex twin (the complex
    dtype of its precision, the same shape) in one launch; returns (out_r,
    out_c).  due, as factor_blocks', for both."""
    what = "banded_lu_factor_pair"
    check_pair(what, bands_r, bands_c)
    _check_bands(what, bands_r)
    _check_bands(what, bands_c)
    out_r = _out_for(what, bands_r, out_r)
    out_c = _out_for(what, bands_c, out_c)
    check_distinct(what, (out_r, out_c), (bands_r, bands_c))
    _factor(what, (bands_r, out_r), (bands_c, out_c), due)
    return out_r, out_c


def _check_rhs(what, factored, rhs):
    n_blocks, m, _bw = _check_bands(what, factored)
    if not isinstance(rhs, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor rhs, got "
                        f"{type(rhs).__name__}")
    if rhs.device != factored.device or rhs.dtype != factored.dtype:
        raise ValueError(f"{what}: rhs is {rhs.dtype} on {rhs.device}, the "
                         f"factors {factored.dtype} on {factored.device}")
    if rhs.dim() < 2 or tuple(rhs.shape[-2:]) != (n_blocks, m):
        raise ValueError(f"{what}: rhs has shape {tuple(rhs.shape)}, "
                         f"expected (..., {n_blocks}, {m})")
    if not rhs.is_contiguous():
        raise ValueError(f"{what} takes a contiguous rhs")


def _solve(what, real, cplx, active):
    """one launch: real and cplx are (factored, rhs) or None; returns the
    solutions (None for a missing system)"""
    global banded_solve_launches
    first = real if real is not None else cplx
    n_blocks, m, bw = _check_bands(what, first[0])
    active_ptr = _flag_ptr(what, "active", active, first[0].device)
    xs = [None if system is None else system[1].clone()
          for system in (real, cplx)]

    def ptrs(system, x):
        if system is None:
            return None, None, 0, 0
        return (system[0].data_ptr(), x.data_ptr(), x.numel() // m,
                system[0].shape[0])

    lib = _library()
    device = first[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.banded_lu_solve_launch(
            _PRECISION[first[0].dtype], *ptrs(real, xs[0]),
            *ptrs(cplx, xs[1]), active_ptr, m, bw, stream)
    _raise_on(lib, err, what)
    banded_solve_launches += 1
    return xs


def solve_blocks(factored, rhs, *, active=None):
    """solve A x = rhs on the card: factored (B, m, 2bw+1) from
    factor_blocks, rhs (..., B, m) of the same dtype and device,
    contiguous; returns x like rhs.  active: a 0-d bool tensor on the same
    device, or None: where it holds False, x is rhs unsolved."""
    what = "banded_lu_solve_blocks"
    _check_rhs(what, factored, rhs)
    system = (factored, rhs)
    if factored.dtype.is_complex:
        return _solve(what, None, system, active)[1]
    return _solve(what, system, None, active)[0]


def solve_pair(lu_r, rhs_r, lu_c, rhs_c, *, active=None):
    """solve_blocks of a real system and its complex twin in one launch;
    returns (x_r, x_c).  active, as solve_blocks', for both."""
    what = "banded_lu_solve_pair"
    check_pair(what, lu_r, lu_c)
    _check_rhs(what, lu_r, rhs_r)
    _check_rhs(what, lu_c, rhs_c)
    x_r, x_c = _solve(what, (lu_r, rhs_r), (lu_c, rhs_c), active)
    return x_r, x_c
