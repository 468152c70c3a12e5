"""the pivot-free banded LU and its solves as a hand-written CUDA kernel
(csrc/banded_lu.cu), the card route of ops/banded.py.

`factor_blocks(bands)` factors B row-band matrices (B, m, 2bw+1) and
`solve_blocks(factored, rhs)` solves rhs (..., B, m) against them, extra
leading axes of rhs sharing the factors: the same storage and arithmetic
as the JAX package's banded_lu_factor / banded_lu_solve (ops/banded.py
there, a lax.scan over rows, vmapped over blocks), in float32, float64,
complex64 or complex128.  The kernel replaces no Pallas kernel: it stands
for that scan on the card (the note at the top of the source gives the
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
# csrc/banded_lu.cu's kMaxBandwidth: a factor window of (bw + 2)^2 slots,
# 32 a thread of 1024 at most
MAX_BANDWIDTH = 179


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
    return load_library("banded_lu", {
        # dtype, bw -> threads, shared, smem
        "factor_plan": ([c_int, c_int, ctypes.POINTER(c_int),
                         ctypes.POINTER(c_int), ctypes.POINTER(c_long)], c_int),
        # dtype, in, out, due, n_blocks, m, bw, stream
        "factor_launch": ([c_int, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int,
                           c_ptr], c_int),
        # dtype, lu, x, active, n_rhs, n_blocks, m, bw, stream
        "solve_launch": ([c_int, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int,
                          c_int, c_ptr], c_int),
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
    """(threads a block, window in shared memory, shared-memory bytes) of a
    factorisation of `dtype` at half-width bw on a CUDA `device`"""
    lib = _library()
    threads, shared = ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_long(0)
    with torch.cuda.device(device):
        _raise_on(lib, lib.banded_lu_factor_plan(
            _DTYPES[dtype], bw, ctypes.byref(threads), ctypes.byref(shared),
            ctypes.byref(smem)), "banded_lu_factor_plan")
    return threads.value, bool(shared.value), smem.value


def factor_blocks(bands, *, out=None, due=None):
    """LU of (B, m, 2bw+1) row-band matrices on the card: L's multipliers in
    the lower band, U in the diagonal and upper band.

    out: where the factors go (a new tensor if None), distinct from bands;
    due: a 0-d bool tensor on the same device, or None: where it holds
    False the kernel returns at once and `out` keeps what it held.
    """
    global banded_factor_launches
    n_blocks, m, bw = _check_bands("banded_lu_factor_blocks", bands)
    if out is None:
        out = torch.empty_like(bands)
    elif (not isinstance(out, torch.Tensor) or out.shape != bands.shape
          or out.dtype != bands.dtype or out.device != bands.device
          or not out.is_contiguous() or out.data_ptr() == bands.data_ptr()):
        raise ValueError("banded_lu_factor_blocks: out must be a contiguous "
                         "tensor like bands, distinct from it")
    due_ptr = _flag_ptr("banded_lu_factor_blocks", "due", due, bands.device)
    lib = _library()
    with torch.cuda.device(bands.device):
        stream = torch.cuda.current_stream(bands.device).cuda_stream
        err = lib.banded_lu_factor_launch(
            _DTYPES[bands.dtype], bands.data_ptr(), out.data_ptr(), due_ptr,
            n_blocks, m, bw, stream)
    _raise_on(lib, err, "banded_lu_factor_blocks")
    banded_factor_launches += 1
    return out


def solve_blocks(factored, rhs, *, active=None):
    """solve A x = rhs on the card: factored (B, m, 2bw+1) from
    factor_blocks, rhs (..., B, m) of the same dtype and device,
    contiguous; returns x like rhs.  active: a 0-d bool tensor on the same
    device, or None: where it holds False, x is rhs unsolved."""
    global banded_solve_launches
    n_blocks, m, bw = _check_bands("banded_lu_solve_blocks", factored)
    if not isinstance(rhs, torch.Tensor):
        raise TypeError(f"banded_lu_solve_blocks takes a torch.Tensor rhs, "
                        f"got {type(rhs).__name__}")
    if rhs.device != factored.device or rhs.dtype != factored.dtype:
        raise ValueError(f"banded_lu_solve_blocks: rhs is {rhs.dtype} on "
                         f"{rhs.device}, the factors {factored.dtype} on "
                         f"{factored.device}")
    if rhs.dim() < 2 or tuple(rhs.shape[-2:]) != (n_blocks, m):
        raise ValueError(f"banded_lu_solve_blocks: rhs has shape "
                         f"{tuple(rhs.shape)}, expected (..., {n_blocks}, {m})")
    if not rhs.is_contiguous():
        raise ValueError("banded_lu_solve_blocks takes a contiguous rhs")
    active_ptr = _flag_ptr("banded_lu_solve_blocks", "active", active,
                           factored.device)
    x = rhs.clone()
    lib = _library()
    with torch.cuda.device(factored.device):
        stream = torch.cuda.current_stream(factored.device).cuda_stream
        err = lib.banded_lu_solve_launch(
            _DTYPES[factored.dtype], factored.data_ptr(), x.data_ptr(),
            active_ptr, rhs.numel() // m, n_blocks, m, bw, stream)
    _raise_on(lib, err, "banded_lu_solve_blocks")
    banded_solve_launches += 1
    return x
