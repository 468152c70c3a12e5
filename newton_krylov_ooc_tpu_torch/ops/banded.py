"""banded LU factorization and solves (no pivoting).

Port of the native-complex part of newton_krylov_ooc_tpu/ops/banded.py:
dense_to_bands, bands_add_diag, banded_lu_factor, banded_lu_solve and their
batched forms, in float32, float64, complex64 and complex128.  The JAX
module scans the rows and vmaps the batch.  Here the plain versions
(banded_lu_factor_plain, banded_lu_solve_plain) run the rows as a Python
loop over whole batches; on a CUDA tensor the factor and the solves launch
the hand-written kernel of ops/banded_cuda.py (csrc/banded_lu.cu) or
raise, and the plain loops run only for tensors on the CPU.  Callers: the
stage solves of the banded Radau year (ops/radau.py), the phosphorus
preconditioner's eigen iterations (ops/eigen.py) and the vertical-product
preconditioner of the sharded 2D kernels (parallel/sharded_year.py).

The JAX module's interleaved-real forms (complex_shift_bands,
complex_banded_solve) exist because the TPU has no complex128; the card
has, and the port factors the complex stage system natively, as the JAX
integrator does off the TPU.  Its block-banded LU has no caller on the
port's paths yet.

No pivoting: the matrices factored here are strongly diagonally dominant,
the textbook case where pivot-free LU is stable.

Row-band storage: bands[..., i, d] = A[i, i + d - bw] for d in [0, 2*bw];
entries outside the matrix are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from . import banded_cuda


def dense_to_bands(mat, bw):
    """(m, m) dense -> (m, 2bw+1) row-band storage (numpy, for tests/setup)"""
    mat = np.asarray(mat)
    m = mat.shape[0]
    bands = np.zeros((m, 2 * bw + 1), mat.dtype)
    for d in range(2 * bw + 1):
        off = d - bw
        idx = np.arange(max(0, -off), min(m, m - off))
        bands[idx, d] = mat[idx, idx + off]
    return bands


def bands_add_diag(bands, val):
    """bands with val added to the main diagonal (a new tensor)"""
    bw = (bands.shape[-1] - 1) // 2
    out = bands.clone()
    out[..., bw] += val
    return out


def banded_lu_factor_plain(bands):
    """LU of (..., m, 2bw+1) row-band matrices in plain PyTorch; L's
    multipliers overwrite the lower band, U the diagonal and upper band"""
    m, width = bands.shape[-2:]
    bw = (width - 1) // 2
    lead = bands.shape[:-2]
    device = bands.device
    # pad so the elimination window below the last pivot stays in bounds
    mat = torch.cat([bands, bands.new_zeros(lead + (bw, width))], dim=-2)
    k_idx = torch.arange(bw, device=device)
    col_idx = torch.arange(width, device=device)
    lower = bw - 1 - k_idx
    # row i+1+k aligns with the pivot row shifted by k+1
    shift_idx = k_idx[:, None] + 1 + col_idx[None, :]
    zero = bands.new_zeros(())
    pad = bands.new_zeros(lead + (bw + 1,))
    for i in range(m - 1):
        pivot_row = mat[..., i, :]
        window = mat[..., i + 1:i + 1 + bw, :]
        # l[k] = A[i+1+k, i] / A[i, i] at band position bw - (k+1)
        l_vec = window[..., k_idx, lower] / pivot_row[..., bw:bw + 1]
        # only the pivot row's U part participates; its lower band holds
        # already-stored multipliers, not matrix entries
        pivot_u = torch.where(col_idx >= bw, pivot_row, zero)
        pivot_pad = torch.cat([pivot_u, pad], dim=-1)
        window = window - l_vec[..., None] * pivot_pad[..., shift_idx]
        # store the multipliers where the eliminated entries lived
        window[..., k_idx, lower] = l_vec
        mat[..., i + 1:i + 1 + bw, :] = window
    return mat[..., :m, :].contiguous()


def banded_lu_solve_plain(factored, rhs):
    """solve A x = rhs along the last axis of rhs, given
    banded_lu_factor_plain's output, in plain PyTorch; the leading
    dimensions of factored (..., m, width) and rhs (..., m) broadcast.

    Left-looking, in the JAX module's order: a row's value is its
    right-hand side less the sum of its band's products with the bw values
    before it (after it, going back)."""
    m, width = factored.shape[-2:]
    bw = (width - 1) // 2
    rhs = rhs.to(factored.dtype)
    lead = torch.broadcast_shapes(factored.shape[:-2], rhs.shape[:-1])
    rhs = torch.broadcast_to(rhs, lead + (m,))

    # forward substitution: y[i] = b[i] - sum_k L[i, i-k] y[i-k], k = 1..bw;
    # y[i] at ys[..., bw + i], so row i's history is ys[..., i:i + bw]
    ys = rhs.new_zeros(lead + (bw + m,))
    for i in range(m):
        ys[..., bw + i] = rhs[..., i] - torch.sum(
            factored[..., i, :bw] * ys[..., i:i + bw], dim=-1)

    # back substitution: x[i] = (y[i] - sum_k U[i, i+k] x[i+k]) / U[i, i];
    # x[i] at xs[..., i], so row i's history is xs[..., i + 1:i + 1 + bw]
    xs = rhs.new_zeros(lead + (m + bw,))
    for i in range(m - 1, -1, -1):
        row = factored[..., i, :]
        xs[..., i] = (ys[..., bw + i] - torch.sum(
            row[..., bw + 1:] * xs[..., i + 1:i + 1 + bw], dim=-1)) / row[..., bw]
    return xs[..., :m].contiguous()


def _check_dims(name, arr, ndim):
    if arr.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-d tensor, got shape "
                         f"{tuple(arr.shape)}")


def banded_lu_factor(bands):
    """LU of one (m, 2bw+1) row-band matrix; returns the factored bands"""
    _check_dims("banded_lu_factor", bands, 2)
    return banded_lu_factor_blocks(bands[None])[0]


def banded_lu_solve(factored, rhs):
    """solve A x = rhs (..., m) given banded_lu_factor output"""
    _check_dims("banded_lu_solve", factored, 2)
    return banded_lu_solve_blocks(factored[None], rhs[..., None, :])[..., 0, :]


def banded_lu_factor_blocks(bands, *, out=None, due=None):
    """banded_lu_factor over a leading block axis: (B, m, 2bw+1).

    On the CPU the plain loop; on a CUDA tensor the kernel
    (ops/banded_cuda.py), or it raises.  out: where the factors go (a new
    tensor if None); due: a 0-d bool tensor, or None: where it is False
    nothing is factored and `out` keeps what it held.
    """
    _check_dims("banded_lu_factor_blocks", bands, 3)
    if bands.device.type != "cpu":
        return banded_cuda.factor_blocks(bands.contiguous(), out=out, due=due)
    if due is not None:
        if out is None:
            raise ValueError("banded_lu_factor_blocks: due needs out")
        if not bool(due):
            return out
    factored = banded_lu_factor_plain(bands)
    if out is None:
        return factored
    return out.copy_(factored)


def banded_lu_solve_blocks(factored, rhs, *, active=None):
    """banded_lu_solve over a leading block axis: factored (B, m, 2bw+1),
    rhs (..., B, m) -- extra leading axes of rhs share the factors.  On
    the CPU the plain loop; on a CUDA tensor the kernel, or it raises.
    active: a 0-d bool tensor, or None: where it is False the result is
    rhs, unsolved."""
    _check_dims("banded_lu_solve_blocks", factored, 3)
    if factored.device.type != "cpu":
        return banded_cuda.solve_blocks(
            factored.contiguous(), rhs.to(factored.dtype).contiguous(),
            active=active)
    if active is not None and not bool(active):
        return rhs.to(factored.dtype).clone()
    return banded_lu_solve_plain(factored, rhs)
