"""banded LU factorization and solves (no pivoting).

Port of the real-band part of newton_krylov_ooc_tpu/ops/banded.py:
dense_to_bands, banded_lu_factor, banded_lu_solve and their batched forms.
The JAX module scans the rows and vmaps the batch; here the rows are a
Python loop and the batch is a leading dimension written out, so every step
works on whole batches.  The vertical-product preconditioner of the sharded
2D kernels (parallel/sharded_year.py) factors one 7-band matrix per (tracer,
column) with it.  The complex-shift and block-banded solves of the Radau
path are ROADMAP A3.1.

No pivoting: the matrices factored here are strongly diagonally dominant,
the textbook case where pivot-free LU is stable.

Row-band storage: bands[..., i, d] = A[i, i + d - bw] for d in [0, 2*bw];
entries outside the matrix are zero.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _factor(bands):
    """LU of (..., m, 2bw+1) row-band matrices; L's multipliers overwrite
    the lower band, U the diagonal and upper band"""
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
    return mat[..., :m, :]


def _solve(factored, rhs):
    """solve A x = rhs along the last axis of rhs, given _factor's output;
    the leading dimensions of factored (..., m, width) and rhs (..., m)
    broadcast"""
    m, width = factored.shape[-2:]
    bw = (width - 1) // 2
    rhs = rhs.to(factored.dtype)
    lead = torch.broadcast_shapes(factored.shape[:-2], rhs.shape[:-1])

    # forward substitution: y[i] = b[i] - sum_k L[i, i-k] y[i-k], k = 1..bw
    hist = rhs.new_zeros(lead + (bw,))  # latest y values, hist[-1] newest
    y = []
    for i in range(m):
        y_i = rhs[..., i] - torch.sum(factored[..., i, :bw] * hist, dim=-1)
        hist = torch.cat([hist[..., 1:], y_i[..., None]], dim=-1)
        y.append(y_i)

    # back substitution: x[i] = (y[i] - sum_k U[i, i+k] x[i+k]) / U[i, i]
    hist = rhs.new_zeros(lead + (bw,))  # next x values, hist[0] nearest
    x = [None] * m
    for i in range(m - 1, -1, -1):
        row = factored[..., i, :]
        x_i = (y[i] - torch.sum(row[..., bw + 1:] * hist, dim=-1)) / row[..., bw]
        hist = torch.cat([x_i[..., None], hist[..., :-1]], dim=-1)
        x[i] = x_i
    return torch.stack(x, dim=-1)


def _check_dims(name, arr, ndim):
    if arr.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-d tensor, got shape "
                         f"{tuple(arr.shape)}")


def banded_lu_factor(bands):
    """LU of one (m, 2bw+1) row-band matrix; returns the factored bands"""
    _check_dims("banded_lu_factor", bands, 2)
    return _factor(bands)


def banded_lu_solve(factored, rhs):
    """solve A x = rhs (m,) given banded_lu_factor output"""
    _check_dims("banded_lu_solve", factored, 2)
    return _solve(factored, rhs)


def banded_lu_factor_blocks(bands):
    """banded_lu_factor over a leading block axis: (B, m, 2bw+1)"""
    _check_dims("banded_lu_factor_blocks", bands, 3)
    return _factor(bands)


def banded_lu_solve_blocks(factored, rhs):
    """banded_lu_solve over a leading block axis: factored (B, m, 2bw+1),
    rhs (..., B, m) -- extra leading axes of rhs share the factors"""
    _check_dims("banded_lu_solve_blocks", factored, 3)
    return _solve(factored, rhs)
