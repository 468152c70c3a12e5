"""tridiagonal solvers along the last axis of batched tensors.

Port of newton_krylov_ooc_tpu/ops/tridiag.py.  The JAX `thomas_solve` scans
one system and vmaps the batch; here the batch is written out: every
argument is (..., n) and the recurrence loops over the last axis with whole
batches per step.  `pcr_solve` is parallel cyclic reduction,
ceil(log2(n)) vectorized stages -- the plain version of the CN solves in
ops/imex.py.  `thomas_solve_np` is the numpy host solver (a copy of the JAX
package's), which the file-backed test_problem preconditioners use.
"""

from __future__ import annotations

import numpy as np
import torch


def thomas_solve_np(dl, d, du, b):
    """numpy Thomas solve (host path), same argument convention"""
    n = d.shape[-1]
    dl = np.asarray(dl, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    du = np.asarray(du, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.empty_like(d)
    g = np.empty_like(b)
    c[..., 0] = du[..., 0] / d[..., 0]
    g[..., 0] = b[..., 0] / d[..., 0]
    for i in range(1, n):
        denom = d[..., i] - dl[..., i] * c[..., i - 1]
        c[..., i] = du[..., i] / denom
        g[..., i] = (b[..., i] - dl[..., i] * g[..., i - 1]) / denom
    x = np.empty_like(b)
    x[..., -1] = g[..., -1]
    for i in range(n - 2, -1, -1):
        x[..., i] = g[..., i] - c[..., i] * x[..., i + 1]
    return x


def thomas_solve(dl, d, du, b):
    """
    solve tridiagonal systems with sub/main/super diagonals (dl, d, du)

    all arguments (..., n), dl[..., 0] and du[..., -1] unused; solves along
    the last axis, batched over the leading ones
    """
    n = d.shape[-1]
    c = torch.empty_like(d)
    g = torch.empty_like(b)
    c[..., 0] = du[..., 0] / d[..., 0]
    g[..., 0] = b[..., 0] / d[..., 0]
    for i in range(1, n):
        denom = d[..., i] - dl[..., i] * c[..., i - 1]
        c[..., i] = du[..., i] / denom
        g[..., i] = (b[..., i] - dl[..., i] * g[..., i - 1]) / denom
    x = torch.empty_like(b)
    x[..., -1] = g[..., -1]
    for i in range(n - 2, -1, -1):
        x[..., i] = g[..., i] - c[..., i] * x[..., i + 1]
    return x


def thomas_solve_batch(dl, d, du, b):
    """batched Thomas solve: all args (batch, n); solves along the last axis"""
    if d.dim() != 2:
        raise ValueError(f"expected (batch, n) arguments, got shape {tuple(d.shape)}")
    return thomas_solve(dl, d, du, b)


def _shifted(arr, shift, fill):
    """arr shifted so that out[..., i] = arr[..., i + shift], padded with fill"""
    pad = torch.full(arr.shape[:-1] + (abs(shift),), fill, dtype=arr.dtype,
                     device=arr.device)
    if shift > 0:
        return torch.cat([arr[..., shift:], pad], dim=-1)
    return torch.cat([pad, arr[..., :shift]], dim=-1)


def pcr_solve(dl, d, du, b):
    """parallel-cyclic-reduction tridiagonal solve along the LAST axis

    All arguments (..., n) with the Thomas convention (dl[..., 0] and
    du[..., -1] unused).  Stable for the diagonally dominant Crank-Nicolson
    systems of the IMEX year; out-of-range neighbors act as identity rows.
    """
    n = d.shape[-1]
    if n == 1:
        return b / d
    idx = torch.arange(n, device=d.device)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    a_c = torch.where(idx == 0, zero, dl)
    c_c = torch.where(idx == n - 1, zero, du)
    b_c, r_c = d, b

    stride = 1
    while stride < n:
        a_m = _shifted(a_c, -stride, 0.0)
        b_m = _shifted(b_c, -stride, 1.0)
        c_m = _shifted(c_c, -stride, 0.0)
        r_m = _shifted(r_c, -stride, 0.0)
        a_p = _shifted(a_c, stride, 0.0)
        b_p = _shifted(b_c, stride, 1.0)
        c_p = _shifted(c_c, stride, 0.0)
        r_p = _shifted(r_c, stride, 0.0)

        alpha = -a_c / b_m
        gamma = -c_c / b_p
        a_c = alpha * a_m
        c_c = gamma * c_p
        b_c = b_c + alpha * c_m + gamma * a_p
        r_c = r_c + alpha * r_m + gamma * r_p
        stride *= 2

    return r_c / b_c
