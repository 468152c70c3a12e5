"""deterministic eigen iterations for banded operators, on the operator's
device.

Port of newton_krylov_ooc_tpu/ops/eigen.py.  The phosphorus
preconditioner needs the extreme eigenvalues and the null vector of its
implicit-Euler operator (the reference reaches for host ARPACK).  Here, as
in the JAX package, they come from fixed-iteration subspace (orthogonal)
iteration:

  * largest eigenvalues: Q <- orth(A Q) with banded matvecs,
  * smallest eigenvalues and the null vector: Q <- orth((A - sigma I)^{-1}
    Q) through the pivot-free banded LU (ops/banded.py: on a card its
    hand-written kernel, every iteration's k + pad columns in one solve
    launch), with the dominant near-null mode converged first and locked,
  * Ritz values from the k x k projection Q^T A Q, eigendecomposed on the
    host in float64 numpy (k is tiny; the O(n) work stays on the device).

The start basis is the JAX package's seeded numpy one.  QR's column signs
may differ between LAPACK, XLA and the card's solver; the Ritz values and
the normalised null vector do not depend on them.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import (
    banded_lu_factor,
    banded_lu_solve,
    banded_lu_solve_blocks,
    bands_add_diag,
)


def band_matvec(bands, x):
    """y = A x along the last axis of x, for row-band storage
    bands[i, d] = A[i, i + d - bw]"""
    width = bands.shape[-1]
    bw = (width - 1) // 2
    x_ext = torch.nn.functional.pad(x.to(bands.dtype), (bw, bw))
    return torch.sum(bands * x_ext.unfold(-1, width, 1), dim=-1)


def _matvec_cols(bands, q):
    """A q for the columns of q (n, k)"""
    return band_matvec(bands, q.T).T


def _solve_cols(lu, q):
    """A^{-1} q for the columns of q (n, k): one solve of k right-hand sides"""
    rhs = q.T.contiguous()[:, None, :]
    return banded_lu_solve_blocks(lu[None], rhs)[:, 0, :].T


def _subspace_fwd(bands, iters, q0):
    """orthogonal iteration with A matvecs; returns (q, h = q^T A q)"""
    q = q0
    for _ in range(iters):
        q, _ = torch.linalg.qr(_matvec_cols(bands, q))
    return q, q.T @ _matvec_cols(bands, q)


def _subspace_inv(bands, sigma, iters, q0):
    """inverse orthogonal iteration through (A - sigma I)^{-1} with locking
    of the dominant (near-null) mode; returns (q, h = q^T A q).

    With sigma far below the rest of the spectrum, the near-null eigenvector
    dominates every solve by ~1/sigma and would contaminate the remaining
    Ritz directions at each QR in floating point.  So the dominant vector is
    converged first (a few power steps -- its convergence ratio is
    ~sigma/|lambda_1|) and LOCKED: the rest of the block iterates with the
    locked direction projected out after every solve."""
    lu = banded_lu_factor(bands_add_diag(bands, -sigma))

    # stage 1: the dominant inverse mode (the near-null vector of A)
    v = q0[:, 0]
    for _ in range(8):
        z = banded_lu_solve(lu, v)
        v = z / torch.linalg.norm(z)

    # stage 2: deflated block iteration for the remaining columns
    q_rest = q0[:, 1:] - torch.outer(v, v @ q0[:, 1:])
    for _ in range(iters):
        z = _solve_cols(lu, q_rest)
        z = z - torch.outer(v, v @ z)
        q_rest, _ = torch.linalg.qr(z)
    q = torch.cat([v[:, None], q_rest], dim=1)
    return q, q.T @ _matvec_cols(bands, q)


def _start_basis(n, k, dtype, device):
    """deterministic orthonormal start: seeded Gaussian + QR (host, tiny),
    the JAX package's"""
    rng = np.random.default_rng(20260817)
    q0, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return torch.as_tensor(q0, dtype=dtype, device=device)


def banded_extreme_eigs(bands, k=5, iters=100, pad=3):
    """largest-|lambda| Ritz values of the banded operator (descending)"""
    n = bands.shape[0]
    kk = min(k + pad, n)
    q0 = _start_basis(n, kk, bands.dtype, bands.device)
    _q, h = _subspace_fwd(bands, int(iters), q0)
    vals = np.linalg.eigvals(h.cpu().numpy().astype(np.float64))
    return vals[np.argsort(-np.abs(vals))][:k]


def banded_smallest_eigs(bands, sigma, k=5, iters=100, pad=3):
    """smallest-|lambda| eigen pairs of A via shift-inverted iteration.

    sigma regularizes the factorization of a (near-)singular A -- keep it
    well below the eigenvalues of interest (roundoff keeps the pivot-free
    LU viable even for an exactly singular A, so sigma ~ 1e-8 * diag scale
    works).  Returns (vals, vecs) in numpy: vals (k,) complex ascending
    |lambda|, vecs (n, k) the corresponding real Ritz vectors (columns;
    complex pairs contribute their real part).
    """
    n = bands.shape[0]
    kk = min(k + pad, n)
    q0 = _start_basis(n, kk, bands.dtype, bands.device)
    q, h = _subspace_inv(bands, sigma, int(iters), q0)
    vals, small_vecs = np.linalg.eig(h.cpu().numpy().astype(np.float64))
    order = np.argsort(np.abs(vals))[:k]
    vals = vals[order]
    vecs = q.cpu().numpy().astype(np.float64) @ small_vecs[:, order].real
    return vals, vecs


def banded_shift_solve(bands, shift, rhs):
    """solve (A - shift I) x = rhs through the banded LU (on bands' device)"""
    lu = banded_lu_factor(bands_add_diag(bands, -shift))
    return banded_lu_solve(lu, rhs)


__all__ = [
    "band_matvec",
    "banded_extreme_eigs",
    "banded_smallest_eigs",
    "banded_shift_solve",
]
