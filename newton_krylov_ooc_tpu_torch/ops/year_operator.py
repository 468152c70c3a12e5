"""dense one-year transition operators for linear tracer modules.

Port of newton_krylov_ooc_tpu/ops/year_operator.py.  For a linear module
the year map is affine, year(X) = B X + c, and B is probed exactly by
running every grid basis column as an extra channel of the batched,
source-free year: n = nz*ny columns a tracer, col_chunk at a time.  After
that one-time cost

    F(X) = (B - I) X + c

is one dense matvec a tracer, a Jacobian-vector product likewise, and the
cyclostationary problem F(X) = 0 is solved directly as (I - B) X = c.

On a card the probe runs through kernel B1 (ops/imex_cuda.py::
build_iage_year), T x col_chunk channels a launch, all on the kernel's one
table of the two tracers' CN factors (the kernel's channel map); elsewhere
through the plain year in the kernel's dtype
(models/py_driver_2d/incore.py::IageKernel.build_year_operator).  The
dense products are torch.matmul in full float32 or float64: the JAX
package computes them outside any Pallas kernel at Precision.HIGHEST, and
ops/compute.py keeps TF32 off.  The eigensolve of spectrum's small
projection runs on the host, as in the JAX module.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .compute import check_no_tf32


class YearOperator:
    """the explicit affine one-year map of a batch of linear tracer fields

    b_mats: (T, n, n) -- each tracer's dense source-free transition operator
    const:  (T, nz, ny) -- year(0) with the sources on
    Both tensors on one device and in one dtype.
    """

    def __init__(self, b_mats, const, nz, ny):
        self.nz = int(nz)
        self.ny = int(ny)
        self.n = self.nz * self.ny
        self.t_dim = int(b_mats.shape[0])
        if tuple(b_mats.shape) != (self.t_dim, self.n, self.n):
            raise ValueError(f"b_mats has shape {tuple(b_mats.shape)}, "
                             f"expected ({self.t_dim}, {self.n}, {self.n})")
        self.b_mats = b_mats
        self.const = const.reshape(self.t_dim, self.nz, self.ny)

    @classmethod
    def from_numpy(cls, b_mats, const, nz, ny, *, device, dtype=None):
        """the operator of numpy arrays (e.g. a JAX YearOperator's
        np.asarray(op.b_mats) and np.asarray(op.const)) on `device`, in
        their own dtype unless `dtype` is given"""
        b_mats, const = np.asarray(b_mats), np.asarray(const)
        if dtype is None:
            dtype = torch.from_numpy(np.zeros(0, b_mats.dtype)).dtype
        return cls(torch.tensor(b_mats, dtype=dtype, device=device),
                   torch.tensor(const, dtype=dtype, device=device), nz, ny)

    def with_source(self, year_src_fn):
        """the probed B under another source or forcing: the linear part of
        the year map does not depend on the sources, so a new configuration
        needs only its constant response c = year(0), one forward run, not
        a new probe.  year_src_fn: the full year map with the new sources"""
        zeros = torch.zeros_like(self.const)
        return YearOperator(self.b_mats, year_src_fn(zeros), self.nz, self.ny)

    def _apply(self, y):
        """B y, tracer by tracer: (T, nz, ny) -> (T, n)"""
        check_no_tf32()
        flat = y.reshape(self.t_dim, self.n, 1)
        return torch.matmul(self.b_mats, flat)[..., 0]

    def year(self, y):
        return self._apply(y).reshape(y.shape) + self.const.reshape(y.shape)

    def fcn(self, y):
        return self.year(y) - y

    def jvp(self, v):
        return self._apply(v).reshape(v.shape) - v

    def solve_cyclostationary(self, polish_iters=4, ns_iters=64, rtol=1e-4):
        """the direct spin-up: solve (I - B) X = c, then polish with exact
        Newton-Richardson steps.

        The inverse of A = I - B is built by Newton-Schulz iteration
        X <- X (2I - A X), matmuls only, from the standard
        A^T / (|A|_1 |A|_inf) start, as the JAX module does; an inexact
        inverse only slows the polish steps, whose residuals are exact.
        The affine model's residual ||F(X)|| is checked per tracer against
        rtol ||X|| and a warning logged where it is larger (rtol=None skips
        the check)."""
        check_no_tf32()
        b = self.b_mats
        eye = torch.eye(self.n, dtype=b.dtype, device=b.device)
        a = eye - b
        norm1 = a.abs().sum(dim=1).amax(dim=1)       # max column sum
        norm_inf = a.abs().sum(dim=2).amax(dim=1)    # max row sum
        x_inv = a.transpose(1, 2) / (norm1 * norm_inf)[:, None, None]
        for _ in range(int(ns_iters)):
            x_inv = torch.matmul(x_inv, 2.0 * eye - torch.matmul(a, x_inv))
        flat_c = self.const.reshape(self.t_dim, self.n, 1)
        x = torch.matmul(x_inv, flat_c)
        for _ in range(int(polish_iters)):
            # the exact residual of F(x) = B x + c - x, corrected through
            # the approximate inverse
            resid = torch.matmul(b, x) + flat_c - x
            x = x + torch.matmul(x_inv, resid)
        x = x.reshape(self.const.shape)
        if rtol is not None:
            resid = self.rel_resid(x)
            bad = resid > rtol
            if bad.any():
                logging.getLogger(__name__).warning(
                    "solve_cyclostationary did not converge for tracer(s) %s: "
                    "rel resid %s exceeds rtol=%g -- raise ns_iters/"
                    "polish_iters or check the propagator spectrum",
                    np.nonzero(bad)[0].tolist(), resid[bad].tolist(), rtol,
                )
        return x

    def rel_resid(self, x):
        """per-tracer ||B x + c - x|| / max(||x||, tiny) of the affine
        model, as a float64 numpy array"""
        flat = x.reshape(self.t_dim, self.n)
        resid = self._apply(x) + self.const.reshape(self.t_dim, self.n) - flat
        x_norm = torch.sqrt(torch.sum(flat * flat, dim=1))
        r_norm = torch.sqrt(torch.sum(resid * resid, dim=1))
        tiny = torch.finfo(flat.dtype).tiny
        return (r_norm / torch.clamp(x_norm, min=tiny)).double().cpu().numpy()

    def spectrum(self, k=8, iters=200, seed=0):
        """the leading eigenvalues of each tracer's annual propagator B.

        Subspace (orthogonal) iteration on the device -- batched matmuls
        and QR -- then the k x k projection q^T B q is eigendecomposed on
        the host.  Returns (eigvals, timescales_years): eigvals (T, k)
        complex, by descending magnitude, and the e-folding spin-up
        timescales -1/ln|lambda| in years (inf for |lambda| >= 1)."""
        check_no_tf32()
        # the trailing iterated eigenvalue converges slowest: iterate k +
        # pad columns and report the top k
        k = min(int(k), self.n)
        pad = max(4, k // 2)
        kk = min(k + pad, self.n)
        b = self.b_mats
        rng = np.random.default_rng(seed)
        q = torch.as_tensor(rng.standard_normal((self.t_dim, self.n, kk)),
                            dtype=b.dtype, device=b.device)
        q, _ = torch.linalg.qr(q)
        for _ in range(int(iters)):
            q, _ = torch.linalg.qr(torch.matmul(b, q))
        h = torch.matmul(q.transpose(1, 2), torch.matmul(b, q))
        h = h.double().cpu().numpy()

        eigvals = np.empty((self.t_dim, k), np.complex128)
        for t in range(self.t_dim):
            vals = np.linalg.eigvals(h[t])
            eigvals[t] = vals[np.argsort(-np.abs(vals))][:k]
        mags = np.abs(eigvals)
        with np.errstate(divide="ignore", invalid="ignore"):
            timescales = np.where(mags < 1.0, -1.0 / np.log(mags), np.inf)
        return eigvals, timescales


def probe_year_operator(make_year0, year_src_fn, vert_diag, col_chunk=128, *,
                        dtype, device):
    """probe each tracer's dense year operator by basis-column batching

    make_year0(channel_diag: (C, nz, ny) float64 tensor) -> fn((C, nz, ny))
        -> (C, nz, ny): a source-free batched year whose channels carry the
        given implicit local rates (B1 on the card, the plain year
        elsewhere).
    year_src_fn: fn((T, nz, ny)) -> (T, nz, ny): the full year map with
        its sources, run once on zeros for the constant response.
    vert_diag: (T, nz, ny) per-tracer implicit local rates.
    dtype, device: the probe's (the year's dtype and device).

    Every chunk is padded to col_chunk columns, so one year function (a
    fixed channel count) serves every chunk; the channels are tracer-major
    (tracer t's probes are channels t*col_chunk .. (t+1)*col_chunk - 1).
    Returns a YearOperator.
    """
    diag = torch.as_tensor(np.asarray(vert_diag), dtype=torch.float64)
    t_dim, nz, ny = diag.shape
    n = nz * ny
    col_chunk = int(min(col_chunk, n))
    year0 = make_year0(diag.repeat_interleave(col_chunk, dim=0))

    # the columns stay on the device as they come
    cols = torch.arange(col_chunk, device=device)
    col_blocks = []                                       # (T, n, chunk) each
    for start in range(0, n, col_chunk):
        m = min(col_chunk, n - start)
        y0 = torch.zeros((t_dim, col_chunk, n), dtype=dtype, device=device)
        y0[:, cols[:m], start + cols[:m]] = 1.0
        out = year0(y0.reshape(t_dim * col_chunk, nz, ny))
        col_blocks.append(out.reshape(t_dim, col_chunk, n).transpose(1, 2))
    b_mats = torch.cat(col_blocks, dim=2)[:, :, :n].contiguous()
    const = year_src_fn(torch.zeros((t_dim, nz, ny), dtype=dtype,
                                    device=device))
    return YearOperator(b_mats, const, nz, ny)


__all__ = ["YearOperator", "probe_year_operator"]
