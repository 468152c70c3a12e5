"""matrix-free Krylov solves.

Port of newton_krylov_ooc_tpu/ops/sparse.py::bicgstab; the rest of that
module (the ELL/CSR operators, their Jacobi and line preconditioners and
the batched CSR solves) is not ported yet.
"""

from __future__ import annotations

import torch


def bicgstab(matvec, b, precond=None, rtol=1.0e-12, atol=0.0,
             max_iter=10000):
    """matrix-free right-preconditioned BiCGSTAB solve of A x = b

    matvec, precond: callables on flat tensors like b (precond None: the
    identity); any linear operator works, the 3D transport stencils
    (ops/transport3d.py) in particular.  The iteration stops when
    |r| <= max(rtol |b|, atol), after max_iter steps, or at a breakdown
    (omega, r_hat . v or rho exactly 0), as the JAX package's does.  A
    plain loop on b's device: each iteration reads one flag to the host.
    Returns (x, converged (a 0-d bool tensor), iterations (an int)).
    """
    if precond is None:
        def precond(v):
            return v

    bnorm = torch.sqrt(b @ b)
    tol = torch.clamp(rtol * bnorm, min=atol)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r, r_hat = b, b
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and bool((torch.sqrt(r @ r) > tol) & ~broke):
        rho_new = r_hat @ r
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        p_hat = precond(p)
        v = matvec(p_hat)
        denom = r_hat @ v
        alpha = rho_new / denom
        s = r - alpha * v
        s_hat = precond(s)
        t = matvec(s_hat)
        tt = t @ t
        omega = torch.where(tt > 0, (t @ s) / torch.where(tt > 0, tt, one),
                            0.0)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        broke = (omega == 0.0) | (denom == 0.0) | (rho_new == 0.0)
        rho = rho_new
        k += 1
    return x, torch.sqrt(r @ r) <= tol, k
