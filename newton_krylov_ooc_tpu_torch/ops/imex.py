"""fixed-step IMEX (semi-implicit) year integrator for transport models.

Port of newton_krylov_ooc_tpu/ops/imex.py, in plain PyTorch.  Vertical
mixing and stiff local linear terms (surface restoring) are Crank-Nicolson
tridiagonal solves along depth; advection, lateral mixing and the remaining
sources advance explicitly (Heun); Strang splitting with merged interior
half-steps keeps the scheme second order.

float32 accuracy: every substep is computed in increment form (the CN solve
returns dv with (I - dt/2 M) dv = dt M v rather than the updated state), and
the state accumulates through Kahan compensation.  Without it tens of
thousands of tiny updates drown in the state's own rounding grid.

The JAX `lax.scan` over steps is a Python loop here and its `vmap` over
tracers a written-out leading batch axis.  This is the plain version of the
year kernel in csrc/iage_year.cu (ops/imex_cuda.py); on a card each step is
some hundred small launches, which is why the kernel exists.
"""

from __future__ import annotations

import torch

from .tridiag import pcr_solve


def cn_vertical_increment(kv, diag, dz_r, v, dt):
    """
    Crank-Nicolson increment for dv/dt = (Lz + D) v over dt:
    solve (I - dt/2 (Lz + D)) dv = dt (Lz + D) v; the update is v + dv

    kv: (nz-1, ny) diffusivity / delta_mid at interior edges, or (...,
        nz-1, ny) with leading axes that broadcast against v's
    diag: (..., nz, ny) local linear rates (e.g. surface restoring)
    v: (..., nz, ny); leading axes are batched
    """
    half = 0.5 * dt

    up = kv * dz_r[:-1, None]   # coupling to the layer below: a[k, k+1]
    lo = kv * dz_r[1:, None]    # coupling to the layer above: a[k, k-1]
    zero = kv.new_zeros(kv.shape[:-2] + (1, kv.shape[-1]))
    du = torch.cat([up, zero], dim=-2)
    dl = torch.cat([zero, lo], dim=-2)
    dmain = -(du + dl) + diag

    # rhs = dt * (Lz + D) v via the flux-form stencil
    flux = kv * (v[..., 1:, :] - v[..., :-1, :])
    zrow = v.new_zeros(v.shape[:-2] + (1, v.shape[-1]))
    m_v = dz_r[:, None] * (
        torch.cat([flux, zrow], dim=-2) - torch.cat([zrow, flux], dim=-2)
    ) + diag * v
    rhs = dt * m_v

    # solve along depth: move it to the last axis
    dl_b = (-half * dl).expand_as(dmain)
    du_b = (-half * du).expand_as(dmain)
    return pcr_solve(
        dl_b.transpose(-1, -2),
        (1.0 - half * dmain).transpose(-1, -2),
        du_b.transpose(-1, -2),
        rhs.transpose(-1, -2),
    ).transpose(-1, -2)


def _kahan_add(y, comp, delta):
    adj = delta + comp
    y_new = y + adj
    return y_new, adj - (y_new - y)


def imex_year(explicit_tend, vert_coeff, vert_diag, dz_r, y0, t_span, n_steps):
    """
    integrate a (..., nz, ny) state one period with Strang-split IMEX and
    Kahan-compensated accumulation

    explicit_tend(t, y) -> dy/dt from advection/lateral mixing/non-stiff sources
    vert_coeff(t) -> (nz-1, ny) vertical diffusivity / delta_mid
    vert_diag: stiff local linear rates folded into the implicit solve
        (zeros if none); broadcastable to y0's shape
    y0: (..., nz, ny); leading axes (modules, tracers) are batched
    """
    dtype, device = y0.dtype, y0.device
    t0 = torch.tensor(t_span[0], dtype=dtype, device=device)
    dt = torch.tensor((t_span[1] - t_span[0]) / n_steps, dtype=dtype, device=device)
    diag = torch.as_tensor(vert_diag, dtype=dtype, device=device).expand(y0.shape)

    def cn_incr(t, y, h):
        return cn_vertical_increment(vert_coeff(t), diag, dz_r, y, h)

    def heun(t, y, comp):
        # Heun (explicit trapezoid) for the non-stiff terms
        f1 = explicit_tend(t, y)
        f2 = explicit_tend(t + dt, y + dt * f1)
        return _kahan_add(y, comp, 0.5 * dt * (f1 + f2))

    # Strang splitting with combined interior half-steps: the trailing
    # CN(dt/2) of step k and the leading CN(dt/2) of step k+1 act at the
    # same time point with the same operator, so the interior pairs merge
    # into single full-dt solves:
    #   CNh(t0) H(t0) CNf(t1) H(t1) ... CNf(t_{n-1}) H(t_{n-1}) CNh(t_n)
    y, comp = _kahan_add(y0, torch.zeros_like(y0), cn_incr(t0, y0, 0.5 * dt))
    for ind in range(n_steps - 1):
        t = t0 + ind * dt
        y, comp = heun(t, y, comp)
        y, comp = _kahan_add(y, comp, cn_incr(t + dt, y, dt))
    t_last = t0 + (n_steps - 1) * dt
    y, comp = heun(t_last, y, comp)
    y, _comp = _kahan_add(y, comp, cn_incr(t_last + dt, y, 0.5 * dt))
    return y
