"""left-preconditioned GMRES with every vector and coefficient on the device.

Port of newton_krylov_ooc_tpu/ops/gmres.py.  The host-driven GMRES of
core/incore.py reads each Gram-Schmidt coefficient to the host and solves
the Hessenberg least squares with numpy, j + 2 blocking reads an Arnoldi
step.  Here the whole iteration stays on the kernel's device:

  * the Krylov basis is preallocated at max_dim + 1 vectors,
  * the least squares min ||beta e1 - H y|| is kept by Givens rotations per
    (tracer module, region): the upper-triangular factor r_mat, its
    rotation pairs cs/sn and the rotated right-hand side g, whose last
    element is the preconditioned residual norm,
  * modified Gram-Schmidt in the host path's order,
  * the final y by one triangular solve a (module, region), the
    increment as one contraction of the basis.

PyTorch has no device while-loop, so the loop runs on the host, but an
Arnoldi step reads nothing back except one stop flag:
any(active & |g[j]| >= rel_tol * beta).  Blocks whose initial residual is
exactly zero are inactive and never hold the loop open.

The least-squares solution is the host path's (QR by rotations of the same
Hessenberg), so the two agree to rounding; tests/test_torch_gmres.py pins
that, and the port against the JAX package's fused GMRES.

The JAX module's `gmres_interface`/`consts_aware` route (constants passed
as jit operands, for meshes spanning processes) has no counterpart: eager
PyTorch has no jit boundary, so the kernel's closure methods serve.
"""

from __future__ import annotations

import torch


def _nonzero(x):
    """guard exact zeros (converged or inactive blocks) against division"""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() > tiny, x, torch.ones_like(x))


def build_gmres(jvp_fn, precond_fn, dot_fn, broadcast_fn, max_dim, rel_tol,
                linearize_fn=None):
    """a GMRES solve over a kernel's linear algebra.

    jvp_fn(x, fcn, v) -> J v            (the model-year Jacobian action)
    linearize_fn: optional F itself (y -> F(y)); when given, the solve
        linearizes F at x once (torch.func.linearize) and the loop applies
        the tangent map, so a nonlinear model pays its primal year once a
        solve instead of once a Krylov step
    precond_fn(precond_data, r) -> M^-1 r
    dot_fn(a, b) -> (module, region) weighted dot products
    broadcast_fn(scalars (module, region)) -> a field broadcastable over
        the state, each region's cells carrying its scalar (the kernel's
        region_broadcast, taking a tensor on the state's device; the
        increment maps it over the Krylov coefficients with torch.vmap)
    max_dim: the maximum Krylov dimension (the preallocated basis)
    rel_tol: stop when the preconditioned residual norm < rel_tol * beta
        for every (module, region)

    Returns gmres(x, fcn, precond_data) -> (increment, iterations,
    resid_norm, beta): `iterations` the Arnoldi steps taken (an int),
    resid_norm and beta (module, region) tensors on the device.
    """
    max_dim = int(max_dim)

    def gmres(x, fcn, precond_data):
        def norm(v):
            return torch.sqrt(dot_fn(v, v))

        if linearize_fn is not None:
            _, apply_jac = torch.func.linearize(linearize_fn, x)
        else:
            def apply_jac(v):
                return jvp_fn(x, fcn, v)

        r0 = precond_fn(precond_data, fcn)
        beta = norm(r0)                                    # (M, R)
        mr_shape = beta.shape
        basis = r0.new_zeros((max_dim + 1,) + r0.shape)
        basis[0] = -r0 * broadcast_fn(1.0 / _nonzero(beta))
        # the Givens-rotated upper-triangular factor of the Hessenberg, its
        # rotation pairs and the rotated rhs g = Q^T (beta e1), all per
        # (module, region)
        r_mat = beta.new_zeros((max_dim, max_dim) + mr_shape)
        cs = beta.new_zeros((max_dim,) + mr_shape)
        sn = beta.new_zeros((max_dim,) + mr_shape)
        g_vec = beta.new_zeros((max_dim + 1,) + mr_shape)
        g_vec[0] = beta
        # a block with an exactly zero initial residual (a region with no
        # cells, a module already converged) must not hold the loop open at
        # 0 >= 0
        active = beta > 0
        threshold = rel_tol * beta

        j = 0
        while j < max_dim and bool(
                torch.any(active & (g_vec[j].abs() >= threshold))):
            w = precond_fn(precond_data, apply_jac(basis[j]))
            # modified Gram-Schmidt against columns 0..j
            h_col = beta.new_zeros((max_dim + 1,) + mr_shape)
            for i in range(j + 1):
                hij = dot_fn(w, basis[i])
                w = w - basis[i] * broadcast_fn(hij)
                h_col[i] = hij
            h_last = norm(w)
            h_col[j + 1] = h_last
            basis[j + 1] = w * broadcast_fn(1.0 / _nonzero(h_last))

            # the accumulated rotations on the new column, then the new one
            # eliminating h[j+1, j]
            for i in range(j):
                top = cs[i] * h_col[i] + sn[i] * h_col[i + 1]
                bot = -sn[i] * h_col[i] + cs[i] * h_col[i + 1]
                h_col[i], h_col[i + 1] = top, bot
            denom = _nonzero(torch.sqrt(h_col[j] ** 2 + h_col[j + 1] ** 2))
            c_new = h_col[j] / denom
            s_new = h_col[j + 1] / denom
            h_col[j] = c_new * h_col[j] + s_new * h_col[j + 1]
            h_col[j + 1] = 0.0
            r_mat[:, j] = h_col[:max_dim]
            cs[j], sn[j] = c_new, s_new
            g_j = g_vec[j].clone()
            g_vec[j] = c_new * g_j
            g_vec[j + 1] = -s_new * g_j
            j += 1

        if j == 0:
            return torch.zeros_like(r0), 0, g_vec[0].abs(), beta
        # R[:j, :j] y = g[:j], one triangular solve a (module, region); a
        # zero pivot (an inactive block, a breakdown) divides by 1
        r_blocks = r_mat[:j, :j].movedim((0, 1), (-2, -1))
        pivots = torch.diagonal(r_blocks, dim1=-2, dim2=-1)
        r_blocks = r_blocks + torch.diag_embed(_nonzero(pivots) - pivots)
        y = torch.linalg.solve_triangular(
            r_blocks, g_vec[:j].movedim(0, -1).unsqueeze(-1), upper=True)
        y = y.squeeze(-1).movedim(-1, 0)                   # (j, M, R)
        # increment = sum_k y_k basis_k, per-(module, region) coefficients
        coeff = torch.vmap(broadcast_fn)(y)
        coeff = coeff.reshape((j,) + (1,) * (r0.ndim + 1 - coeff.ndim)
                              + coeff.shape[1:])
        increment = torch.sum(basis[:j] * coeff, dim=0)
        return increment, j, g_vec[j].abs(), beta

    return gmres


__all__ = ["build_gmres"]
