"""Newton-Krylov with every vector and solver scalar on the device.

Port of newton_krylov_ooc_tpu/ops/newton_jit.py.  core/incore.py's
host-driven solve reads the norms, the Armijo tests and the limiter's
factors to the host at every step; here the outer loop keeps them on the
kernel's device, as the JAX module's one traced program does:

  * the convergence test `(it >= min_iter) & (||F|| < rtol ||x||)` per
    (tracer module, region), as masked device tensors,
  * the left-preconditioned GMRES of ops/gmres.py, with the kernel's
    traced limiter (`limiter_scalef_jit`, a no-op where the kernel has
    none) applied to the increment,
  * Armijo backtracking with per-(module, region) halving factors,
    alpha = 1e-4, at most `armijo_max_ind + 1` trials; converged blocks
    carry factor 0 and never move,
  * `post_newton_fp_iter` fixed-point updates after each Newton step,
  * the histories the JAX module returns.

PyTorch has no device while-loop, so the loops run on the host, each
reading one flag a pass (all converged; all Armijo trials accepted; the
GMRES stop test) and nothing else.  The JAX program cannot raise, so it
runs on after an Armijo failure; this one stops at the failing step.
NewtonKrylovInCore(jit_newton=True) turns either's flags into the host
path's errors, with stats through the last iterate the host path reaches,
so the returned info, the stats and the error are the same.
"""

from __future__ import annotations

import torch

from .gmres import build_gmres


def build_newton_krylov(
    kernel,
    newton_rel_tol=1e-5,
    krylov_rel_tol=1e-2,
    newton_max_iter=5,
    newton_min_iter=0,
    krylov_max_dim=40,
    post_newton_fp_iter=1,
    armijo_alpha=1e-4,
    armijo_max_ind=10,
):
    """a Newton-Krylov solve over an in-core kernel whose solver state
    stays on its device.

    The kernel provides what NewtonKrylovInCore drives (comp_fcn,
    jvp/linearize_target, precond_setup/apply, dot, norm,
    region_broadcast taking a device tensor) and, for a bounded model, the
    traced limiter limiter_scalef_jit(x, increment) -> (module, region)
    factors on the device.

    Returns solve(x0) -> (x, fcn, info) with info's tensors on the device:
    `iterations` (an int), `fcn_norm_hist`/`x_norm_hist`
    ((max_iter+1, module, region), filled through `iterations`),
    `krylov_iterations`/`armijo_factor`/`limiter_scalef` per Newton step,
    `armijo_ok` (per-step success flags) and `converged` (final
    per-block flags).
    """
    newton_max_iter = int(newton_max_iter)
    gmres = build_gmres(kernel.jvp, kernel.precond_apply, kernel.dot,
                        kernel.region_broadcast, krylov_max_dim,
                        krylov_rel_tol,
                        linearize_fn=getattr(kernel, "linearize_target", None))
    limiter_fn = getattr(kernel, "limiter_scalef_jit", None)

    def conv_flags(it, fcn_norm, x_norm):
        flags = fcn_norm < newton_rel_tol * x_norm
        return flags if it >= newton_min_iter else torch.zeros_like(flags)

    def armijo(x, fcn, increment, fcn_norm, converged):
        """bounded per-(module, region) backtracking; converged blocks are
        pinned at factor 0"""
        factor = torch.where(converged, 0.0, 1.0).to(fcn_norm.dtype)
        for _ in range(armijo_max_ind + 1):
            prov = x + increment * kernel.region_broadcast(factor)
            prov_fcn = kernel.comp_fcn(prov)
            prov_norm = kernel.norm(prov_fcn)
            ok = (factor == 0.0) | (
                prov_norm <= (1.0 - armijo_alpha * factor) * fcn_norm
            )
            all_ok = bool(ok.all())
            if all_ok:
                break
            factor = torch.where(ok, factor, 0.5 * factor)
        # on failure `factor` was halved where the last trial failed; report
        # the factor the returned state was computed with
        accepted = factor if all_ok else torch.where(ok, factor, 2.0 * factor)
        return prov, prov_fcn, accepted, all_ok

    def solve(x0):
        fcn = kernel.comp_fcn(x0)
        fn0 = kernel.norm(fcn)
        mr_shape, sdtype = fn0.shape, fn0.dtype
        fn_hist = fn0.new_zeros((newton_max_iter + 1,) + mr_shape)
        xn_hist = torch.zeros_like(fn_hist)
        fn_hist[0], xn_hist[0] = fn0, kernel.norm(x0)
        n_rec = max(newton_max_iter, 1)
        kry_hist = [0] * n_rec
        fac_hist = fn0.new_zeros((n_rec,) + mr_shape)
        scalef_hist = torch.zeros_like(fac_hist)
        armijo_ok = [True] * n_rec

        x, it = x0, 0
        while it < newton_max_iter:
            converged = conv_flags(it, fn_hist[it], xn_hist[it])
            if bool(converged.all()):
                break
            precond_data = kernel.precond_setup(x)
            increment, krylov_its, _resid, _beta = gmres(x, fcn, precond_data)
            if limiter_fn is None:
                scalef = torch.ones_like(fn0)
            else:
                scalef = limiter_fn(x, increment).to(sdtype)
            increment = increment * kernel.region_broadcast(scalef)
            x, fcn, factor, ok = armijo(x, fcn, increment, fn_hist[it],
                                        converged)
            for _ in range(post_newton_fp_iter):
                x = x + fcn
                fcn = kernel.comp_fcn(x)
            fn_hist[it + 1] = kernel.norm(fcn)
            xn_hist[it + 1] = kernel.norm(x)
            kry_hist[it], armijo_ok[it] = krylov_its, ok
            fac_hist[it], scalef_hist[it] = factor, scalef
            it += 1
            if not ok:
                break
        info = {
            "iterations": it,
            "fcn_norm_hist": fn_hist,
            "x_norm_hist": xn_hist,
            "krylov_iterations": torch.as_tensor(kry_hist),
            "armijo_factor": fac_hist,
            "limiter_scalef": scalef_hist,
            "armijo_ok": torch.as_tensor(armijo_ok),
            "converged": conv_flags(it, fn_hist[it], xn_hist[it]),
        }
        return x, fcn, info

    return solve


__all__ = ["build_newton_krylov"]
