"""in-core device-resident Newton-Krylov solver.

Port of newton_krylov_ooc_tpu/core/incore.py::NewtonKrylovInCore, the
host-driven path: every vector lives on the kernel's device, and the
Newton, Armijo and GMRES loops run on the host, so the only device-host
traffic is the per-(module, region) convergence scalars.

  * comp_fcn: one model year per evaluation (the kernel's year),
  * Jacobian-vector products: exact (the kernel's jvp),
  * GMRES: left-preconditioned, modified Gram-Schmidt, per-(module, region)
    Hessenberg least squares on the host,
  * Armijo backtracking per (module, region),
  * npz checkpoints (`incore_state.npz`, keys `x` and `iteration`) in the
    JAX package's format, so a JAX in-core checkpoint resumes here.

The fused variants of the JAX solver keep the solver's state on the
device too: jit_gmres (ops/gmres.py) runs the Krylov iteration with its
coefficients and Givens least squares on the device, reading one stop flag
an Arnoldi step; jit_newton (ops/newton_jit.py) does the same for the
Newton loop, the limiter and the Armijo backtracking.  The orbax checkpoint
backend is not ported and raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch


def _host(t):
    """device tensor -> float64 numpy array (the convergence scalars)"""
    return t.detach().to("cpu", torch.float64).numpy()


class NewtonKrylovInCore:
    """Armijo-globalized Newton with on-device left-preconditioned GMRES"""

    def __init__(
        self,
        kernel,
        newton_rel_tol=1e-5,
        krylov_rel_tol=1e-2,
        newton_max_iter=5,
        newton_min_iter=0,
        krylov_max_dim=40,
        post_newton_fp_iter=1,
        armijo_alpha=1e-4,
        armijo_max_ind=10,
        jit_gmres=False,
        jit_newton=False,
    ):
        self.kernel = kernel
        self.newton_rel_tol = newton_rel_tol
        self.krylov_rel_tol = krylov_rel_tol
        self.newton_max_iter = newton_max_iter
        self.newton_min_iter = newton_min_iter
        self.krylov_max_dim = krylov_max_dim
        self.post_newton_fp_iter = post_newton_fp_iter
        self.armijo_alpha = armijo_alpha
        self.armijo_max_ind = armijo_max_ind
        self.stats = []
        # jit_gmres: the Krylov iteration with its basis, coefficients and
        # least squares on the device (ops/gmres.py); the same
        # per-(module, region) least squares as the host loop, so the
        # iterates agree to rounding.  Needs kernel.region_broadcast to take
        # a device tensor.
        self._jit_gmres = None
        if jit_gmres:
            from ..ops.gmres import build_gmres

            self._jit_gmres = build_gmres(
                kernel.jvp, kernel.precond_apply, kernel.dot,
                kernel.region_broadcast, krylov_max_dim, krylov_rel_tol,
                linearize_fn=getattr(kernel, "linearize_target", None))
        # jit_newton: the whole solve -- Newton loop, limiter, Armijo
        # backtracking, fixed-point updates and the inner GMRES -- with its
        # state on the device (ops/newton_jit.py).  A bounded kernel's
        # limiter needs its traced twin (limiter_scalef_jit); without one the
        # limiter is a no-op, as the linear kernels' apply_limiter is.
        self._jit_solve = None
        if jit_newton:
            from ..ops.newton_jit import build_newton_krylov

            self._jit_solve = build_newton_krylov(
                kernel,
                newton_rel_tol=newton_rel_tol,
                krylov_rel_tol=krylov_rel_tol,
                newton_max_iter=newton_max_iter,
                newton_min_iter=newton_min_iter,
                krylov_max_dim=krylov_max_dim,
                post_newton_fp_iter=post_newton_fp_iter,
                armijo_alpha=armijo_alpha,
                armijo_max_ind=armijo_max_ind,
            )

    def solve(self, x0, checkpoint_dir=None, checkpoint_backend="npz"):
        """run Newton to convergence; returns (x, fcn, info)

        checkpoint_dir: snapshot the solver state (iterate + iteration) after
        every Newton step and resume from the latest snapshot on restart
        """
        if self._jit_solve is not None:
            if checkpoint_dir is not None:
                raise ValueError(
                    "jit_newton keeps the whole solve's state on the device; "
                    "per-step checkpointing needs the host-driven path"
                )
            return self._solve_fused(x0)
        if checkpoint_backend == "orbax":
            raise NotImplementedError(
                "checkpoint_backend='orbax' (sharded async checkpoints, "
                "core/checkpoint.py) is ROADMAP item A5.5, not ported yet; "
                "use 'npz'"
            )
        if checkpoint_backend != "npz":
            raise ValueError(f"unknown checkpoint_backend={checkpoint_backend}")
        return self._solve_host(x0, checkpoint_dir)

    def _solve_host(self, x0, checkpoint_dir):
        logger = logging.getLogger(__name__)
        kernel = self.kernel
        x = x0
        iteration = 0
        krylov_iterations = []
        if checkpoint_dir is not None:
            loaded = self._load_checkpoint(checkpoint_dir, x0)
            if loaded is not None:
                x, iteration = loaded
                logger.info("resumed from checkpoint at iteration %d", iteration)
        fcn = kernel.comp_fcn(x)
        while True:
            fcn_norm = _host(kernel.norm(fcn))
            x_norm = _host(kernel.norm(x))
            converged = (iteration >= self.newton_min_iter) & (
                fcn_norm < self.newton_rel_tol * x_norm
            )
            self.stats.append(
                {
                    "iteration": iteration,
                    "fcn_norm": fcn_norm.copy(),
                    "x_norm": x_norm.copy(),
                }
            )
            logger.info(
                "newton iteration=%d max rel resid=%e",
                iteration,
                float((fcn_norm / np.maximum(x_norm, 1e-300)).max()),
            )
            if converged.all():
                break
            if iteration >= self.newton_max_iter:
                raise RuntimeError("number of maximum Newton iterations exceeded")

            increment, krylov_its = self._gmres(x, fcn)
            krylov_iterations.append(krylov_its)
            scalef = kernel.apply_limiter(x, increment)
            increment = kernel.scale(increment, scalef)
            x, fcn = self._armijo(x, fcn, increment, converged)

            # post-Newton fixed-point iterations (fixed-point problems)
            for _ in range(self.post_newton_fp_iter):
                x = kernel.add(x, fcn)
                fcn = kernel.comp_fcn(x)
            iteration += 1
            if checkpoint_dir is not None:
                self._save_checkpoint(checkpoint_dir, x, iteration)

        info = {
            "iterations": iteration,
            "fcn_norm": fcn_norm,
            "x_norm": x_norm,
            "stats": self.stats,
            "krylov_iterations": np.asarray(krylov_iterations, dtype=int),
        }
        return x, fcn, info

    def _solve_fused(self, x0):
        """the solve of ops/newton_jit.py; the host unpacks the stats and
        raises the host path's errors"""
        logger = logging.getLogger(__name__)
        x, fcn, dev_info = self._jit_solve(x0)
        iterations = int(dev_info["iterations"])
        fn_hist = _host(dev_info["fcn_norm_hist"])
        xn_hist = _host(dev_info["x_norm_hist"])
        armijo_ok = dev_info["armijo_ok"].numpy()[:iterations]
        # on an Armijo failure at step k the host path records iterates
        # 0..k and fails; the stats stop there too
        armijo_failed = not armijo_ok.all()
        n_good = int(np.argmax(~armijo_ok)) if armijo_failed else iterations
        for it in range(n_good + 1):
            self.stats.append(
                {
                    "iteration": it,
                    "fcn_norm": fn_hist[it].copy(),
                    "x_norm": xn_hist[it].copy(),
                }
            )
            logger.info(
                "newton iteration=%d max rel resid=%e",
                it,
                float((fn_hist[it] / np.maximum(xn_hist[it], 1e-300)).max()),
            )
        if armijo_failed:
            raise RuntimeError("Armijo_ind exceeds limit")
        if not dev_info["converged"].all():
            raise RuntimeError("number of maximum Newton iterations exceeded")
        info = {
            "iterations": iterations,
            "fcn_norm": fn_hist[iterations],
            "x_norm": xn_hist[iterations],
            "stats": self.stats,
            "krylov_iterations": dev_info["krylov_iterations"].numpy()[
                :iterations].astype(int),
            "armijo_factor": _host(dev_info["armijo_factor"])[:iterations],
            "limiter_scalef": _host(dev_info["limiter_scalef"])[:iterations],
        }
        return x, fcn, info

    @staticmethod
    def _save_checkpoint(checkpoint_dir, x, iteration):
        """atomic snapshot of the solver state"""
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "incore_state.npz")
        tmp = path + ".tmp.npz"  # .npz suffix keeps np.savez from renaming
        np.savez(tmp, x=x.detach().cpu().numpy(), iteration=iteration)
        os.replace(tmp, path)

    @staticmethod
    def _load_checkpoint(checkpoint_dir, like):
        """(x on like's device and dtype, iteration), or None"""
        path = os.path.join(checkpoint_dir, "incore_state.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            x = torch.as_tensor(data["x"], dtype=like.dtype, device=like.device)
            return x, int(data["iteration"])

    def _armijo(self, x, fcn, increment, converged):
        """Armijo backtracking per (module, region)"""
        kernel = self.kernel
        fcn_norm = _host(kernel.norm(fcn))
        factor = np.where(converged, 0.0, 1.0)
        for _ in range(self.armijo_max_ind + 1):
            prov = kernel.add(x, kernel.scale(increment, factor))
            prov_fcn = kernel.comp_fcn(prov)
            prov_norm = _host(kernel.norm(prov_fcn))
            cond = (factor == 0.0) | (
                prov_norm <= (1.0 - self.armijo_alpha * factor) * fcn_norm
            )
            if cond.all():
                return prov, prov_fcn
            factor = np.where(cond, factor, 0.5 * factor)
        raise RuntimeError("Armijo_ind exceeds limit")

    def _gmres(self, x, fcn):
        """left-preconditioned GMRES (on-device basis, Saad alg. 9.4);
        returns (increment, Krylov iterations)"""
        kernel = self.kernel
        precond_data = kernel.precond_setup(x)
        if self._jit_gmres is not None:
            increment, its, _resid, _beta = self._jit_gmres(
                x, fcn, precond_data
            )
            return increment, its

        r0 = kernel.precond_apply(precond_data, fcn)
        beta = _host(kernel.norm(r0))
        basis = [kernel.scale(r0, -1.0 / beta)]
        h_cols = []  # per column: (j+2, module, region) coefficients

        for j in range(self.krylov_max_dim):
            w = kernel.jvp(x, fcn, basis[j])
            w = kernel.precond_apply(precond_data, w)
            # modified Gram-Schmidt
            h_col = []
            for i in range(j + 1):
                hij = _host(kernel.dot(w, basis[i]))
                w = kernel.add(w, kernel.scale(basis[i], -hij))
                h_col.append(hij)
            h_last = _host(kernel.norm(w))
            h_col.append(h_last)
            h_cols.append(np.stack(h_col))  # (j+2, module, region)
            w = kernel.scale(w, 1.0 / h_last)

            coeff = _hessenberg_lstsq(beta, h_cols)
            # the Arnoldi relation gives the preconditioned residual norm
            # from H alone
            resid_norm = _hessenberg_resid_norm(beta, h_cols, coeff)
            if (resid_norm < self.krylov_rel_tol * beta).all():
                break
            basis.append(w)

        # basis may hold one more vector than coefficient rows when the
        # dimension cap was hit without convergence
        res = kernel.lin_comb(basis[: len(coeff)], coeff)
        return res, j + 1


def _hessenberg_lstsq(beta, h_cols):
    """per-(module, region) least squares min ||beta e1 - H y||"""
    ncols = len(h_cols)
    nrows = ncols + 1
    module_cnt, region_cnt = beta.shape
    coeff = np.zeros((ncols, module_cnt, region_cnt))
    for m in range(module_cnt):
        for r in range(region_cnt):
            h_mat = np.zeros((nrows, ncols))
            for jcol, col in enumerate(h_cols):
                h_mat[: jcol + 2, jcol] = col[:, m, r]
            rhs = np.zeros(nrows)
            rhs[0] = beta[m, r]
            coeff[:, m, r] = np.linalg.lstsq(h_mat, rhs, rcond=None)[0]
    return coeff


def _hessenberg_resid_norm(beta, h_cols, coeff):
    """norm of beta e1 - H y per (module, region)"""
    ncols = len(h_cols)
    nrows = ncols + 1
    module_cnt, region_cnt = beta.shape
    out = np.zeros((module_cnt, region_cnt))
    for m in range(module_cnt):
        for r in range(region_cnt):
            h_mat = np.zeros((nrows, ncols))
            for jcol, col in enumerate(h_cols):
                h_mat[: jcol + 2, jcol] = col[:, m, r]
            rhs = np.zeros(nrows)
            rhs[0] = beta[m, r]
            out[m, r] = np.linalg.norm(rhs - h_mat @ coeff[:, m, r])
    return out
