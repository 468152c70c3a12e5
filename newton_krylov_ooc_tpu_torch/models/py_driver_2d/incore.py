"""device-resident py_driver_2d iage kernel for the in-core solver.

Port of newton_krylov_ooc_tpu/models/py_driver_2d/incore.py::IageKernel.
Both tracers integrate through one model year per F evaluation; the model is
linear, so the exact Jacobian-vector product is the year with the aging
source zeroed, J v = year_src0(v) - v, on every path.  The preconditioner is
a dense LU of the implicit-Euler-product operator in full float32 or
float64 (TF32 is off: ops/compute.py).  Reductions contract against the
dense region-mean matrix.

Year dispatch, by device and dtype: a float32 state on a CUDA device runs
the hand-written kernel (ops/imex_cuda.py::build_iage_year); every other
combination -- the CPU, or float64 on either device -- runs the plain
ops/imex.py::imex_year.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from newton_krylov_ooc_tpu.utils.regions import region_mean_weights

from ...ops.compute import resolve_device
from ...ops.imex_cuda import build_iage_year, build_iage_year_plain
from . import physics
from .iage import SURF_SLOW_FACTOR, surf_restore_rate


def _warn_if_explicit_unstable(grid, n_steps):
    """the Heun (explicit lateral) half diverges silently past its
    stability bound -- at fine ypos spacing the diffusion limit
    dt <= dy^2/(2K) binds first (physics.explicit_dt_bound); warn loudly
    rather than return NaNs"""
    dt = physics.SEC_PER_YEAR / n_steps
    bound = physics.explicit_dt_bound(grid)
    if dt > bound:
        logging.getLogger(__name__).warning(
            "dt=%.0f s exceeds the explicit lateral stability bound %.0f s "
            "for this grid (dy^2/(2K) or dy/v); the year integration WILL "
            "diverge -- raise n_steps to at least %d",
            dt,
            bound,
            int(np.ceil(physics.SEC_PER_YEAR / bound)),
        )


class IageKernel:
    """in-core kernel: py_driver_2d iage (2 tracers), IMEX year integration

    state layout: (2, nz, ny) tensor on `device`

    grid: an optional physics.Grid2D (models/py_driver_2d/convert.py builds
    one from the JAX package's grid); by default the grid is made from the
    axes and modelinfo
    """

    def __init__(self, depth, ypos, modelinfo, *, device, dtype=torch.float32,
                 n_steps=8760, region_mask=None, grid_weight=None, grid=None):
        self.device = resolve_device(device)
        self.depth = depth
        self.ypos = ypos
        self.dtype = dtype
        self.n_steps = n_steps
        if grid is None:
            grid = physics.make_grid(depth, ypos, modelinfo,
                                     device=self.device, dtype=dtype)
        self.grid = grid
        self.nz, self.ny = len(depth), len(ypos)
        _warn_if_explicit_unstable(grid, n_steps)
        self.rate = surf_restore_rate(depth)
        self.year = physics.SEC_PER_YEAR

        if region_mask is None:
            region_mask = np.ones((self.nz, self.ny), dtype=np.int32)
        if grid_weight is None:
            grid_weight = np.outer(depth.delta, ypos.delta)
        self.region_cnt = int(region_mask.max())
        self.mean_mat = self._tensor(region_mean_weights(region_mask, grid_weight))
        # region membership (region, ncell) and the cells outside every region
        self._region_mask = (self.mean_mat > 0).to(dtype)
        self._region_fill = 1.0 - self._region_mask.sum(dim=0).reshape(
            self.nz, self.ny
        )

        diag = np.zeros((2, self.nz, self.ny))
        diag[0, 0, :] = -self.rate
        diag[1, 0, :] = -SURF_SLOW_FACTOR * self.rate
        self._vert_diag = diag

        span = (0.0, self.year)
        source = np.full((2, 1, 1), 1.0 / self.year)
        source0 = np.zeros((2, 1, 1))
        self.use_kernel = self.device.type == "cuda" and dtype == torch.float32
        if self.use_kernel:
            self._year_fn = build_iage_year(
                grid, diag, source, span, n_steps, device=self.device
            )
            self._year0_fn = build_iage_year(
                grid, diag, source0, span, n_steps, device=self.device
            )
        else:
            self._year_fn = build_iage_year_plain(grid, diag, source, span, n_steps)
            self._year0_fn = build_iage_year_plain(
                grid, diag, source0, span, n_steps
            )

        # time-invariant lateral part of the preconditioner's Jacobians,
        # assembled once (physics.transport_jac would rebuild it per call)
        self._lateral_jac = physics.lateral_jac_const(grid)

    def _tensor(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -- solver interface --------------------------------------------------------

    def comp_fcn(self, x):
        return self._year_fn(x) - x

    def jvp(self, x, fcn, v):
        """exact Jacobian-vector product of F at x: the model is linear, so
        it is the source-free year of v, minus v"""
        return self._year0_fn(v) - v

    def dot(self, a, b):
        """region-weighted means of a*b summed over tracers -> (1, region)"""
        prod = (a * b).sum(dim=0).reshape(-1)
        return (self.mean_mat @ prod)[None, :]

    def norm(self, v):
        return torch.sqrt(self.dot(v, v))

    @staticmethod
    def add(a, b):
        return a + b

    def scale(self, v, factor):
        """scale by a scalar or per-(module, region) factors"""
        if isinstance(factor, torch.Tensor):
            factor = factor.detach().cpu().numpy()
        factor = np.asarray(factor)
        if factor.ndim == 0:
            return v * float(factor)
        return v * self.region_broadcast(factor)

    def region_broadcast(self, scalars):
        """(module=1, region) scalars -> (nz, ny) field, 1 outside every
        region"""
        region_vals = self._tensor(np.asarray(scalars)[0])
        field = (region_vals @ self._region_mask).reshape(self.nz, self.ny)
        return field + self._region_fill

    def apply_limiter(self, x, increment):
        """iage has no bounds; factors are 1"""
        return np.ones((1, self.region_cnt))

    def lin_comb(self, basis, coeff):
        res = self.scale(basis[0], coeff[0])
        for j in range(1, len(basis)):
            res = res + self.scale(basis[j], coeff[j])
        return res

    # -- preconditioner -----------------------------------------------------------

    def precond_setup(self, x):
        """LU-factor the implicit-Euler-product approximation of dF/dx:
        per tracer, I - prod_i (I - dt J(t_i)) over three steps of a year"""
        n = self.nz * self.ny
        time_n = 3
        dt = self.year / time_n
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        surf = torch.arange(self.ny, device=self.device)

        factors = []
        for rate in (self.rate, SURF_SLOW_FACTOR * self.rate):
            mat = eye
            for i in range(time_n):
                t_mid = (i + 0.5) * dt
                kv = physics.vert_mixing_coeff(self.grid, t_mid)
                jt = self._lateral_jac + physics.vertical_jac(self.grid, kv)
                jt[surf, surf] -= rate
                mat = mat @ (eye - dt * jt)
            factors.append(torch.linalg.lu_factor(eye - mat))
        return factors

    def precond_apply(self, data, r):
        n = self.nz * self.ny
        sols = [
            torch.linalg.lu_solve(lu, piv, r[ind].reshape(n, 1))
            for ind, (lu, piv) in enumerate(data)
        ]
        return torch.stack([s.reshape(self.nz, self.ny) for s in sols]) - r

    # -- conveniences -------------------------------------------------------------

    def init_iterate(self):
        """column-interpolated initial iterate matching gen_init_iterate"""
        column = np.interp(self.depth.mid, [55.0, 200.0], [0.0, 2.0])
        field = np.broadcast_to(column[:, None], (self.nz, self.ny))
        return self._tensor(np.stack([field, field]))
