"""device-resident test_problem kernels: the 1D column family batched.

Port of newton_krylov_ooc_tpu/models/test_problem/incore.py.  The
test_problem model is a single depth column; its parameterized
dye_decay_{suff} family (and iage) batch over a leading module axis and
integrate through the plain IMEX year of ops/imex.py with a one-column
ypos dimension, as the JAX kernels do through theirs: vertical mixing and
the stiff surface terms (iage piston restoring) implicit, the pulsed dye
inflow and first-order decay explicit.  A whole family spins up in one
batched Newton-Krylov solve: every solver scalar carries the module axis,
and the preconditioner -- implicit Euler of the full 1D Jacobian,
tridiagonal per module, solved by ops/tridiag.py::pcr_solve along depth --
is close to exact, so GMRES converges in a couple of iterations.

No CUDA kernel is involved: the JAX kernels run no Pallas kernel either.
On a card every step is a few small launches of plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.compute import resolve_device
from ...ops.imex import imex_year
from ...ops.tridiag import pcr_solve
from . import constants, physics


class DyeDecayFamilyKernel:
    """in-core kernel: a batch of dye_decay_{suff} modules (one tracer each)

    decay_rates_per_year: the family's parameter vector (module axis);
    state layout (module, nlev) tensor on `device`.
    """

    n_tracers = 1

    def __init__(self, depth, decay_rates_per_year, *, device,
                 dtype=torch.float64, n_steps=2920):
        self.device = resolve_device(device)
        self.depth = depth
        self.dtype = dtype
        self.n_steps = n_steps
        self.nlev = len(depth)
        self.grid = physics.column_grid(depth, device=self.device,
                                        dtype=dtype)
        self.rates = np.asarray(decay_rates_per_year, np.float64)
        self.module_cnt = len(self.rates)
        self.year = constants.sec_per_year

        self._weight = self._tensor(depth.delta)
        self._weight_sum = float(np.sum(depth.delta))
        self._decay = self._tensor(
            self.rates[:, None, None] * constants.year_per_sec)
        # the implicit diagonal: none for the dye family
        self._diag = self._tensor(np.zeros((self.module_cnt, self.nlev, 1)))

        def tend(t, y):
            # the pulsed surface inflow and first-order decay; y (M, nlev, 1)
            inflow = torch.zeros_like(y)
            inflow[:, 0, :] = (physics.dye_decay_surf_flux(t)
                               * self.grid.delta_r[0])
            return inflow - self._decay * y

        def tend0(t, y):
            return -self._decay * y

        self._set_years(tend, tend0)

    def _tensor(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                               device=self.device)

    def _set_years(self, tend, tend0):
        """the year with sources (F) and without (the linear family's exact
        tangent map)"""
        grid, span = self.grid, (0.0, self.year)

        def vert_coeff(t):
            return physics.mixing_coeff(grid, t)[:, None]  # (nlev-1, 1)

        def year_of(explicit_tend):
            def year(y):
                return imex_year(explicit_tend, vert_coeff, self._diag,
                                 grid.delta_r, y[..., None], span,
                                 self.n_steps)[..., 0]
            return year

        self._year_fn = year_of(tend)
        self._year0_fn = year_of(tend0)

    # -- solver interface ----------------------------------------------------

    def init_iterate(self):
        return torch.zeros((self.module_cnt, self.nlev), dtype=self.dtype,
                           device=self.device)

    def comp_fcn(self, x):
        return self._year_fn(x) - x

    def jvp(self, x, fcn, v):
        """exact: the family is linear, so J v = year0(v) - v"""
        return self._year0_fn(v) - v

    def dot(self, a, b):
        return (torch.sum(a * b * self._weight, dim=1)
                / self._weight_sum)[:, None]

    def norm(self, v):
        return torch.sqrt(self.dot(v, v))

    @staticmethod
    def add(a, b):
        return a + b

    def scale(self, v, factor):
        """scale by a scalar or by per-(module, region) factors"""
        if isinstance(factor, torch.Tensor):
            factor = factor.detach().cpu().numpy()
        factor = np.asarray(factor)
        if factor.ndim == 0:
            return v * float(factor)
        return v * self._tensor(factor)[:, 0, None]

    def region_broadcast(self, scalars):
        """(module, region=1) -> a (module, 1) field"""
        return torch.as_tensor(scalars, dtype=self.dtype, device=self.device)

    def apply_limiter(self, x, increment):
        return np.ones((self.module_cnt, 1))

    def lin_comb(self, basis, coeff):
        res = self.scale(basis[0], coeff[0])
        for j in range(1, len(basis)):
            res = res + self.scale(basis[j], coeff[j])
        return res

    def precond_setup(self, x):
        return None

    def precond_apply(self, data, r):
        """implicit Euler over a year of the full 1D Jacobian (mixing at
        mid-year and the module's linear rates), solved along depth"""
        kv = physics.mixing_coeff(self.grid, torch.as_tensor(
            0.5 * self.year, dtype=self.dtype, device=self.device))
        dr = self.grid.delta_r
        zero = kv.new_zeros(1)
        du = torch.cat([kv * dr[:-1], zero])
        dl = torch.cat([zero, kv * dr[1:]])
        dmain = -(du + dl)[None, :] + self._linear_rates()   # (M, nlev)
        dt_pc = self.year
        return pcr_solve((-dt_pc * dl).expand(r.shape), 1.0 - dt_pc * dmain,
                         (-dt_pc * du).expand(r.shape), r) - r

    def _linear_rates(self):
        """(M, nlev) local linear rates of the preconditioner's Jacobian"""
        return -self._decay[:, :, 0]


class IageColumnKernel(DyeDecayFamilyKernel):
    """in-core kernel: test_problem iage (one module, one tracer).

    The stiff surface piston-velocity restoring (a 700 s timescale at
    meter-scale surface layers) folds into the implicit diagonal; the
    +1 yr/yr aging source is explicit.
    """

    def __init__(self, depth, *, device, dtype=torch.float64, n_steps=2920):
        super().__init__(depth, np.zeros(1), device=device, dtype=dtype,
                         n_steps=n_steps)
        diag = np.zeros((1, self.nlev, 1))
        diag[0, 0, 0] = -physics.IAGE_PIST_VEL * float(
            np.asarray(depth.delta_r)[0])
        self._diag = self._tensor(diag)

        def tend(t, y):
            return torch.full_like(y, constants.year_per_sec)

        def tend0(t, y):
            return torch.zeros_like(y)

        self._set_years(tend, tend0)

    def _linear_rates(self):
        return self._diag[:, :, 0]


__all__ = ["DyeDecayFamilyKernel", "IageColumnKernel"]
