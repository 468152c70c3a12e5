"""device-resident py_driver_2d kernels for the in-core solver.

Port of newton_krylov_ooc_tpu/models/py_driver_2d/incore.py::IageKernel and
::PhosphorusKernel.  Every F evaluation is one model year of all tracers.
Preconditioners are dense LUs in full float32 or float64 (TF32 is off:
ops/compute.py).  Reductions contract against the dense region-mean matrix;
_InCoreKernel holds that region plumbing and the solver hooks both share.

IageKernel: the model is linear, so the exact Jacobian-vector product is
the year with the aging source zeroed, J v = year_src0(v) - v, on every
path.  The preconditioner is the implicit-Euler-product operator.  Its
dense year operator (build_year_operator, ops/year_operator.py) is probed
through the same year: on the kernel, B1 on the F and JVP years' table.

PhosphorusKernel: nonlinear (Michaelis-Menten uptake), so its JVP is
forward-mode AD (torch.func.jvp) through the plain year, on every device --
the port of the JAX kernel's jax.jvp through its XLA scan year, which the
JAX package also keeps off its Pallas kernel.  It is not the CUDA kernel's
plain version standing in for the kernel: no hand-written tangent year
exists.  The preconditioner is an LU of dt*J, the coupled 3-tracer
Jacobian at mid-year times one year, bordered by a rank-one term that
removes its total-phosphorus null space.

Year dispatch, by device and dtype, for F: a float32 state on a CUDA device
runs the hand-written kernel (ops/imex_cuda.py::build_iage_year,
::build_phosphorus_year); every other combination -- the CPU, or float64 on
either device -- runs the plain ops/imex.py::imex_year.  IageKernel's F and
JVP years on the kernel share one table of the year's CN solves
(ops/imex_cuda.py::build_iage_table); PhosphorusKernel's F year runs on its
own, built once (build_phosphorus_table).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...ops.compute import resolve_device
from ...ops.imex_cuda import (
    build_iage_table,
    build_iage_year,
    build_iage_year_plain,
    build_phosphorus_table,
    build_phosphorus_year,
    build_phosphorus_year_plain,
)
from ...ops.year_operator import probe_year_operator
from ...utils.regions import region_mean_weights
from . import physics
from .iage import SURF_SLOW_FACTOR, surf_restore_rate
from .phosphorus import DEFAULT_PARAMS, light_lim_2d, phosphorus_jac


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


class _InCoreKernel:
    """what the py_driver_2d in-core kernels share: device, grid, region
    plumbing and the solver hooks that do not depend on the physics.
    Subclasses set `_year_fn` and supply jvp and the preconditioner.

    grid: an optional physics.Grid2D (models/py_driver_2d/convert.py builds
    one from the JAX package's grid); by default the grid is made from the
    axes and modelinfo
    """

    def __init__(self, depth, ypos, modelinfo, *, device, dtype, n_steps,
                 region_mask, grid_weight, grid):
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
        self.year = physics.SEC_PER_YEAR
        # a float32 state on a CUDA device runs the year's CUDA kernel
        self.use_kernel = self.device.type == "cuda" and dtype == torch.float32

        if region_mask is None:
            region_mask = np.ones((self.nz, self.ny), dtype=np.int32)
        if grid_weight is None:
            grid_weight = np.outer(depth.delta, ypos.delta)
        self.region_cnt = int(region_mask.max())
        self.mean_mat = self._tensor(region_mean_weights(region_mask, grid_weight))
        self._weight_flat = self._tensor(np.asarray(grid_weight).reshape(-1))
        # region membership (region, ncell) and the cells outside every region
        self._region_mask = (self.mean_mat > 0).to(dtype)
        self._region_fill = 1.0 - self._region_mask.sum(dim=0).reshape(
            self.nz, self.ny
        )

    def _tensor(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -- solver interface --------------------------------------------------------

    def comp_fcn(self, x):
        return self._year_fn(x) - x

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
        """(module=1, region) scalars (a numpy array, or a tensor that stays
        on its device) -> (nz, ny) field, 1 outside every region"""
        region_vals = torch.as_tensor(scalars, dtype=self.dtype,
                                      device=self.device)[0]
        field = (region_vals @ self._region_mask).reshape(self.nz, self.ny)
        return field + self._region_fill

    def apply_limiter(self, x, increment):
        """no bounds on these tracers; factors are 1"""
        return np.ones((1, self.region_cnt))

    def lin_comb(self, basis, coeff):
        res = self.scale(basis[0], coeff[0])
        for j in range(1, len(basis)):
            res = res + self.scale(basis[j], coeff[j])
        return res


class IageKernel(_InCoreKernel):
    """in-core kernel: py_driver_2d iage (2 tracers), IMEX year integration

    state layout: (2, nz, ny) tensor on `device`
    """

    def __init__(self, depth, ypos, modelinfo, *, device, dtype=torch.float32,
                 n_steps=8760, region_mask=None, grid_weight=None, grid=None):
        super().__init__(depth, ypos, modelinfo, device=device, dtype=dtype,
                         n_steps=n_steps, region_mask=region_mask,
                         grid_weight=grid_weight, grid=grid)
        grid = self.grid
        self.rate = surf_restore_rate(depth)

        diag = np.zeros((2, self.nz, self.ny))
        diag[0, 0, :] = -self.rate
        diag[1, 0, :] = -SURF_SLOW_FACTOR * self.rate
        self._vert_diag = diag

        span = (0.0, self.year)
        source = np.full((2, 1, 1), 1.0 / self.year)
        source0 = np.zeros((2, 1, 1))
        if self.use_kernel:
            # one table of the year's CN solves serves the F and JVP years
            self.table = build_iage_table(grid, diag, span, n_steps,
                                          device=self.device)
            self._year_fn = build_iage_year(
                grid, diag, source, span, n_steps, device=self.device,
                table=self.table,
            )
            self._year0_fn = build_iage_year(
                grid, diag, source0, span, n_steps, device=self.device,
                table=self.table,
            )
        else:
            self._year_fn = build_iage_year_plain(grid, diag, source, span, n_steps)
            self._year0_fn = build_iage_year_plain(
                grid, diag, source0, span, n_steps
            )

        # time-invariant lateral part of the preconditioner's Jacobians,
        # assembled once (physics.transport_jac would rebuild it per call)
        self._lateral_jac = physics.lateral_jac_const(grid)

    # -- solver interface --------------------------------------------------------

    def jvp(self, x, fcn, v):
        """exact Jacobian-vector product of F at x: the model is linear, so
        it is the source-free year of v, minus v"""
        return self._year0_fn(v) - v

    def build_year_operator(self, col_chunk=128):
        """probe the exact dense one-year transition operator (the model is
        linear; ops/year_operator.py): every grid basis column a channel of
        the source-free year, col_chunk columns of each tracer a year.  With
        the kernel (float32 on a card) each chunk is one launch of B1 on the
        F and JVP years' table, its 2 * col_chunk channels mapped to the
        two tracers' factor slots; elsewhere the plain year in the kernel's
        dtype.  Afterwards F and JVPs are dense matvecs and the
        cyclostationary state solves directly."""
        span = (0.0, self.year)

        def make_year0(channel_diag):
            source0 = np.zeros((channel_diag.shape[0], 1, 1))
            if self.use_kernel:
                return build_iage_year(self.grid, channel_diag, source0, span,
                                       self.n_steps, device=self.device,
                                       table=self.table)
            return build_iage_year_plain(self.grid, channel_diag, source0,
                                         span, self.n_steps)

        return probe_year_operator(make_year0, self._year_fn, self._vert_diag,
                                   col_chunk=col_chunk, dtype=self.dtype,
                                   device=self.device)

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


class PhosphorusKernel(_InCoreKernel):
    """in-core kernel: py_driver_2d phosphorus (po4/dop/pop), IMEX year.

    Nonlinear (Michaelis-Menten uptake), so the affine year-operator probe
    does not apply -- `build_year_operator` raises rather than probing a
    wrong linearization.

    The only stiff term is vertical mixing, which the Crank-Nicolson half of
    the IMEX split absorbs; biogeochemistry and particulate sinking
    integrate explicitly in the Heun half.  state layout: (3, nz, ny).

    params: the phosphorus parameter dict (DEFAULT_PARAMS by default);
    light_lim: an optional (nz, ny) light limitation
    (convert.light_lim_from_numpy carries the JAX package's), by default
    light_lim_2d of the axes
    """

    def __init__(self, depth, ypos, modelinfo, *, device, dtype=torch.float32,
                 n_steps=8760, region_mask=None, grid_weight=None, params=None,
                 grid=None, light_lim=None):
        super().__init__(depth, ypos, modelinfo, device=device, dtype=dtype,
                         n_steps=n_steps, region_mask=region_mask,
                         grid_weight=grid_weight, grid=grid)
        self.params = dict(DEFAULT_PARAMS if params is None else params)
        if light_lim is None:
            light_lim = light_lim_2d(depth, ypos, device=self.device, dtype=dtype)
        self.light_lim = torch.as_tensor(light_lim, dtype=dtype,
                                         device=self.device)
        year_args = (self.grid, self.params, self.light_lim, (0.0, self.year),
                     n_steps)
        # forward-mode AD runs through the plain year on every device
        self._year_plain = build_phosphorus_year_plain(*year_args)
        if self.use_kernel:
            # the table of the year's CN solves, built once
            self.table = build_phosphorus_table(self.grid, (0.0, self.year),
                                                n_steps, device=self.device)
            self._year_fn = build_phosphorus_year(*year_args, device=self.device,
                                                  table=self.table)
        else:
            self._year_fn = self._year_plain

    # -- solver interface --------------------------------------------------------

    def jvp(self, x, fcn, v):
        """exact Jacobian-vector product of F at x: forward mode
        (torch.func.jvp) through the full plain year"""
        _, tangent = torch.func.jvp(self._year_plain, (x,), (v,))
        return tangent - v

    def build_year_operator(self, col_chunk=128):
        raise NotImplementedError(
            "the phosphorus year map is nonlinear (Michaelis-Menten "
            "uptake); the affine year-operator probe applies only to "
            "linear modules such as iage"
        )

    # -- preconditioner: one implicit-Euler step of the full coupled Jacobian ------

    def precond_setup(self, x):
        """LU of the bordered implicit-Euler operator, linearised at po4 =
        x[0].

        mat = dt*J is exactly singular: total phosphorus is conserved, so the
        grid-weight functional w (tiled over the three tracers) is a left null
        vector of J.  Bordering with the rank-one term c*w*w^T makes the
        factorization nonsingular, and for P-neutral right-hand sides (which
        F and all Krylov products are, up to discretization error) the
        bordered solve returns exactly the P-neutral solution: multiplying
        the system by w^T gives c*(w.w)*(w.x) = w.r = 0.
        """
        mat = self.year * phosphorus_jac(
            self.grid, self.params, self.light_lim, 0.5 * self.year, x[0]
        )
        w = self._weight_flat.repeat(3)
        c = mat.diagonal().abs().mean() / (w @ w)
        return torch.linalg.lu_factor(mat + c * torch.outer(w, w))

    def precond_apply(self, data, r):
        lu, piv = data
        sol = torch.linalg.lu_solve(lu, piv, r.reshape(-1, 1))
        return sol.reshape(r.shape) - r

    # -- conveniences -------------------------------------------------------------

    def init_iterate(self):
        """column-interpolated initial iterate matching gen_init_iterate"""
        profiles = (
            ([130.0, 260.0], [5.5e-3, 4.1]),
            ([95.0, 140.0], [7.1e-2, 1.5e-4]),
            ([170.0, 250.0], [1.8e-2, 7.9e-4]),
        )
        cols = [np.interp(self.depth.mid, d, v) for d, v in profiles]
        field = np.stack(
            [np.broadcast_to(c[:, None], (self.nz, self.ny)) for c in cols]
        )
        return self._tensor(field)
