"""iage tracer module for py_driver_2d: ideal age with fast and slow surface
restoring (2 tracers).  Behavioral spec: nk_ooc/py_driver_2d/iage.py; the
port of newton_krylov_ooc_tpu/models/py_driver_2d/iage.py.

The file-backed model state integrates it with the banded Radau year
(ops/radau.py): build_tend's tendency, and build_jac_bands' analytic
row-band Jacobian in band_info's cell order.  build_jac is the dense one.

Preconditioner: invert I - prod_i (I - dt J(t_i)) (three implicit-Euler steps
across the year) minus identity, i.e. the Jacobian of F(X) = X(1yr) - X under
a coarse time discretization.
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics
from .tracer_module_state import TracerModuleState

SURF_SLOW_FACTOR = 0.01


def surf_restore_rate(depth):
    """surface restoring rate: 24/day over 10 m, scaled to the surface layer"""
    return 24.0 / 86400.0 * 10.0 / depth.delta[0]


def cell_order(grid):
    """(ymajor, bandwidth, cell_perm) of the banded layout with the smaller
    grid dimension as the far stride: z-major cells with bandwidth ny when
    ny <= nz, ypos-major with bandwidth nz otherwise; cell_perm maps the
    layout's cell index to the z-major one"""
    nz = grid.depth_mid.shape[0]
    ny = grid.ypos_mid.shape[0]
    if nz < ny:
        return True, nz, physics.ymajor_perm(nz, ny)
    return False, ny, np.arange(nz * ny)


def cell_bands_fn(grid):
    """time -> the single-tracer transport bands in cell_order's layout,
    its time-invariant lateral part built once"""
    ymajor = cell_order(grid)[0]
    if ymajor:
        lateral = physics.lateral_bands_const_ymajor(grid)
        return lambda time: physics.transport_bands_ymajor(grid, time, lateral)
    lateral = physics.lateral_bands_const(grid)
    return lambda time: physics.transport_bands(grid, time, lateral)


class iage(TracerModuleState):  # noqa: N801
    """iage tracer module (iage, iage_slow_rest)"""

    @staticmethod
    def build_tend(grid, static_args, params):
        """tend(time, vals_flat): time () or (B,), vals_flat (..., 2 nz ny)"""
        (restore_rate,) = static_args
        restore_rate = float(restore_rate)
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        rates = grid.depth_mid.new_zeros((2, nz, ny))
        rates[0, 0, :] = restore_rate
        rates[1, 0, :] = SURF_SLOW_FACTOR * restore_rate
        aging = 1.0 / physics.SEC_PER_YEAR

        def tend(time, vals_flat):
            vals = vals_flat.reshape(vals_flat.shape[:-1] + (2, nz, ny))
            kv = physics.vert_mixing_coeff(grid, time)[..., None, :, :]
            res = physics.transport_tend(grid, kv, vals) - rates * vals
            return (res + aging).reshape(vals_flat.shape)

        return tend

    @staticmethod
    def build_jac(grid, static_args, params):
        (restore_rate,) = static_args
        ny = grid.ypos_mid.shape[0]
        surf = torch.arange(ny, device=grid.depth_mid.device)
        lateral = physics.lateral_jac_const(grid)

        def jac(time, vals_flat):
            jt = physics.transport_jac(grid, time, lateral)
            j0, j1 = jt.clone(), jt.clone()
            j0[surf, surf] += -restore_rate
            j1[surf, surf] += -SURF_SLOW_FACTOR * restore_rate
            return physics.block_diag_tracers([j0, j1])

        return jac

    @classmethod
    def band_info(cls, grid):
        """per-tracer banded layout with the smaller grid dimension as the
        far stride: bandwidth min(nz, ny) (cells z-major when ny <= nz,
        ypos-major otherwise); perm keeps tracers outermost so the banded
        solver's per-block reshape stays aligned"""
        n = grid.depth_mid.shape[0] * grid.ypos_mid.shape[0]
        _ymajor, bw, cell_perm = cell_order(grid)
        perm = (np.arange(2)[:, None] * n + cell_perm[None, :]).reshape(-1)
        return bw, perm

    @staticmethod
    def build_jac_bands(grid, static_args, params):
        """banded stage Jacobian, (2 tracer blocks, ncell, 2*bw+1) in the
        band_info cell ordering"""
        (restore_rate,) = static_args
        restore_rate = float(restore_rate)
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        ymajor, bw, _cell_perm = cell_order(grid)
        # surface cells (z = 0) in the chosen ordering
        surf = torch.as_tensor(np.arange(ny) * nz if ymajor else np.arange(ny),
                               device=grid.depth_mid.device)
        cell_bands = cell_bands_fn(grid)

        def jac_bands(time, vals_flat):
            bt = cell_bands(time)
            b0, b1 = bt.clone(), bt.clone()
            b0[surf, bw] += -restore_rate
            b1[surf, bw] += -SURF_SLOW_FACTOR * restore_rate
            return torch.stack([b0, b1])

        return jac_bands

    def tend_static_args(self):
        return (surf_restore_rate(self.depth),)

    def tend_params(self):
        return np.zeros(0)

    def apply_precond_jacobian(self, time_range, res_tms, jac_builder, fptr_precond):
        """coarse implicit-Euler-product preconditioner (see module docstring)"""
        self_vals_3d = self.get_tracer_vals_all()
        shape = self_vals_3d.shape
        self_vals = self_vals_3d.reshape(-1)

        time_n = 3
        time_delta = (time_range[1] - time_range[0]) / time_n

        eye = np.eye(self_vals.size)
        mat = np.eye(self_vals.size)
        for time_ind in range(time_n):
            time_mid = time_range[0] + (time_ind + 0.5) * time_delta
            # iage's Jacobian is tracer-independent; zeros are a fine eval point
            jac = jac_builder(time_mid, np.zeros_like(self_vals))
            mat = mat @ (eye - time_delta * jac)
        mat = eye - mat

        res_vals = np.linalg.solve(mat, self_vals)
        res_tms.set_tracer_vals_all((res_vals - self_vals).reshape(shape))
