"""py_driver_2d phosphorus (po4, dop, pop) as plain PyTorch functions on
tensors.

Port of newton_krylov_ooc_tpu/models/py_driver_2d/phosphorus.py:28-162: the
parameters, the 2D light limitation, the tendency (`build_tend` there) and
its analytic Jacobian (`build_jac` there).  The state is a (3, nz, ny)
tensor of po4, dop and pop.  Michaelis-Menten uptake of po4 under light
limitation feeds dop and pop; both remineralise back to po4; pop sinks
with a zero-flux bottom.  Every term moves phosphorus between tracers or
cells, so the grid-weighted total over the three tracers is conserved.

`explicit_tend` is the IMEX year's explicit half (the JAX in-core kernel's
tendency, models/py_driver_2d/incore.py:349-374): lateral transport plus
the local terms, with vertical mixing left to the Crank-Nicolson half.
The tendencies take y (..., 3, nz, ny): the Radau year evaluates its three
collocation stages in one call.

The `phosphorus` class is the file-backed tracer module
(phosphorus.py:54-427 there): the tendency and its dense and banded
Jacobians for the banded Radau year, in the tracer-innermost layout of
band_info (bandwidth 3 min(nz, ny)), the derived po4_uptake history field,
and the eigen-regularised preconditioner, whose eigen iterations and
shifted solves run on the model's device through the banded LU
(ops/eigen.py) -- the deterministic replacement for the reference's host
ARPACK shift-invert.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.banded import dense_to_bands
from ...ops.eigen import (
    band_matvec,
    banded_extreme_eigs,
    banded_shift_solve,
    banded_smallest_eigs,
)
from ...utils.helpers import eval_expr
from ...utils.ncio import NCFile
from . import physics
from .iage import cell_bands_fn
from .tracer_module_state import TracerModuleState

DEFAULT_PARAMS = {
    "po4_halfsat": 0.5,
    "max_uptake_rate": 1.0 / (3.0 * 86400.0),
    "sigma": 0.67,
    "dop_remin_rate": 1.0 / (0.5 * 365.0 * 86400.0),
    "pop_remin_rate": 1.0 / (0.5 * 365.0 * 86400.0),
    "pop_sink_vel": 2.0 / 86400.0,
}


def gen_params(modelinfo):
    """tracer-module parameters, with modelinfo overrides"""
    logger = logging.getLogger(__name__)
    params = dict(DEFAULT_PARAMS)
    for key in params:
        if key in modelinfo:
            value = eval_expr(modelinfo[key])
            logger.info("using %s=%s (%e) from modelinfo", key, modelinfo[key], value)
            params[key] = value
    return params


def light_lim_2d_np(depth, ypos):
    """2D light limitation (nz, ny) in numpy: 25 m e-folding in depth,
    gaussian in ypos"""
    return np.outer(
        np.exp((-1.0 / 25.0) * depth.mid),
        np.exp(-1.0 * ((ypos.mid - 2.5e6) / 1.5e6) ** 2),
    )


def light_lim_2d(depth, ypos, *, device, dtype):
    """light_lim_2d_np as a tensor"""
    return torch.as_tensor(light_lim_2d_np(depth, ypos), dtype=dtype,
                           device=device)


def _add_local(grid, params, light_lim, y, d):
    """d (..., 3, nz, ny) plus uptake, remineralisation and sinking at y"""
    p = params
    po4, dop, pop = y[..., 0, :, :], y[..., 1, :, :], y[..., 2, :, :]
    uptake = p["max_uptake_rate"] * light_lim * po4 / (po4 + p["po4_halfsat"])
    dop_remin = p["dop_remin_rate"] * dop
    pop_remin = p["pop_remin_rate"] * pop
    d_po4 = d[..., 0, :, :] - uptake + dop_remin + pop_remin
    d_dop = d[..., 1, :, :] + p["sigma"] * uptake - dop_remin
    d_pop = d[..., 2, :, :] + (1.0 - p["sigma"]) * uptake - pop_remin

    # particulate sinking: the flux leaving row k enters row k+1; nothing
    # leaves through the bottom (zero-flux, mass retained)
    sink = F.pad(p["pop_sink_vel"] * pop[..., :-1, :], (0, 0, 1, 1))
    d_pop = d_pop + grid.dz_r[:, None] * (sink[..., :-1, :] - sink[..., 1:, :])
    return torch.stack([d_po4, d_dop, d_pop], dim=-3)


def explicit_tend(grid, params, light_lim, y):
    """the IMEX year's explicit tendency of y (3, nz, ny): advection,
    lateral mixing and the local terms"""
    d = physics.advection_tend(grid, y) + physics.horiz_mix_tend(grid, y)
    return _add_local(grid, params, light_lim, y, d)


def phosphorus_tend(grid, params, light_lim, time, y):
    """full tendency of y (..., 3, nz, ny) at `time` (() or (B,)):
    transport, vertical mixing included, and the local terms"""
    kv = physics.vert_mixing_coeff(grid, time)[..., None, :, :]
    return _add_local(grid, params, light_lim, y,
                      physics.transport_tend(grid, kv, y))


def phosphorus_jac(grid, params, light_lim, time, po4, lateral=None):
    """dense (3 ncell, 3 ncell) Jacobian of phosphorus_tend at `time`; it
    depends on the state only through po4 (nz, ny).  lateral:
    physics.lateral_jac_const(grid), passed in where the caller keeps it"""
    p = params
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    n = nz * ny
    jt = physics.transport_jac(grid, time, lateral)
    po4 = po4.reshape(-1)
    light = light_lim.reshape(-1)
    uptake_jac = (
        p["max_uptake_rate"] * light * p["po4_halfsat"]
        / (po4 + p["po4_halfsat"]) ** 2
    )
    cell = torch.arange(n, device=jt.device)
    dz_r_flat = grid.dz_r[:, None].expand(nz, ny).reshape(-1)

    def add(mat, rows, cols, vals):
        # (rows, cols) pairs are distinct: an indexed add without
        # accumulation, which a CUDA graph captures
        mat[rows, cols] = mat[rows, cols] + vals

    # sinking, within the pop block: gain from the layer above, loss to the
    # layer below (the bottom layer keeps its mass)
    upper, lower = cell[:-ny], cell[ny:]
    j_pop = jt.clone()
    add(j_pop, lower, upper, p["pop_sink_vel"] * dz_r_flat[lower])
    add(j_pop, upper, upper, -p["pop_sink_vel"] * dz_r_flat[upper])

    full = physics.block_diag_tracers([jt, jt, j_pop])
    # biogeochemical couplings
    add(full, cell, cell, -uptake_jac)
    add(full, n + cell, cell, p["sigma"] * uptake_jac)
    add(full, 2 * n + cell, cell, (1.0 - p["sigma"]) * uptake_jac)
    add(full, cell, n + cell, p["dop_remin_rate"])
    add(full, n + cell, n + cell, -p["dop_remin_rate"])
    add(full, cell, 2 * n + cell, p["pop_remin_rate"])
    add(full, 2 * n + cell, 2 * n + cell, -p["pop_remin_rate"])
    return full


def _params_of(static_args):
    """the parameter dict and the flat light limitation of static_args"""
    *values, light_lim_flat = static_args
    return dict(zip(DEFAULT_PARAMS, values)), light_lim_flat


def _band_layout(nz, ny):
    """(bandwidth, perm) of the tracer-innermost banded layout: perm maps
    banded index -> tracer-major flat index"""
    n = nz * ny
    if nz < ny:
        # ypos-major cells: cell' = y*nz + z; flat z-major cell = z*ny + y
        cell_perm = physics.ymajor_perm(nz, ny)
        bw = 3 * nz
    else:
        cell_perm = np.arange(n)
        bw = 3 * ny
    perm = (np.arange(3)[None, :] * n + cell_perm[:, None]).reshape(-1)
    return bw, perm


class phosphorus(TracerModuleState):  # noqa: N801
    """phosphorus tracer module (po4, dop, pop)"""

    def __init__(self, tracer_module_name, fname, model_config_obj, depth, ypos):
        self.params = gen_params(model_config_obj.modelinfo)
        super().__init__(tracer_module_name, fname, model_config_obj, depth, ypos)

    @staticmethod
    def build_tend(grid, static_args, params):
        """tend(time, vals_flat): time () or (B,), vals_flat (..., 3 nz ny)"""
        p, light_lim_flat = _params_of(static_args)
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        light_lim = torch.as_tensor(
            np.asarray(light_lim_flat), dtype=grid.depth_mid.dtype,
            device=grid.depth_mid.device).reshape(nz, ny)

        def tend(time, vals_flat):
            vals = vals_flat.reshape(vals_flat.shape[:-1] + (3, nz, ny))
            return phosphorus_tend(grid, p, light_lim, time, vals).reshape(
                vals_flat.shape)

        return tend

    @staticmethod
    def build_jac(grid, static_args, params):
        p, light_lim_flat = _params_of(static_args)
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        light_lim = torch.as_tensor(
            np.asarray(light_lim_flat), dtype=grid.depth_mid.dtype,
            device=grid.depth_mid.device).reshape(nz, ny)
        lateral = physics.lateral_jac_const(grid)

        def jac(time, vals_flat):
            return phosphorus_jac(grid, p, light_lim, time,
                                  vals_flat[:nz * ny].reshape(nz, ny), lateral)

        return jac

    @classmethod
    def band_info(cls, grid):
        """banded stage solver layout: tracer-innermost state ordering.

        With state index k = cell*3 + tracer, the coupled 3-tracer Jacobian
        is banded: same-cell biogeochemical couplings sit at offsets +-2,
        near-neighbor transport at +-3, and far-neighbor transport at
        +-3*stride -- bandwidth 3*min(nz, ny), with the cell ordering chosen
        so the SMALLER grid dimension is the far stride (z-major cells when
        ny <= nz, ypos-major when nz < ny; LU cost scales with bandwidth^2).
        Returns (bandwidth, perm) with perm mapping banded index ->
        tracer-major flat index.
        """
        return cls._band_layout(grid.depth_mid.shape[0], grid.ypos_mid.shape[0])

    _band_layout = staticmethod(_band_layout)

    @staticmethod
    def build_jac_bands(grid, static_args, params):
        """banded Jacobian in the tracer-innermost layout of band_info;
        receives the integration-ordered (permuted) state"""
        p, light_lim_flat = _params_of(static_args)
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        n = nz * ny
        ymajor = nz < ny
        cell_bw = min(nz, ny)
        bw = 3 * cell_bw
        dtype, device = grid.depth_mid.dtype, grid.depth_mid.device

        rows = np.arange(3 * n)
        cell_of = rows // 3  # cell index in the CHOSEN ordering
        is_pop = rows % 3 == 2
        dz_r = grid.dz_r.cpu().numpy()
        light_zmaj = np.asarray(light_lim_flat, np.float64).reshape(-1)
        if ymajor:
            # z index of y-major cell c' = y*nz + z is c' % nz
            z_of = cell_of % nz
            light_cells = light_zmaj.reshape(nz, ny).T.reshape(-1)
            sink_off = 1     # layer above is one cell away in y-major order
        else:
            z_of = cell_of // ny
            light_cells = light_zmaj
            sink_off = ny
        dz_r_cell = dz_r[z_of]

        def put(arr):
            return torch.as_tensor(arr, dtype=dtype, device=device)

        light_lim = put(light_cells)
        sink_gain = put(np.where(is_pop & (z_of >= 1),
                                 p["pop_sink_vel"] * dz_r_cell, 0.0))
        sink_loss = put(np.where(is_pop & (z_of < nz - 1),
                                 p["pop_sink_vel"] * dz_r_cell, 0.0))
        # cell-level band offset o maps to permuted band position bw + 3*o
        cell_cols = torch.as_tensor(
            bw + 3 * (np.arange(2 * cell_bw + 1) - cell_bw), device=device)
        cell_bands = cell_bands_fn(grid)

        def jac_bands(time, vals_flat):
            pb = torch.zeros((3 * n, 2 * bw + 1), dtype=dtype, device=device)
            bands = cell_bands(time)  # each cell's row for its three tracers
            pb[:, cell_cols] = bands[:, None, :].expand(n, 3, -1).reshape(3 * n, -1)

            # particulate sinking (pop rows): gain from the layer above,
            # diagonal loss to the layer below (zero-flux bottom)
            pb[:, bw - 3 * sink_off] += sink_gain
            pb[:, bw] += -sink_loss

            # biogeochemical couplings, per cell (offsets are tracer deltas)
            po4 = vals_flat[0::3]
            uptake_jac = (
                p["max_uptake_rate"] * light_lim * p["po4_halfsat"]
                / (po4 + p["po4_halfsat"]) ** 2
            )
            pb[0::3, bw] += -uptake_jac
            pb[1::3, bw - 1] += p["sigma"] * uptake_jac
            pb[2::3, bw - 2] += (1.0 - p["sigma"]) * uptake_jac
            pb[0::3, bw + 1] += p["dop_remin_rate"]
            pb[1::3, bw] += -p["dop_remin_rate"]
            pb[0::3, bw + 2] += p["pop_remin_rate"]
            pb[2::3, bw] += -p["pop_remin_rate"]
            return pb[None]

        return jac_bands

    def tend_static_args(self):
        p = self.params
        return (*(p[key] for key in DEFAULT_PARAMS),
                tuple(light_lim_2d_np(self.depth, self.ypos).reshape(-1)))

    def tend_params(self):
        return np.zeros(0)

    # -- derived hist vars ---------------------------------------------------

    def hist_vars_metadata_tracer_like(self):
        res = super().hist_vars_metadata_tracer_like()
        po4_units = res["po4"]["attrs"]["units"]
        res["po4_uptake"] = {
            "attrs": {"long_name": "uptake of po4", "units": f"{po4_units} / s"}
        }
        return res

    def derived_hist_vals(self, tracer_vals_all):
        llim = light_lim_2d_np(self.depth, self.ypos)
        po4 = tracer_vals_all[0]  # (nz, ny, nt)
        uptake = (
            self.params["max_uptake_rate"]
            * llim[:, :, None]
            * po4
            / (po4 + self.params["po4_halfsat"])
        )
        return {"po4_uptake": uptake}

    def stats_vars_tracer_like(self):
        res = super().stats_vars_tracer_like()
        res.append("po4_uptake")
        return res

    # -- preconditioner ----------------------------------------------------------

    def apply_precond_jacobian(self, time_range, res_tms, jac_builder, fptr_precond):
        """eigen-regularized implicit-Euler preconditioner (see the JAX
        module): the eigen iterations and shifted solves on
        jac_builder.device, through the banded LU"""
        logger = logging.getLogger(__name__)

        self_vals_3d = self.get_tracer_vals_all()
        shape = self_vals_3d.shape
        self_vals = self_vals_3d.reshape(-1)

        time_n = 1
        time_delta = (time_range[1] - time_range[0]) / time_n

        precond_time_vals = fptr_precond.var("time")[:]
        precond_po4 = fptr_precond.var("po4")

        eye = np.eye(self_vals.size)
        mat = np.eye(self_vals.size)
        tracer_vals_3d = np.zeros(shape)
        for time_ind in range(time_n):
            time_end = time_range[0] + (time_ind + 1.0) * time_delta
            precond_time_ind = int(np.argmin(np.abs(time_end - precond_time_vals)))
            tracer_vals_3d[0, :] = precond_po4[precond_time_ind, :]
            time_mid = time_range[0] + (time_ind + 0.5) * time_delta
            jac = jac_builder(time_mid, tracer_vals_3d.reshape(-1))
            mat = mat @ (eye - time_delta * jac)
        mat = eye - mat

        # banded tracer-innermost layout on the model's device: the eigen
        # iterations and shifted solves go through the banded LU
        bw, perm = self._band_layout(shape[1], shape[2])
        bands = torch.as_tensor(dense_to_bands(mat[np.ix_(perm, perm)], bw),
                                dtype=torch.float64, device=jac_builder.device)

        e_cnt = 5
        e_vals = banded_extreme_eigs(bands, k=e_cnt)
        for k in range(e_cnt):
            logger.info(
                "large e_val[%d] = %e + %e j", k, e_vals[k].real, e_vals[k].imag
            )
        # inverse iteration shifted marginally off the (exactly singular)
        # null eigenvalue: roundoff keeps the pivot-free LU viable, and the
        # tiny shift leaves the null mode overwhelmingly dominant
        sigma = 1.0e-8 * float(np.abs(np.diag(mat)).max())
        e_vals, e_vects = banded_smallest_eigs(bands, sigma, k=e_cnt)
        for k in range(e_cnt):
            logger.info(
                "small e_val[%d] = %e + %e j", k, e_vals[k].real, e_vals[k].imag
            )

        # the locked iteration returns a real Ritz vector: guard on its
        # residual -- a vector that is not near-null would silently break
        # the conservation projection below
        null_p = e_vects[:, 0] / np.linalg.norm(e_vects[:, 0])
        null_resid = float(np.linalg.norm(band_matvec(
            bands, torch.as_tensor(null_p, device=bands.device)).cpu().numpy()))
        mat_scale = float(np.abs(np.diag(mat)).max())
        if null_resid > 1.0e-4 * mat_scale:
            raise RuntimeError(
                f"computed null vector is not near-null: ||mat @ v|| = "
                f"{null_resid:.3e} vs matrix scale {mat_scale:.3e}; the "
                "inverse iteration failed to isolate the conservation mode"
            )
        logger.info("null vector residual %e (matrix scale %e)", null_resid,
                    mat_scale)

        null_vect = np.empty(self_vals.size)
        null_vect[perm] = null_p

        # shift-regularize + Richardson-extrapolate to zero shift
        shift = 0.5 * e_vals[1].real
        rhs_p = torch.as_tensor(self_vals[perm], device=bands.device)
        solve_tmp = banded_shift_solve(bands, shift, rhs_p).cpu().numpy()
        solve_half = banded_shift_solve(bands, 0.5 * shift, rhs_p).cpu().numpy()
        solve_vals = np.empty(self_vals.size)
        solve_vals[perm] = 2.0 * solve_half - solve_tmp

        # normalize the null vector so its weighted mean is 1 per region
        e_vect_tms = copy.copy(self)
        e_vect_tms.set_tracer_vals_all(null_vect.reshape(shape), reseat_vals=True)
        e_vect_tms /= e_vect_tms.mean()

        precond_dir = os.path.dirname(fptr_precond.fname)
        null_space_fname = os.path.join(precond_dir, "precond_null_space.nc")
        with NCFile(null_space_fname, mode="w") as fptr_null_space:
            fptr_null_space.stamp_history(
                "py_driver_2d.phosphorus.apply_precond_jacobian"
            )
            e_vect_tms.dump(fptr_null_space, "define")
            e_vect_tms.dump(fptr_null_space, "write")

        # project out the null direction so total P is conserved
        solve_tms = copy.copy(self)
        solve_tms.set_tracer_vals_all(solve_vals.reshape(shape), reseat_vals=True)
        solve_tms -= solve_tms.mean() * e_vect_tms
        solve_vals = solve_tms.get_tracer_vals_all().reshape(-1)

        res_tms.set_tracer_vals_all((solve_vals - self_vals).reshape(shape))
