"""forced_{suff} tracer modules for py_driver_2d: single-tracer family with
configurable surface restoring (none/const/file) and interior sources
(none/const/decay/file with optional sink-threshold smoothing).
Behavioral spec: nk_ooc/py_driver_2d/forced.py; the port of
newton_krylov_ooc_tpu/models/py_driver_2d/forced.py.

File forcings are loaded once into dense (time, ...) float64 tables,
interpolated to the model grid at load time and to model time inside the
tendency (interp_time, on the state's device, with no host read); the
module instances ({suff}) of one option set share one integrator, whose
cache key holds the tables by identity (_HashableTables).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...utils.helpers import eval_expr
from ...utils.ncio import NCFile
from . import physics
from .iage import cell_bands_fn, cell_order
from .tracer_module_state import TracerModuleState


def load_forcing_table(fname, varname, additional_dims_out, scalef=1.0):
    """
    load a forcing field and interpolate its non-time dims onto the model grid

    returns (times, table) with table interpolated to additional_dims_out
    along axes 1..; interpolation along axis 0 (time) happens in the tendency
    (capability parity: nk_ooc/utils.py:488-537)
    """
    logger = logging.getLogger(__name__)
    logger.info("reading %s from %s", varname, fname)
    with NCFile(fname) as fptr:
        var = fptr.var(varname)
        dimnames = var.dimensions
        ndim = len(var.shape)
        if ndim not in (1, 2, 3):
            raise ValueError(f"unexpected ndim={ndim}")
        if len(additional_dims_out) != ndim - 1:
            raise ValueError(
                f"len(additional_dims_out) = {len(additional_dims_out)} must be "
                f"{ndim - 1}"
            )
        times = fptr.var(dimnames[0])[:]
        data = scalef * var[:]
        for axis in range(1, ndim):
            dim_in = fptr.var(dimnames[axis])[:]
            dim_out = np.asarray(additional_dims_out[axis - 1])
            if len(dim_in) != len(dim_out) or (dim_in != dim_out).any():
                data = _interp_axis(dim_in, data, dim_out, axis)
    return times, data


def _interp_axis(x_in, data, x_out, axis):
    """linear interpolation (with linear extrapolation) along one axis"""
    data = np.moveaxis(data, axis, -1)
    shape = data.shape[:-1]
    flat = data.reshape(-1, data.shape[-1])
    out = np.empty((flat.shape[0], len(x_out)))
    for ind in range(flat.shape[0]):
        out[ind] = _interp_extrap(x_out, x_in, flat[ind])
    return np.moveaxis(out.reshape(shape + (len(x_out),)), -1, axis)


def _interp_extrap(x, xp, fp):
    """np.interp with linear extrapolation beyond the endpoints"""
    res = np.interp(x, xp, fp)
    if len(xp) >= 2:
        left = x < xp[0]
        right = x > xp[-1]
        res = np.where(
            left, fp[0] + (x - xp[0]) * (fp[1] - fp[0]) / (xp[1] - xp[0]), res
        )
        res = np.where(
            right,
            fp[-1] + (x - xp[-1]) * (fp[-1] - fp[-2]) / (xp[-1] - xp[-2]),
            res,
        )
    return res


def interp_time(time, times, table):
    """linear time-interpolation (with extrapolation) of a forcing table:
    time () or (B,), times (nt,) increasing, table (nt, ...) -> (B..., ...)
    in the tables' dtype, the JAX package's interp_time_jnp"""
    time = torch.as_tensor(time, dtype=times.dtype, device=times.device)
    flat = time.reshape(-1)
    ind = torch.clamp(torch.searchsorted(times, flat) - 1, 0, len(times) - 2)
    t0, t1 = times[ind], times[ind + 1]
    w = ((flat - t0) / (t1 - t0)).reshape((-1,) + (1,) * (table.dim() - 1))
    res = (1.0 - w) * table[ind] + w * table[ind + 1]
    return res.reshape(time.shape + table.shape[1:])


def gen_forced_params(modelinfo, depth, ypos):
    """surf_restore + sms parameter dict (validated) and forcing tables"""
    params = {}

    params["surf_restore_opt"] = modelinfo["forced_surf_restore_opt"]
    if params["surf_restore_opt"] not in ["none", "const", "file"]:
        raise ValueError(
            f'unknown forced_surf_restore_opt={params["surf_restore_opt"]}'
        )
    if params["surf_restore_opt"] != "none":
        surf_restore_rate_10m = 24.0 / 86400.0
        if "forced_surf_restore_rate_10m" in modelinfo:
            surf_restore_rate_10m = eval_expr(
                modelinfo["forced_surf_restore_rate_10m"]
            )
        params["surf_restore_rate"] = 10.0 / depth.delta[0] * surf_restore_rate_10m
        if params["surf_restore_opt"] == "const":
            params["surf_restore_const"] = eval_expr(
                modelinfo["forced_surf_restore_const"]
            )
        if params["surf_restore_opt"] == "file":
            params["surf_restore_table"] = load_forcing_table(
                modelinfo["forced_surf_restore_fname"],
                modelinfo["forced_surf_restore_varname"],
                [ypos.mid],
            )

    params["sms_opt"] = modelinfo["forced_sms_opt"]
    if params["sms_opt"] not in ["none", "const", "decay", "file"]:
        raise ValueError(f'unknown forced_sms_opt={params["sms_opt"]}')
    if params["sms_opt"] == "const":
        params["sms_const"] = eval_expr(modelinfo["forced_sms_const"])
    if params["sms_opt"] == "decay":
        params["sms_decay_rate"] = eval_expr(modelinfo["forced_sms_decay_rate"])
    if params["sms_opt"] == "file":
        scalef = 1.0
        if "forced_sms_scalef" in modelinfo:
            scalef = eval_expr(modelinfo["forced_sms_scalef"])
        if "forced_sink_thres" in modelinfo:
            params["sink_thres"] = eval_expr(modelinfo["forced_sink_thres"])
        params["sms_table"] = load_forcing_table(
            modelinfo["forced_sms_fname"],
            modelinfo["forced_sms_varname"],
            [depth.mid, ypos.mid],
            scalef=scalef,
        )

    if params["surf_restore_opt"] == "none" and params["sms_opt"] != "decay":
        raise ValueError(
            "forced_sms_opt must be decay if forced_surf_restore_opt == none"
        )
    return params


def _tables_on(grid, tables, name):
    """(times, table) of forcing `name` as float64 tensors on the grid's
    device"""
    times, table = tables[name]
    device = grid.depth_mid.device
    return (torch.as_tensor(np.asarray(times), dtype=torch.float64, device=device),
            torch.as_tensor(np.asarray(table), dtype=torch.float64, device=device))


class forced(TracerModuleState):  # noqa: N801
    """forced_{suff} tracer module (single tracer named {suff})"""

    _params_cache = {}

    def __init__(self, tracer_module_name, fname, model_config_obj, depth, ypos):
        key = id(model_config_obj)
        if key not in forced._params_cache:
            forced._params_cache[key] = gen_forced_params(
                model_config_obj.modelinfo, depth, ypos
            )
        self.params = forced._params_cache[key]
        super().__init__(tracer_module_name, fname, model_config_obj, depth, ypos)

    @staticmethod
    def build_tend(grid, static_args, params):
        """tend(time, vals_flat): time () or (B,), vals_flat (..., nz ny)"""
        (
            surf_restore_opt,
            surf_restore_rate,
            surf_restore_const,
            sms_opt,
            sms_const,
            sms_decay_rate,
            sink_thres,
            tables,
        ) = static_args
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        restore_tables = (_tables_on(grid, tables, "surf_restore")
                          if surf_restore_opt == "file" else None)
        sms_tables = _tables_on(grid, tables, "sms") if sms_opt == "file" else None

        def tend(time, vals_flat):
            v = vals_flat.reshape(vals_flat.shape[:-1] + (nz, ny))
            kv = physics.vert_mixing_coeff(grid, time)
            res = physics.transport_tend(grid, kv, v)

            restore_to = None
            if surf_restore_opt == "const":
                restore_to = surf_restore_const
            elif surf_restore_opt == "file":
                # forcing tables are float64; the state's dtype after
                restore_to = interp_time(time, *restore_tables).to(res.dtype)
            if restore_to is not None:
                surf = res[..., :1, :] + surf_restore_rate * (
                    restore_to - v[..., 0, :])[..., None, :]
                res = torch.cat([surf, res[..., 1:, :]], dim=-2)

            if sms_opt == "const":
                res = res + sms_const
            elif sms_opt == "decay":
                res = res - sms_decay_rate * v
            elif sms_opt == "file":
                sms = interp_time(time, *sms_tables).to(res.dtype)
                if sink_thres is not None:
                    tmp = v / sink_thres
                    sms_scalef = torch.where(
                        (sms < 0.0) & (tmp > 0.0) & (tmp < 1.0), tmp, 1.0
                    )
                    sms = sms * sms_scalef
                res = res + sms

            return res.reshape(vals_flat.shape)

        return tend

    def tend_static_args(self):
        p = self.params
        tables = {}
        if p["surf_restore_opt"] == "file":
            tables["surf_restore"] = p["surf_restore_table"]
        if p["sms_opt"] == "file":
            tables["sms"] = p["sms_table"]
        # the tables sit in the integrator's cache key by object identity
        return (
            p["surf_restore_opt"],
            p.get("surf_restore_rate", 0.0),
            p.get("surf_restore_const", 0.0),
            p["sms_opt"],
            p.get("sms_const", 0.0),
            p.get("sms_decay_rate", 0.0),
            p.get("sink_thres", None),
            _HashableTables(tables),
        )

    def tend_params(self):
        return np.zeros(0)

    @staticmethod
    def build_jac(grid, static_args, params):
        (
            surf_restore_opt,
            surf_restore_rate,
            _surf_restore_const,
            sms_opt,
            _sms_const,
            sms_decay_rate,
            sink_thres,
            tables,
        ) = static_args
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        device = grid.depth_mid.device
        diag = torch.arange(nz * ny, device=device)
        surf = torch.arange(ny, device=device)
        sms_tables = _tables_on(grid, tables, "sms") if sms_opt == "file" else None
        lateral = physics.lateral_jac_const(grid)

        def jac(time, vals_flat):
            jt = physics.transport_jac(grid, time, lateral)
            if surf_restore_opt != "none":
                jt[surf, surf] += -surf_restore_rate
            if sms_opt == "decay":
                jt[diag, diag] += -sms_decay_rate
            if sms_opt == "file" and sink_thres is not None:
                sms = interp_time(time, *sms_tables).reshape(-1).to(jt.dtype)
                tmp = vals_flat / sink_thres
                d_sms = torch.where(
                    (sms < 0.0) & (tmp > 0.0) & (tmp < 1.0), sms / sink_thres, 0.0
                )
                jt[diag, diag] += d_sms
            return jt

        return jac

    @classmethod
    def band_info(cls, grid):
        """single-tracer banded layout with the smaller grid dimension as
        the far stride: bandwidth min(nz, ny)"""
        _ymajor, bw, cell_perm = cell_order(grid)
        return bw, cell_perm

    @staticmethod
    def build_jac_bands(grid, static_args, params):
        """banded stage Jacobian, (1 tracer block, ncell, 2*bw+1) in the
        band_info cell ordering; receives the permuted state"""
        (
            surf_restore_opt,
            surf_restore_rate,
            _surf_restore_const,
            sms_opt,
            _sms_const,
            sms_decay_rate,
            sink_thres,
            tables,
        ) = static_args
        nz = grid.depth_mid.shape[0]
        ny = grid.ypos_mid.shape[0]
        ymajor, bw, cell_perm = cell_order(grid)
        device = grid.depth_mid.device
        surf = torch.as_tensor(np.arange(ny) * nz if ymajor else np.arange(ny),
                               device=device)
        cell_perm = torch.as_tensor(cell_perm, device=device)
        cell_bands = cell_bands_fn(grid)
        sms_tables = _tables_on(grid, tables, "sms") if sms_opt == "file" else None

        def jac_bands(time, vals_flat):
            bt = cell_bands(time)
            if surf_restore_opt != "none":
                bt[surf, bw] += -surf_restore_rate
            if sms_opt == "decay":
                bt[:, bw] += -sms_decay_rate
            if sms_opt == "file" and sink_thres is not None:
                sms = interp_time(time, *sms_tables).reshape(-1)[cell_perm]
                sms = sms.to(bt.dtype)
                tmp = vals_flat / sink_thres
                d_sms = torch.where(
                    (sms < 0.0) & (tmp > 0.0) & (tmp < 1.0), sms / sink_thres, 0.0
                )
                bt[:, bw] += d_sms
            return bt[None, :, :]

        return jac_bands

    def apply_precond_jacobian(self, time_range, res_tms, jac_builder, fptr_precond):
        """implicit-Euler-product preconditioner linearized at tracer
        snapshots read from the precond file"""
        self_vals_3d = self.get_tracer_vals_all()
        shape = self_vals_3d.shape
        self_vals = self_vals_3d.reshape(-1)

        time_n = 3
        time_delta = (time_range[1] - time_range[0]) / time_n

        precond_time_vals = fptr_precond.var("time")[:]
        precond_tracer = fptr_precond.var(self.tracer_names[0])

        eye = np.eye(self_vals.size)
        mat = np.eye(self_vals.size)
        tracer_vals_3d = np.zeros(shape)
        for time_ind in range(time_n):
            time_end = time_range[0] + (time_ind + 1.0) * time_delta
            precond_time_ind = int(np.argmin(np.abs(time_end - precond_time_vals)))
            tracer_vals_3d[0, :] = precond_tracer[precond_time_ind, :]
            time_mid = time_range[0] + (time_ind + 0.5) * time_delta
            jac = jac_builder(time_mid, tracer_vals_3d.reshape(-1))
            mat = mat @ (eye - time_delta * jac)
        mat = eye - mat

        res_vals = np.linalg.solve(mat, self_vals)
        res_tms.set_tracer_vals_all((res_vals - self_vals).reshape(shape))


class _HashableTables:
    """identity-hashed wrapper so forcing tables can sit in a static-args key"""

    def __init__(self, tables):
        self.tables = tables

    def __hash__(self):
        return id(self.tables) if self.tables else 0

    def __eq__(self, other):
        return isinstance(other, _HashableTables) and (
            (not self.tables and not other.tables) or self.tables is other.tables
        )

    def __getitem__(self, key):
        return self.tables[key]

    def __contains__(self, key):
        return key in self.tables
