"""py_driver_2d tracer-module state: 2D (depth x ypos) tracers.

Loading (file / 'zeros' / 'gen_init_iterate' column-interp), netCDF dump with
both axes, history variables (time mean/anom/std/delta, depth integral, ypos
mean, depth-ypos integral) and stats hooks.
Behavioral spec: nk_ooc/py_driver_2d/tracer_module_state.py.  The port's own
copy of newton_krylov_ooc_tpu/models/py_driver_2d/tracer_module_state.py.
"""

from __future__ import annotations

import logging

import numpy as np

from ...core.state import TracerModuleState as TracerModuleStateBase
from ...utils.ncio import datatype_sname
from ...utils.units import units_str_format


class TracerModuleState(TracerModuleStateBase):
    """2D (depth, ypos) tracer module"""

    def __init__(self, tracer_module_name, fname, model_config_obj, depth, ypos):
        self.depth = depth
        self.ypos = ypos
        super().__init__(tracer_module_name, fname, model_config_obj)

    def grid_dims(self):
        return (self.depth.axisname, self.ypos.axisname)

    def _load_vals(self, fname):
        logger = logging.getLogger(__name__)
        logger.debug('tracer_module_name="%s", fname="%s"', self.name, fname)
        shape = (len(self.depth), len(self.ypos))
        if fname == "zeros":
            return np.zeros((self.tracer_cnt, *shape))
        if fname == "gen_init_iterate":
            vals = np.empty((self.tracer_cnt, *shape))
            tracers_metadata = self._tracer_module_def["tracers"]
            for ind, (tracer_name, md) in enumerate(tracers_metadata.items()):
                if "init_iterate_vals" in md:
                    source_md = md
                elif "shadows" in md:
                    source_md = tracers_metadata[md["shadows"]]
                else:
                    raise ValueError(f"gen_init_iterate failure for {tracer_name}")
                column = np.interp(
                    self.depth.mid,
                    source_md["init_iterate_val_depths"],
                    source_md["init_iterate_vals"],
                )
                vals[ind] = np.broadcast_to(column[:, np.newaxis], shape)
            return vals
        return super()._load_vals(fname)

    def dump(self, fptr, action):
        if action == "define":
            for axis in [self.depth, self.ypos]:
                fptr.create_dimensions_verify(axis.dump_dimensions())
                if not fptr.has_var(axis.axisname):
                    fptr.create_vars(axis.dump_vars_metadata())
            fptr.create_vars(
                {
                    tracer_name: {"dimensions": self.grid_dims()}
                    for tracer_name in self.tracer_names
                }
            )
        elif action == "write":
            for axis in [self.depth, self.ypos]:
                axis.dump_write(fptr)
            for ind, tracer_name in enumerate(self.tracer_names):
                fptr.var(tracer_name)[:] = self._vals[ind]
        else:
            raise ValueError(f"unknown action={action}")
        return self

    # -- history variables -----------------------------------------------------

    def hist_vars_metadata_tracer_like(self):
        return {
            tracer_name: {"attrs": md["attrs"]}
            for tracer_name, md in self._tracer_module_def["tracers"].items()
        }

    def hist_vars_metadata(self):
        res = {}
        depth_name = self.depth.axisname
        ypos_name = self.ypos.axisname
        for name, md in self.hist_vars_metadata_tracer_like().items():
            attrs = md["attrs"]
            res[name] = {
                "dimensions": ("time", depth_name, ypos_name),
                "attrs": attrs.copy(),
            }
            res[f"{name}_time_mean"] = {
                "dimensions": (depth_name, ypos_name),
                "attrs": {**attrs, "long_name": attrs["long_name"] + ", time mean"},
            }
            res[f"{name}_time_anom"] = {
                "dimensions": ("time", depth_name, ypos_name),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", time anomaly",
                },
            }
            res[f"{name}_time_std"] = {
                "dimensions": (depth_name, ypos_name),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", time std dev",
                },
            }
            res[f"{name}_time_delta"] = {
                "dimensions": (depth_name, ypos_name),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"]
                    + ", end state minus start state",
                },
            }
            res[f"{name}_depth_int"] = {
                "dimensions": ("time", ypos_name),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", depth integral",
                    "units": units_str_format(
                        f"( {attrs['units']} ) ( {self.depth.units} )"
                    ),
                },
            }
            res[f"{name}_ypos_mean"] = {
                "dimensions": ("time", depth_name),
                "attrs": {**attrs, "long_name": attrs["long_name"] + ", ypos mean"},
            }
            res[f"{name}_depth_ypos_int"] = {
                "dimensions": ("time",),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", depth-ypos integral",
                    "units": units_str_format(
                        f"( {attrs['units']} ) ( {self.depth.units} ) "
                        f"( {self.ypos.units} )"
                    ),
                },
            }
        return res

    @staticmethod
    def hist_time_mean_weights(fptr):
        """trapezoid weights over the hist time samples (endpoints halved)"""
        timelen = fptr.dim_len("time")
        weights = np.full(timelen, 1.0 / (timelen - 1))
        weights[0] *= 0.5
        weights[-1] *= 0.5
        return weights

    def derived_hist_vals(self, tracer_vals_all):
        """derived tracer-like fields; tracer_vals_all (tracer_cnt, nz, ny, nt)"""
        return {}

    def write_hist_vars(self, fptr, tracer_vals_all):
        time_weights = self.hist_time_mean_weights(fptr)
        derived = self.derived_hist_vals(tracer_vals_all)
        names = list(self.hist_vars_metadata_tracer_like())
        ypos_extent = self.ypos.edges.max() - self.ypos.edges.min()

        for ind, name in enumerate(names):
            if ind < self.tracer_cnt:
                vals = np.moveaxis(tracer_vals_all[ind], -1, 0)  # (nt, nz, ny)
            else:
                vals = np.moveaxis(derived[name], -1, 0)
            vals_mean = np.einsum("i,i...", time_weights, vals)
            vals_anom = vals - vals_mean
            vals_var = np.einsum("i,i...", time_weights, vals_anom**2)

            fptr.var(name)[:] = vals
            fptr.var(f"{name}_time_mean")[:] = vals_mean
            fptr.var(f"{name}_time_anom")[:] = vals_anom
            fptr.var(f"{name}_time_std")[:] = np.sqrt(vals_var)
            fptr.var(f"{name}_time_delta")[:] = vals[-1, :] - vals[0, :]
            fptr.var(f"{name}_depth_int")[:] = self.depth.int_vals_mid(vals, axis=-2)
            fptr.var(f"{name}_ypos_mean")[:] = (
                self.ypos.int_vals_mid(vals, axis=-1) / ypos_extent
            )
            fptr.var(f"{name}_depth_ypos_int")[:] = self.depth.int_vals_mid(
                self.ypos.int_vals_mid(vals, axis=-1), axis=-1
            )

    # -- stats ---------------------------------------------------------------------

    def stats_dimensions(self, fptr):
        res = self.depth.dump_dimensions()
        res.update(self.ypos.dump_dimensions())
        return res

    def stats_vars_metadata(self, fptr_hist):
        res = self.depth.dump_vars_metadata()
        res.update(self.ypos.dump_vars_metadata())
        for name in self.stats_vars_tracer_like():
            var = fptr_hist.var(name)
            attrs = {
                key: val for key, val in var.attrs.items() if key != "cell_methods"
            }
            datatype = datatype_sname(var.datatype)
            res[name] = {
                "datatype": datatype,
                "dimensions": (
                    "iteration",
                    self.depth.axisname,
                    self.ypos.axisname,
                ),
                "attrs": attrs,
            }
            res[f"{name}_mean_{self.ypos.axisname}"] = {
                "datatype": datatype,
                "dimensions": ("iteration", self.depth.axisname),
                "attrs": attrs,
            }
        return res

    def stats_vars_vals_iteration_invariant(self, fptr_hist):
        res = self.depth.dump_vals_dict()
        res.update(self.ypos.dump_vals_dict())
        return res

    def stats_vars_vals(self, fptr_hist):
        time_weights = self.hist_time_mean_weights(fptr_hist)
        ypos_weights = self.ypos.delta / self.ypos.delta.sum()
        res = {}
        for name in self.stats_vars_tracer_like():
            vals = fptr_hist.var(name)[:]
            res[name] = np.einsum("i,i...", time_weights, vals)
            res[f"{name}_mean_{self.ypos.axisname}"] = np.einsum(
                "j,...j", ypos_weights, res[name]
            )
        return res
