"""test_problem tracer-module state: 1D depth-column tracers.

Implements loading (netCDF file, 'zeros', or 'gen_init_iterate' interpolation
from YAML metadata), netCDF dump with the depth axis, history-variable
metadata/values (time mean/anom/std/delta, depth integral), and stats hooks.
Behavioral spec: nk_ooc/test_problem/tracer_module_state.py.  The port's own
copy of newton_krylov_ooc_tpu/models/test_problem/tracer_module_state.py.
"""

from __future__ import annotations

import logging

import numpy as np

from ...core.state import TracerModuleState as TracerModuleStateBase
from ...utils.ncio import datatype_sname
from ...utils.units import units_str_format


class TracerModuleState(TracerModuleStateBase):
    """1D depth-column tracer module"""

    def __init__(self, tracer_module_name, fname, model_config_obj, depth):
        if model_config_obj.region_cnt != 1:
            raise NotImplementedError("region_cnt > 1 not implemented")
        self.depth = depth
        super().__init__(tracer_module_name, fname, model_config_obj)

    def grid_dims(self):
        return (self.depth.axisname,)

    def _load_vals(self, fname):
        logger = logging.getLogger(__name__)
        logger.debug('tracer_module_name="%s", fname="%s"', self.name, fname)
        nlev = len(self.depth)
        if fname == "zeros":
            return np.zeros((self.tracer_cnt, nlev))
        if fname == "gen_init_iterate":
            vals = np.empty((self.tracer_cnt, nlev))
            tracers_metadata = self._tracer_module_def["tracers"]
            for ind, (tracer_name, md) in enumerate(tracers_metadata.items()):
                if "init_iterate_vals" in md:
                    source_md = md
                elif "shadows" in md:
                    source_md = tracers_metadata[md["shadows"]]
                else:
                    raise ValueError(f"gen_init_iterate failure for {tracer_name}")
                vals[ind] = np.interp(
                    self.depth.mid,
                    source_md["init_iterate_val_depths"],
                    source_md["init_iterate_vals"],
                )
            return vals
        return super()._load_vals(fname)

    def dump(self, fptr, action):
        if action == "define":
            fptr.create_dimensions_verify(self.depth.dump_dimensions())
            if not fptr.has_var(self.depth.axisname):
                fptr.create_vars(self.depth.dump_vars_metadata())
            fptr.create_vars(
                {
                    tracer_name: {"dimensions": self.grid_dims()}
                    for tracer_name in self.tracer_names
                }
            )
        elif action == "write":
            self.depth.dump_write(fptr)
            for ind, tracer_name in enumerate(self.tracer_names):
                fptr.var(tracer_name)[:] = self._vals[ind]
        else:
            raise ValueError(f"unknown action={action}")
        return self

    # -- history variables --------------------------------------------------

    def hist_vars_metadata_tracer_like(self):
        """tracer-like vars (tracers + derived fields) appearing in hist"""
        return {
            tracer_name: {"attrs": md["attrs"]}
            for tracer_name, md in self._tracer_module_def["tracers"].items()
        }

    def hist_vars_metadata(self):
        """metadata of all hist vars of this module"""
        res = {}
        depth_name = self.depth.axisname
        for name, md in self.hist_vars_metadata_tracer_like().items():
            attrs = md["attrs"]
            res[name] = {
                "dimensions": ("time", depth_name),
                "attrs": attrs.copy(),
            }
            res[f"{name}_time_mean"] = {
                "dimensions": (depth_name,),
                "attrs": {**attrs, "long_name": attrs["long_name"] + ", mean in time"},
            }
            res[f"{name}_time_anom"] = {
                "dimensions": ("time", depth_name),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", anomaly in time",
                },
            }
            res[f"{name}_time_std"] = {
                "dimensions": (depth_name,),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + ", std dev in time",
                },
            }
            res[f"{name}_time_delta"] = {
                "dimensions": (depth_name,),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"]
                    + ", end state minus start state",
                },
            }
            int_units = units_str_format(
                f"( {attrs['units']} ) ( {self.depth.units} )"
            )
            res[f"{name}_{depth_name}_int"] = {
                "dimensions": ("time",),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"] + f", {depth_name} integral",
                    "units": int_units,
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
        """
        values of derived tracer-like hist vars; tracer_vals_all has shape
        (tracer_cnt, nlev, ntime); subclasses append derived fields
        """
        return {}

    def write_hist_vars(self, fptr, tracer_vals_all):
        """write this module's hist vars; tracer_vals_all (tracer_cnt, nlev, nt)"""
        time_weights = self.hist_time_mean_weights(fptr)
        derived = self.derived_hist_vals(tracer_vals_all)
        names = list(self.hist_vars_metadata_tracer_like())
        depth_name = self.depth.axisname

        for ind, name in enumerate(names):
            if ind < self.tracer_cnt:
                vals = tracer_vals_all[ind].T  # (ntime, nlev)
            else:
                vals = derived[name].T
            vals_mean = np.einsum("i,i...", time_weights, vals)
            vals_anom = vals - vals_mean
            vals_var = np.einsum("i,i...", time_weights, vals_anom**2)

            fptr.var(name)[:] = vals
            fptr.var(f"{name}_time_mean")[:] = vals_mean
            fptr.var(f"{name}_time_anom")[:] = vals_anom
            fptr.var(f"{name}_time_std")[:] = np.sqrt(vals_var)
            fptr.var(f"{name}_time_delta")[:] = vals[-1, :] - vals[0, :]
            fptr.var(f"{name}_{depth_name}_int")[:] = self.depth.int_vals_mid(
                vals, axis=-1
            )

    # -- stats ------------------------------------------------------------------

    def stats_dimensions(self, fptr):
        return self.depth.dump_dimensions()

    def stats_vars_metadata(self, fptr_hist):
        res = self.depth.dump_vars_metadata()
        for name in self.stats_vars_tracer_like():
            var = fptr_hist.var(name)
            attrs = {
                key: val
                for key, val in var.attrs.items()
                if key != "cell_methods"
            }
            res[name] = {
                "datatype": datatype_sname(var.datatype),
                "dimensions": ("iteration", "region", self.depth.axisname),
                "attrs": attrs,
            }
        return res

    def stats_vars_vals_iteration_invariant(self, fptr_hist):
        return self.depth.dump_vals_dict()

    def stats_vars_vals(self, fptr_hist):
        """time-mean tracer-like fields (region dimension has length 1)"""
        time_weights = self.hist_time_mean_weights(fptr_hist)
        res = {}
        for name in self.stats_vars_tracer_like():
            vals = fptr_hist.var(name)[:]
            res[name] = np.einsum("i,i...", time_weights, vals)
        return res
