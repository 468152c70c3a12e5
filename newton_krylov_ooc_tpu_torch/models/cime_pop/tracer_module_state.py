"""cime_pop tracer-module state: 3D POP tracers loaded from model restart
files (the _CUR time level), dumped as _CUR/_OLD pairs for restart override.
Behavioral spec: nk_ooc/cime_pop/tracer_module_state.py; the port's own copy
of newton_krylov_ooc_tpu/models/cime_pop/tracer_module_state.py.
"""

from __future__ import annotations

import logging

import numpy as np

from ...core.state import TracerModuleState as TracerModuleStateBase
from ...utils.ncio import NCFile, datatype_sname, extract_dimensions
from ..external.cime import cime_yr_cnt


class TracerModuleState(TracerModuleStateBase):
    """3D POP tracer module (restart-file backed)"""

    def _load_vals(self, fname):
        """load tracers from a POP restart file (vars carry the _CUR suffix)"""
        logger = logging.getLogger(__name__)
        logger.debug('tracer_module_name="%s", fname="%s"', self.name, fname)
        grid_vars = self.get_grid_vars(self.tracer_names[0])
        grid_shape = grid_vars["region_mask"].shape
        vals = np.empty((self.tracer_cnt, *grid_shape))
        with NCFile(fname) as fptr:
            for ind, tracer_name in enumerate(self.tracer_names):
                varname = f"{tracer_name}_CUR"
                dimensions = extract_dimensions(fptr, varname)
                if tuple(dimensions.values()) != grid_shape:
                    raise ValueError(
                        f"unexpected dimension lengths for {varname} in {fname}"
                    )
                vals[ind] = fptr.var(varname)[:]
        self._grid_dimnames = tuple(dimensions)
        return vals

    def grid_dims(self):
        return self._grid_dimnames

    def dump(self, fptr, action):
        """dump tracers with _CUR and _OLD suffixes (restart-override format)"""
        grid_vars = self.get_grid_vars(self.tracer_names[0])
        grid_shape = grid_vars["region_mask"].shape
        dimnames = getattr(
            self, "_grid_dimnames", tuple(f"dim_{i}" for i in range(len(grid_shape)))
        )
        if action == "define":
            fptr.create_dimensions_verify(dict(zip(dimnames, grid_shape)))
            vars_metadata = {}
            for tracer_name in self.tracer_names:
                for suffix in ["CUR", "OLD"]:
                    vars_metadata[f"{tracer_name}_{suffix}"] = {
                        "dimensions": dimnames
                    }
            fptr.create_vars(vars_metadata)
        elif action == "write":
            for ind, tracer_name in enumerate(self.tracer_names):
                for suffix in ["CUR", "OLD"]:
                    fptr.var(f"{tracer_name}_{suffix}")[:] = self._vals[ind]
        else:
            raise ValueError(f"unknown action={action}")
        return self

    # -- stats -------------------------------------------------------------------

    def stats_dimnames(self, fptr):
        """stats dims: first tracer's dims minus the innermost (reduced) dim,
        minus a leading time dim"""
        tracer_name = self.tracer_names[0]
        dimnames = fptr.var(tracer_name).dimensions[:-1]
        if dimnames and dimnames[0] == "time":
            dimnames = dimnames[1:]
        return dimnames

    def stats_dimension_varnames(self, fptr):
        """coordinate vars (and their bounds) of the stats dims"""
        varnames = []
        for dimname in self.stats_dimnames(fptr):
            if fptr.has_var(dimname):
                varnames.append(dimname)
                bounds = fptr.var(dimname).attrs.get("bounds")
                if bounds is not None:
                    varnames.append(bounds)
        return varnames

    def stats_dimensions(self, fptr):
        dimensions = extract_dimensions(fptr, list(self.stats_dimnames(fptr)))
        dimensions.update(
            extract_dimensions(fptr, self.stats_dimension_varnames(fptr))
        )
        return dimensions

    def stats_vars_metadata(self, fptr_hist):
        res = {}
        for varname in self.stats_dimension_varnames(fptr_hist):
            var = fptr_hist.var(varname)
            res[varname] = {"dimensions": var.dimensions, "attrs": var.attrs}

        for tracer_name in self.stats_vars_tracer_like():
            tracer = fptr_hist.var(tracer_name)
            dimensions = tracer.dimensions
            datatype = datatype_sname(tracer.datatype)
            attrs = {
                key: val
                for key, val in tracer.attrs.items()
                if key not in ("cell_methods", "coordinates", "grid_loc")
            }
            if dimensions[0] == "time":
                dimensions = dimensions[1:]

            res[f"{tracer_name}_mean_{dimensions[-1]}"] = {
                "datatype": datatype,
                "dimensions": ("iteration", "region") + dimensions[:-1],
                "attrs": attrs,
            }
            res[f"{tracer_name}_mean_{dimensions[-2]}_{dimensions[-1]}"] = {
                "datatype": datatype,
                "dimensions": ("iteration", "region") + dimensions[:-2],
                "attrs": attrs,
            }
        return res

    def stats_vars_vals_iteration_invariant(self, fptr_hist):
        return {
            varname: fptr_hist.var(varname)[:]
            for varname in self.stats_dimension_varnames(fptr_hist)
        }

    def stats_vars_vals(self, fptr_hist):
        """region-masked grid-i and grid-ij weighted means"""
        tracer_name = self.tracer_names[0]
        grid_vars = self.get_grid_vars(tracer_name)
        grid_weight = grid_vars["grid_weight"]
        region_mask = grid_vars["region_mask"]
        region_cnt = self.model_config_obj.region_cnt

        isum_shape = (region_cnt,) + grid_weight.shape[:-1]
        denom_isum = np.empty(isum_shape)
        for region_ind in range(region_cnt):
            denom_isum[region_ind, :] = np.where(
                region_mask == region_ind + 1, grid_weight, 0.0
            ).sum(axis=-1)
        denom_ijsum = denom_isum.sum(axis=-1)

        res = {}
        for tracer_name in self.stats_vars_tracer_like():
            tracer = fptr_hist.var(tracer_name)
            dimensions = tracer.dimensions
            fill_value = tracer.attrs.get("_FillValue", 9.969209968386869e36)
            tracer_vals = tracer[:]
            if dimensions[0] == "time":
                dimensions = dimensions[1:]
                tracer_vals = tracer_vals[0, ...]
            tracer_vals = np.where(
                np.isclose(tracer_vals, fill_value), 0.0, tracer_vals
            )

            weighted_vals = grid_weight * tracer_vals
            numer_isum = np.empty(denom_isum.shape)
            for region_ind in range(region_cnt):
                numer_isum[region_ind, :] = np.where(
                    region_mask == region_ind + 1, weighted_vals, 0.0
                ).sum(axis=-1)
            quo_i = np.full(denom_isum.shape, fill_value)
            np.divide(numer_isum, denom_isum, out=quo_i, where=denom_isum != 0.0)
            res[f"{tracer_name}_mean_{dimensions[-1]}"] = quo_i

            numer_ijsum = numer_isum.sum(axis=-1)
            quo_ij = np.full(denom_ijsum.shape, fill_value)
            np.divide(numer_ijsum, denom_ijsum, out=quo_ij, where=denom_ijsum != 0.0)
            res[f"{tracer_name}_mean_{dimensions[-2]}_{dimensions[-1]}"] = quo_ij
        return res

    # -- surface-flux cross-tracer coupling -----------------------------------------

    def apply_tracers_sflux_term(self, tracer_names_subset, precond_fptr):
        """
        apply d_SF_<dst>_d_<src> surface-flux partial-derivative terms from the
        precond file to downstream tracers; returns whether a term was applied
        """
        logger = logging.getLogger(__name__)
        term_applied = False
        delta_time = 365.0 * 86400.0 * cime_yr_cnt(self.model_config_obj.modelinfo)
        tracer_names_all = self.tracer_names
        for tracer_name_src in tracer_names_subset:
            if tracer_name_src not in tracer_names_all:
                continue
            src_ind = tracer_names_all.index(tracer_name_src)
            for tracer_name_dst in tracer_names_all[src_ind + 1 :]:
                partial_deriv_varname = f"d_SF_{tracer_name_dst}_d_{tracer_name_src}"
                if not precond_fptr.has_var(partial_deriv_varname):
                    continue
                logger.info('applying "%s"', partial_deriv_varname)
                partial_deriv = precond_fptr.var(partial_deriv_varname)
                fill_value = partial_deriv.attrs.get(
                    "_FillValue", 9.969209968386869e36
                )
                vals = partial_deriv[:]
                vals = np.where(np.isclose(vals, fill_value), 0.0, vals)
                src = self.get_tracer_vals(tracer_name_src)
                dst = self.get_tracer_vals(tracer_name_dst)
                dz_surf = precond_fptr.var("dz")[:][0]
                dst[0, :] -= delta_time / dz_surf * vals * src[0, :]
                self.set_tracer_vals(tracer_name_dst, dst)
                term_applied = True
        return term_applied
