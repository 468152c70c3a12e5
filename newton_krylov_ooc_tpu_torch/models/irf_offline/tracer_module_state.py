"""irf_offline tracer-module state: 3D (z_t, nlat, nlon) tracers.

The port's own copy of
newton_krylov_ooc_tpu/models/irf_offline/tracer_module_state.py (numpy on
the host).  Tracer modules are generic and fully YAML-driven: what
distinguishes iage from a dye is its per-tracer source/sink/restoring spec,
read here and turned into rate fields by the model state, as the
reference's cime_pop modules differ only in their POP namelist and gen_A
options, with the transport always supplied by the circulation fields.
"""

from __future__ import annotations

import logging

import numpy as np

from ...core.state import TracerModuleState as TracerModuleStateBase
from ...utils.ncio import NCFile, datatype_sname, extract_dimensions

SEC_PER_YEAR = 365.0 * 86400.0


class TracerModuleState(TracerModuleStateBase):
    """3D offline-transport tracer module"""

    def __init__(self, tracer_module_name, fname, model_config_obj, grid_shape,
                 depth_mid_cm):
        self._grid_shape = tuple(grid_shape)
        self._depth_mid_cm = np.asarray(depth_mid_cm)
        self._grid_dimnames = ("z_t", "nlat", "nlon")
        super().__init__(tracer_module_name, fname, model_config_obj)

    def grid_dims(self):
        return self._grid_dimnames

    def _load_vals(self, fname):
        logger = logging.getLogger(__name__)
        logger.debug('tracer_module_name="%s", fname="%s"', self.name, fname)
        shape = self._grid_shape
        if fname == "zeros":
            return np.zeros((self.tracer_cnt, *shape))
        if fname == "gen_init_iterate":
            vals = np.empty((self.tracer_cnt, *shape))
            tracers_metadata = self._tracer_module_def["tracers"]
            for ind, (tracer_name, md) in enumerate(tracers_metadata.items()):
                if "init_iterate_vals" in md:
                    column = np.interp(
                        1.0e-2 * self._depth_mid_cm,  # cm -> m, as in the defs
                        md["init_iterate_val_depths"],
                        md["init_iterate_vals"],
                    )
                    vals[ind] = column[:, None, None]
                else:
                    vals[ind] = float(md.get("init_iterate_val", 0.0))
            return vals
        with NCFile(fname) as fptr:
            vals = np.empty((self.tracer_cnt, *shape))
            for ind, tracer_name in enumerate(self.tracer_names):
                dimensions = extract_dimensions(fptr, tracer_name)
                if tuple(dimensions.values()) != shape:
                    raise ValueError(
                        f"unexpected dimension lengths for {tracer_name} in {fname}"
                    )
                vals[ind] = fptr.var(tracer_name)[:]
            self._grid_dimnames = tuple(dimensions)
        return vals

    def dump(self, fptr, action):
        if action == "define":
            fptr.create_dimensions_verify(
                dict(zip(self._grid_dimnames, self._grid_shape))
            )
            fptr.create_vars(
                {
                    tracer_name: {"dimensions": self._grid_dimnames}
                    for tracer_name in self.tracer_names
                }
            )
        elif action == "write":
            for ind, tracer_name in enumerate(self.tracer_names):
                fptr.var(tracer_name)[:] = self._vals[ind]
        else:
            raise ValueError(f"unknown action={action}")
        return self

    # -- source/sink spec (consumed by the model state) -----------------------

    def rate_specs(self):
        """per-tracer (source_rate [tracer/s], sink_diag [1/s] 3D builders)

        YAML keys per tracer (all optional):
          source_per_year      constant volumetric source [tracer/yr]
          sink_rate_per_year   uniform first-order decay [1/yr]
          surf_restore_pv_cm_s piston velocity [cm/s]; surface-layer
                               restoring at rate pv/dz_surf (gen_A `pv`
                               convention, gen_A.cpp:19-21)
          surf_restore_target  restoring target (default 0)
          surf_flux_const_cm_s constant surface gas flux [tracer cm/s]
          surf_flux_d          {TRACER: cm/s} partial derivatives of this
                               tracer's surface flux wrt other tracers'
                               surface values -- the reference's d_SF_X_d_Y
                               linearized air-sea exchange fields
                               (nk_ooc/cime_pop/tracer_module_state.py:192-229,
                               input/cime_pop/tracer_module_defs.yaml:43-57),
                               here part of the forward model itself
        """
        names = list(self._tracer_module_def["tracers"])
        specs = []
        for tracer_name, md in self._tracer_module_def["tracers"].items():
            surf_flux_d = {
                other: float(val)
                for other, val in md.get("surf_flux_d", {}).items()
            }
            unknown = set(surf_flux_d) - set(names)
            if unknown:
                raise ValueError(
                    f"surf_flux_d of {tracer_name} names tracers not in "
                    f"module {self.name}: {sorted(unknown)}"
                )
            specs.append(
                {
                    "name": tracer_name,
                    "source_per_year": float(md.get("source_per_year", 0.0)),
                    "sink_rate_per_year": float(
                        md.get("sink_rate_per_year", 0.0)
                    ),
                    "surf_restore_pv_cm_s": float(
                        md.get("surf_restore_pv_cm_s", 0.0)
                    ),
                    "surf_restore_target": float(
                        md.get("surf_restore_target", 0.0)
                    ),
                    "surf_flux_const_cm_s": float(
                        md.get("surf_flux_const_cm_s", 0.0)
                    ),
                    "surf_flux_d": surf_flux_d,
                }
            )
        return specs

    def derived_hist_specs(self):
        """validated module-level derived_hist_vars YAML entries

        vocabulary (mirroring the reference's hand-coded ABIO_D14Cocn var,
        nk_ooc/cime_pop/abio_dic_dic14.py:35-41, as a declarative spec):
          type: ratio_permil -- 1000 * (numerator/denominator - 1), zero
          where the denominator vanishes
        """
        res = {}
        for name, spec in self._tracer_module_def.get(
            "derived_hist_vars", {}
        ).items():
            if spec.get("type") != "ratio_permil":
                raise ValueError(
                    f"derived_hist_var {name}: unknown type {spec.get('type')!r}"
                )
            if name in self.tracer_names:
                raise ValueError(
                    f"derived_hist_var {name} collides with a tracer of "
                    f"module {self.name}"
                )
            for key in ("numerator", "denominator"):
                if spec.get(key) not in self.tracer_names:
                    raise ValueError(
                        f"derived_hist_var {name}: {key} {spec.get(key)!r} "
                        f"is not a tracer of module {self.name}"
                    )
            res[name] = dict(
                spec,
                attrs={
                    "long_name": name,
                    "units": "permil",
                    **spec.get("attrs", {}),
                },
            )
        return res

    def surf_flux_names(self):
        """tracers carrying a linearized surface gas-flux spec"""
        return [
            spec["name"]
            for spec in self.rate_specs()
            if spec["surf_flux_d"] or spec["surf_flux_const_cm_s"] != 0.0
        ]

    def surf_flux_vals(self, tracer_vals_all):
        """linearized surface gas flux [tracer cm/s] per tracer carrying any
        surf_flux_* spec; tracer_vals_all (tracer_cnt, nt, nz, nlat, nlon)"""
        surf = {
            name: tracer_vals_all[ind][:, 0]
            for ind, name in enumerate(self.tracer_names)
        }
        flux_names = self.surf_flux_names()
        res = {}
        for spec in self.rate_specs():
            if spec["name"] not in flux_names:
                continue
            flux = np.full_like(
                surf[spec["name"]], spec["surf_flux_const_cm_s"]
            )
            pv = spec["surf_restore_pv_cm_s"]
            if pv != 0.0:
                flux = flux + pv * (
                    spec["surf_restore_target"] - surf[spec["name"]]
                )
            for other, deriv in spec["surf_flux_d"].items():
                flux = flux + deriv * surf[other]
            res[spec["name"]] = flux
        return res

    # -- history variables -----------------------------------------------------

    def hist_vars_metadata_tracer_like(self):
        res = {
            tracer_name: {"attrs": md["attrs"]}
            for tracer_name, md in self._tracer_module_def["tracers"].items()
        }
        for name, spec in self.derived_hist_specs().items():
            res[name] = {"attrs": dict(spec["attrs"])}
        return res

    def hist_vars_metadata(self):
        res = {}
        dims3 = self._grid_dimnames
        for name, md in self.hist_vars_metadata_tracer_like().items():
            attrs = md["attrs"]
            res[name] = {
                "dimensions": ("time",) + dims3,
                "attrs": attrs.copy(),
            }
            res[f"{name}_time_mean"] = {
                "dimensions": dims3,
                "attrs": {**attrs, "long_name": attrs["long_name"] + ", time mean"},
            }
            res[f"{name}_horiz_mean"] = {
                "dimensions": ("time", dims3[0]),
                "attrs": {
                    **attrs,
                    "long_name": attrs["long_name"]
                    + ", volume-weighted horizontal mean",
                },
            }
        units = self.units
        for name in self.surf_flux_names():
            res[f"SF_{name}"] = {
                "dimensions": ("time",) + dims3[1:],
                "attrs": {
                    "long_name": f"linearized surface gas flux of {name}",
                    "units": f"{units} cm/s",
                },
            }
            res[f"SF_{name}_horiz_int"] = {
                "dimensions": ("time",),
                "attrs": {
                    "long_name": f"area-integrated surface gas flux of {name}",
                    "units": f"{units} cm^3/s",
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

    def write_hist_vars(self, fptr, tracer_vals_all, horiz_weights):
        """tracer_vals_all: (tracer_cnt, nt, nz, nlat, nlon);
        horiz_weights: (nlat, nlon) cell areas (masked cells zero)"""
        time_weights = self.hist_time_mean_weights(fptr)
        wsum = horiz_weights.sum()
        vals_by_name = {
            name: tracer_vals_all[ind]
            for ind, name in enumerate(self.tracer_names)
        }
        for name, spec in self.derived_hist_specs().items():
            num = vals_by_name[spec["numerator"]]
            den = vals_by_name[spec["denominator"]]
            nonzero = den != 0.0
            vals_by_name[name] = np.where(
                nonzero, 1.0e3 * (num / np.where(nonzero, den, 1.0) - 1.0), 0.0
            )
        for name in self.hist_vars_metadata_tracer_like():
            vals = vals_by_name[name]
            fptr.var(name)[:] = vals
            fptr.var(f"{name}_time_mean")[:] = np.einsum(
                "i,i...", time_weights, vals
            )
            fptr.var(f"{name}_horiz_mean")[:] = (
                np.einsum("tkji,ji->tk", vals, horiz_weights) / wsum
            )
        wet_surf = horiz_weights > 0.0
        for name, flux in self.surf_flux_vals(tracer_vals_all).items():
            flux = np.where(wet_surf, flux, 0.0)
            fptr.var(f"SF_{name}")[:] = flux
            fptr.var(f"SF_{name}_horiz_int")[:] = np.einsum(
                "tji,ji->t", flux, horiz_weights
            )

    # -- stats -----------------------------------------------------------------

    def stats_dimensions(self, fptr):
        return {"z_t": self._grid_shape[0]}

    def stats_vars_tracer_like(self):
        """tracers plus derived hist vars (the reference treats its derived
        ABIO_D14Cocn the same way, nk_ooc/cime_pop/abio_dic_dic14.py:35-41)"""
        return super().stats_vars_tracer_like() + list(
            self.derived_hist_specs()
        )

    def stats_vars_metadata(self, fptr_hist):
        res = {}
        for name in self.stats_vars_tracer_like():
            var = fptr_hist.var(name)
            attrs = {
                key: val for key, val in var.attrs.items() if key != "cell_methods"
            }
            res[f"{name}_horiz_mean"] = {
                "datatype": datatype_sname(var.datatype),
                "dimensions": ("iteration", "z_t"),
                "attrs": attrs,
            }
        for name in self.surf_flux_names():
            var = fptr_hist.var(f"SF_{name}_horiz_int")
            attrs = {
                key: val for key, val in var.attrs.items() if key != "cell_methods"
            }
            res[f"SF_{name}_horiz_int"] = {
                "datatype": datatype_sname(var.datatype),
                "dimensions": ("iteration",),
                "attrs": attrs,
            }
        return res

    def stats_vars_vals_iteration_invariant(self, fptr_hist):
        return {}

    def stats_vars_vals(self, fptr_hist):
        time_weights = self.hist_time_mean_weights(fptr_hist)
        res = {}
        for name in self.stats_vars_tracer_like():
            vals = fptr_hist.var(f"{name}_horiz_mean")[:]
            res[f"{name}_horiz_mean"] = np.einsum("i,i...", time_weights, vals)
        for name in self.surf_flux_names():
            vals = fptr_hist.var(f"SF_{name}_horiz_int")[:]
            res[f"SF_{name}_horiz_int"] = np.einsum(
                "i,i...", time_weights, vals
            )
        return res
