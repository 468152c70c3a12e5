"""abio_dic_dic14 tracer module for cime_pop: abiotic DIC / DIC-14.

Adds an area-integrated surface gas-flux stat (FG_ABIO_DIC, converted to
Pg/year) and the derived ABIO_D14Cocn field to the stats file.
Behavioral spec: nk_ooc/cime_pop/abio_dic_dic14.py; the port's own copy of
newton_krylov_ooc_tpu/models/cime_pop/abio_dic_dic14.py.
"""

from __future__ import annotations

import numpy as np

from .tracer_module_state import TracerModuleState


class abio_dic_dic14(TracerModuleState):  # noqa: N801
    """abio_dic_dic14 tracer module"""

    def stats_vars_metadata(self, fptr_hist):
        res = super().stats_vars_metadata(fptr_hist)

        var = fptr_hist.var("FG_ABIO_DIC")
        attrs = {
            key: val
            for key, val in var.attrs.items()
            if key not in ("cell_methods", "coordinates", "grid_loc")
        }
        attrs["long_name"] = "integrated surface gas flux of abiotic DIC"
        attrs["units"] = "Pg/year"
        res["FG_ABIO_DIC_int_nlat_nlon"] = {
            "datatype": "f8",
            "dimensions": ("iteration", "region"),
            "attrs": attrs,
        }
        return res

    def stats_vars_tracer_like(self):
        res = super().stats_vars_tracer_like()
        res.append("ABIO_D14Cocn")
        return res

    # nmol C / cm^2 / s * cm^2 -> Pg C / year:
    # nmol->mol, mol->g C (12), g->Pg, s->year (noleap)
    _FLUX_TO_PG_PER_YEAR = 1.0e-9 * 12.0 * 1.0e-15 * 86400.0 * 365.0

    def stats_vars_vals(self, fptr_hist):
        res = super().stats_vars_vals(fptr_hist)
        region_cnt = self.model_config_obj.region_cnt

        surf_mask = self.get_grid_vars(self.tracer_names[0])["region_mask"][0]
        if surf_mask.max() != region_cnt:
            raise RuntimeError("region_cnt_surf != region_cnt")

        # area-weighted gas flux, summed per region with one vectorized bincount
        flux = fptr_hist.var("TAREA")[:] * fptr_hist.var("FG_ABIO_DIC")[:][0, :]
        region_ids = np.where(surf_mask > 0, surf_mask, 0)
        sums = np.bincount(
            region_ids.ravel().astype(np.intp),
            weights=np.where(surf_mask > 0, flux, 0.0).ravel(),
            minlength=region_cnt + 1,
        )[1:]
        res["FG_ABIO_DIC_int_nlat_nlon"] = sums * self._FLUX_TO_PG_PER_YEAR
        return res
