"""phosphorus tracer module for test_problem: po4/dop/pop cycling plus shadow
counterparts (behavioral spec: nk_ooc/test_problem/phosphorus.py).

The preconditioner inverts the shadow-triplet Jacobian (a 7-diagonal system:
mixing, remin, sinking, restoring compensation), regularized by an eps-shift
with Richardson extrapolation, then projects out the near-null space via the
smallest singular vector so total shadow phosphorus is conserved.  The port
of newton_krylov_ooc_tpu/models/test_problem/phosphorus.py.
"""

from __future__ import annotations

import numpy as np

from . import constants, physics
from .tracer_module_state import TracerModuleState


class phosphorus(TracerModuleState):  # noqa: N801
    """phosphorus tracer module (6 tracers incl. shadows)"""

    precond_hist_args = ("mca", "po4_s_restore_tau_r")

    def __init__(self, tracer_module_name, fname, model_config_obj, depth):
        self.po4_s_restoring_opt = int(
            model_config_obj.modelinfo["po4_s_restoring_opt"]
        )
        super().__init__(tracer_module_name, fname, model_config_obj, depth)

    @staticmethod
    def build_tend(grid, static_args, params):
        (restoring_opt,) = static_args
        return physics.make_phosphorus_tend(grid, restoring_opt)

    def tend_static_args(self):
        return (self.po4_s_restoring_opt,)

    def tend_params(self):
        return np.zeros(0)

    # -- derived hist vars -------------------------------------------------------

    def hist_vars_metadata_tracer_like(self):
        res = super().hist_vars_metadata_tracer_like()
        po4_units = res["po4"]["attrs"]["units"]
        res["po4_uptake"] = {
            "attrs": {"long_name": "uptake of po4", "units": f"{po4_units} / s"}
        }
        res["po4_s_restore_tau_r"] = {
            "attrs": {
                "long_name": "inverse timescale for po4_s restoring",
                "units": "1 / s",
            }
        }
        return res

    def derived_hist_vals(self, tracer_vals_all):
        ntime = tracer_vals_all.shape[-1]
        uptake = np.empty((len(self.depth), ntime))
        tau_r = np.empty((len(self.depth), ntime))
        for tind in range(ntime):
            po4 = tracer_vals_all[0, :, tind]
            uptake[:, tind] = physics.po4_uptake_np(self.depth, po4)
            tau_r[:, tind] = physics.po4_s_restore_tau_r_np(
                self.depth, po4, uptake[:, tind], self.po4_s_restoring_opt
            )
        return {"po4_uptake": uptake, "po4_s_restore_tau_r": tau_r}

    def stats_vars_tracer_like(self):
        res = super().stats_vars_tracer_like()
        res.append("po4_uptake")
        return res

    # -- preconditioner ---------------------------------------------------------

    def apply_precond_jacobian(self, time_range, res_tms, mca, po4_s_restore_tau_r):
        """apply the shadow-triplet preconditioner (see module docstring)"""
        nlev = len(self.depth)
        dr = self.depth.delta_r
        m = mca * self.depth.delta_mid_r
        remin = 0.01 * constants.day_per_sec
        sink = constants.day_per_sec
        tau_r = po4_s_restore_tau_r

        self_vals = self.get_tracer_vals_all()[3:6, :].reshape(-1)
        rhs = (1.0 / (time_range[1] - time_range[0])) * self_vals

        # single-tracer mixing diagonals
        mix_diag = np.zeros(nlev)
        mix_diag[:-1] -= m * dr[:-1]
        mix_diag[1:] -= m * dr[1:]
        mix_sup = m * dr[:-1]  # a[i, i+1]
        mix_sub = m * dr[1:]   # a[i+1, i]

        matrix = np.zeros((3 * nlev, 3 * nlev))

        def block(i, j):
            return matrix[i * nlev : (i + 1) * nlev, j * nlev : (j + 1) * nlev]

        for b in range(3):
            blk = block(b, b)
            blk[np.arange(nlev), np.arange(nlev)] += mix_diag
            blk[np.arange(nlev - 1), np.arange(1, nlev)] += mix_sup
            blk[np.arange(1, nlev), np.arange(nlev - 1)] += mix_sub

        # po4_s restoring and its compensation (conserves total shadow P)
        block(0, 0)[np.arange(nlev), np.arange(nlev)] -= tau_r
        block(1, 0)[np.arange(nlev), np.arange(nlev)] += 0.67 * tau_r
        block(2, 0)[np.arange(nlev), np.arange(nlev)] += 0.33 * tau_r

        # remineralization
        block(0, 1)[np.arange(nlev), np.arange(nlev)] += remin
        block(1, 1)[np.arange(nlev), np.arange(nlev)] -= remin
        block(0, 2)[np.arange(nlev), np.arange(nlev)] += remin
        block(2, 2)[np.arange(nlev), np.arange(nlev)] -= remin

        # pop_s sinking (loss to layer below; gain from layer above)
        pop_blk = block(2, 2)
        pop_blk[np.arange(nlev - 1), np.arange(nlev - 1)] -= sink * dr[:-1]
        pop_blk[np.arange(1, nlev), np.arange(nlev - 1)] += sink * dr[1:]

        # regularize + Richardson extrapolation toward zero shift
        eye = np.eye(3 * nlev)
        res_a = np.linalg.solve(matrix - 1.0e-11 * eye, rhs)
        res_b = np.linalg.solve(matrix - 0.5e-11 * eye, rhs)
        res_vals = 2.0 * res_b - res_a

        # project out the near-null space, weighting by layer thickness so the
        # total (volume-integrated) shadow phosphorus correction vanishes
        _, sing_vals, r_sing_vects = np.linalg.svd(matrix)
        min_ind = int(np.argmin(sing_vals))
        dz3 = np.tile(self.depth.delta, 3)
        numer = (res_vals * dz3).sum()
        denom = (r_sing_vects[min_ind, :] * dz3).sum()
        res_vals -= numer / denom * r_sing_vects[min_ind, :]

        res_vals -= self_vals
        res_tms.set_tracer_vals("po4_s", res_vals[0:nlev])
        res_tms.set_tracer_vals("dop_s", res_vals[nlev : 2 * nlev])
        res_tms.set_tracer_vals("pop_s", res_vals[2 * nlev : 3 * nlev])
