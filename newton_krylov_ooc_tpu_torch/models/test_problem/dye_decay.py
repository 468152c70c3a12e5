"""dye_decay_{suff} tracer modules for test_problem: pulsed surface dye input
with first-order decay at (suff/1000)/yr.

Parameterized family (behavioral spec: nk_ooc/test_problem/dye_decay.py); the
decay rate is read from a parameter tensor, so all instantiated modules share
one integrator (and one captured CUDA graph).  The port of
newton_krylov_ooc_tpu/models/test_problem/dye_decay.py.
"""

from __future__ import annotations

import numpy as np

from ...ops.tridiag import thomas_solve_np
from . import constants, physics
from .tracer_module_state import TracerModuleState


class dye_decay(TracerModuleState):  # noqa: N801
    """dye_decay_{suff} tracer module; decay rate parsed from the suffix"""

    precond_hist_args = ("mca",)

    @property
    def decay_rate_per_year(self):
        # module name is dye_decay_{suff}; rate is suff/1000 per year
        suff = self.name[len("dye_decay_"):]
        return int(suff) * 0.001

    @staticmethod
    def build_tend(grid, static_args, params):
        # params[0] = decay rate per year (set in place before each year)
        def tend(time, vals_flat):
            base = physics.make_dye_decay_tend(grid, 0.0)(time, vals_flat)
            return base - params[0] * constants.year_per_sec * vals_flat

        return tend

    def tend_static_args(self):
        return ()

    def tend_params(self):
        return np.array([self.decay_rate_per_year])

    def apply_precond_jacobian(self, time_range, res_tms, mca):
        """precondition with (mixing + decay - 1/T) Jacobian (tridiagonal)"""
        nlev = len(self.depth)
        self_vals = self.get_tracer_vals_all()[0, :]
        rhs = (1.0 / (time_range[1] - time_range[0])) * self_vals

        m = mca * self.depth.delta_mid_r
        dr = self.depth.delta_r
        du = np.zeros(nlev)
        dl = np.zeros(nlev)
        d = np.zeros(nlev)
        du[:-1] = m * dr[:-1]
        dl[1:] = m * dr[1:]
        d[:-1] -= m * dr[:-1]
        d[1:] -= m * dr[1:]
        d -= self.decay_rate_per_year * constants.year_per_sec

        res_vals = thomas_solve_np(dl, d, du, rhs)
        res_tms.set_tracer_vals_all((res_vals - self_vals)[np.newaxis, :])
