"""iage tracer module for test_problem: ideal age.

Ages at 1 yr/yr, restored to zero at the surface via a piston velocity
(behavioral spec: nk_ooc/test_problem/iage.py).  The preconditioner inverts the
time-mean implicit-mixing operator (tridiagonal Thomas solve).  The port of
newton_krylov_ooc_tpu/models/test_problem/iage.py.
"""

from __future__ import annotations

import numpy as np

from ...ops.tridiag import thomas_solve_np
from . import constants, physics
from .tracer_module_state import TracerModuleState


class iage(TracerModuleState):  # noqa: N801 (module name fixed by the YAML defs)
    """iage tracer module"""

    precond_hist_args = ("mca",)

    @staticmethod
    def build_tend(grid, static_args, params):
        return physics.make_iage_tend(grid)

    def tend_static_args(self):
        return ()

    def tend_params(self):
        return np.zeros(0)

    def apply_precond_jacobian(self, time_range, res_tms, mca):
        """precondition with (mixing + surface restoring - 1/T) Jacobian

        mca: time-log-mean mixing coefficient at interior edges (m^2/s)
        """
        nlev = len(self.depth)
        self_vals = self.get_tracer_vals_all()[0, :]
        rhs = (1.0 / (time_range[1] - time_range[0])) * self_vals

        m = mca * self.depth.delta_mid_r  # mixing coeff / delta_mid
        dr = self.depth.delta_r
        du = np.zeros(nlev)
        dl = np.zeros(nlev)
        d = np.zeros(nlev)
        du[:-1] = m * dr[:-1]
        dl[1:] = m * dr[1:]
        d[:-1] -= m * dr[:-1]
        d[1:] -= m * dr[1:]
        d[0] -= physics.IAGE_PIST_VEL * dr[0]

        res_vals = thomas_solve_np(dl, d, du, rhs)
        res_tms.set_tracer_vals_all((res_vals - self_vals)[np.newaxis, :])


# re-export for precond construction elsewhere
__all__ = ["iage", "constants"]
