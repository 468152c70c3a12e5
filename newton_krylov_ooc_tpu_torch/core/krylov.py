"""left-preconditioned GMRES for the Newton correction equation.

Solves A x = -fcn, where A is the Jacobian of comp_fcn at the current iterate
(applied via Jacobian-vector products) and M^-1 is the model's preconditioner.
Saad's algorithm 9.4 ("Iterative Methods for Sparse Linear Systems", 2nd ed.):
Arnoldi with modified Gram-Schmidt, the Hessenberg least-squares problem solved
independently per (tracer module, region) -- the framework's block parallelism.

Out-of-core contract (capability parity with nk_ooc/krylov_solver.py): basis
vectors are file-stored, the Hessenberg matrix and beta persist in the step-log
JSON, and every step is resumable.  The port's own copy of
newton_krylov_ooc_tpu/core/krylov.py; the device-resident GMRES of the in-core
solves lives in core/incore.py and ops/gmres.py.
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils.helpers import class_name
from . import state as state_mod
from .solver_base import SolverBase
from .solver_state import action_step_log_wrap


class KrylovSolver(SolverBase):
    """left-preconditioned GMRES with file-stored basis (x0 = 0)"""

    def __init__(self, iterate, solverinfo, resume, rewind, hist_fname):
        logger = logging.getLogger(__name__)

        super().__init__(
            "Krylov",
            solverinfo,
            iterate.model_config_obj.region_cnt,
            resume,
            rewind,
            # the parent Newton solver intent-logs this instantiation before
            # constructing it, so a resume may find no Krylov state file yet
            tolerate_missing_state=True,
        )
        logger.debug('hist_fname="%s"', hist_fname)

        self._iterate = iterate

        self._def_solver_stats_vars(
            self.gen_stats_vars_metadata(), self._iterate.tracer_modules
        )

        iterate.gen_precond_jacobian(
            hist_fname,
            precond_fname=self._fname("precond", iteration=0),
            solver_state=self._solver_state,
        )

    @staticmethod
    def gen_stats_vars_metadata():
        """metadata for Krylov solver stats vars"""
        return {
            "precond_rhs_norm": {
                "category": "per_tracer_module",
                "dimensions": ("region",),
                "attrs": {
                    "long_name": "norm of {tracer_module_name} preconditioned rhs",
                    "units": "{tracer_module_units}",
                },
            },
            "precond_resid_norm": {
                "category": "per_tracer_module",
                "dimensions": ("iteration", "region"),
                "attrs": {
                    "long_name": (
                        "norm of {tracer_module_name} preconditioned residual"
                    ),
                    "units": "{tracer_module_units}",
                },
            },
        }

    def converged(self, beta, precond_resid_norm, iteration=None):
        """(module_cnt, region_cnt) convergence flags:
        ||precond resid|| < rel_tol * beta, after min_iter iterations"""
        rel_tol = self._get_rel_tol()
        if iteration is None:
            iteration = self.get_iteration()
        return (iteration >= self._get_min_iter()) & (
            precond_resid_norm < rel_tol * beta
        )

    @action_step_log_wrap(step="KrylovSolver._solve0", per_iteration=False)
    def _solve0(self, fcn, solver_state):
        """iteration-0 work: r0 = -M^-1 fcn, beta = ||r0||, basis_0 = r0/beta"""
        precond_fcn = fcn.apply_precond_jacobian(
            self._fname("precond", 0), self._fname("precond_fcn"), self._solver_state
        )
        beta = precond_fcn.norm()
        fcn.log_vals("beta", beta)
        self._put_solver_stats_vars_iteration_independent(precond_rhs_norm=beta)
        caller = f"{class_name(self)}._solve0"
        (-precond_fcn / beta).dump(self._fname("basis"), caller)
        self._solver_state.set_value_saved_state("beta", beta)

    def _grown_hessenberg(self, fcn, j_val):
        """the stored Hessenberg matrices, grown by one column/row for
        Arnoldi step j_val: (module_cnt, j+2, j+1, region_cnt)"""
        shape = (
            len(fcn.tracer_modules),
            j_val + 2,
            j_val + 1,
            fcn.model_config_obj.region_cnt,
        )
        h_mat = np.zeros(shape)
        if j_val > 0:
            prev = self._solver_state.get_value_saved_state("h_mat")
            # a crashed attempt of THIS step may have saved the already-grown
            # matrix; slicing by prev's own shape handles both (the last
            # column is recomputed by the Arnoldi step either way)
            h_mat[:, : prev.shape[1], : prev.shape[2], :] = prev
        return h_mat

    def _arnoldi_step(self, fcn, j_val, h_mat):
        """one Arnoldi step: w = M^-1 A basis_j, modified Gram-Schmidt against
        the stored basis, fill Hessenberg column j; returns normalized w"""
        basis_j = type(self._iterate)(self._fname("basis"))
        w_raw = self._iterate.comp_jacobian_fcn_state_prod(
            fcn, basis_j, self._fname("w_raw"), self._solver_state
        )
        w_j = w_raw.apply_precond_jacobian(
            self._fname("precond", 0), self._fname("w"), self._solver_state
        )
        h_mat[:, :-1, -1, :] = w_j.mod_gram_schmidt(j_val + 1, self._fname, "basis")
        h_mat[:, -1, -1, :] = w_j.norm()
        w_j /= h_mat[:, -1, -1, :]
        self._solver_state.set_value_saved_state("h_mat", h_mat)
        return w_j

    def _precond_resid_norm(self, coeff):
        """norm of the preconditioned residual of the least-squares solution:
        ||sum_i coeff_i w_i + M^-1 fcn||, per (module, region)"""
        resid = state_mod.lin_comb(type(self._iterate), coeff, self._fname, "w")
        resid += type(self._iterate)(self._fname("precond_fcn", 0))
        return resid.norm()

    def solve(self, res_fname, fcn):
        """run GMRES until the per-(module, region) residuals converge

        Each loop pass is one committed GMRES iteration: the next basis
        vector is dumped and the residual norm staged BEFORE inc_iteration,
        whose single state-file write commits both together with the counter.
        Convergence is decided at loop entry from that committed state, so a
        crash at any point replays to the identical trajectory (the
        reference decides convergence in flight between inc_iteration and
        the basis dump -- nk_ooc/krylov_solver.py:158-164 --
        which a crash there cannot replay).
        """
        logger = logging.getLogger(__name__)
        logger.debug('res_fname="%s"', res_fname)

        self._solve0(fcn, solver_state=self._solver_state)
        caller = f"{class_name(self)}.solve"
        beta = self._solver_state.get_value_saved_state("beta")

        while True:
            j_val = self.get_iteration()

            if j_val > 0:
                # default None: a state file written before the framework
                # staged this key (or by the stats-only path) falls through
                # to running the pass, which recomputes the residual
                resid_norm = self._solver_state.get_value_saved_state(
                    "precond_resid_norm", None
                )
                if resid_norm is not None and self.converged(beta, resid_norm).all():
                    logger.info("Krylov convergence criterion satisfied")
                    break

            h_mat = self._grown_hessenberg(fcn, j_val)
            w_j = self._arnoldi_step(fcn, j_val, h_mat)

            # least-squares for the Krylov coefficients, per (module, region)
            coeff = comp_krylov_basis_coeffs(beta, h_mat)
            self._iterate.log_vals("KrylovCoeff", coeff)

            res = state_mod.lin_comb(type(self._iterate), coeff, self._fname, "basis")
            res.dump(self._fname("krylov_res", j_val), caller)

            resid_norm = self._precond_resid_norm(coeff)
            self._iterate.log_vals("precond_resid", resid_norm)
            self._put_solver_stats_vars(precond_resid_norm=resid_norm)

            # the next basis vector is only needed if the loop-entry check of
            # the NEXT pass (iteration j_val + 1) will not break; evaluating
            # that predicate here is deterministic, so skipping the dump on
            # the final converging iteration is replay-safe
            if not self.converged(beta, resid_norm, iteration=j_val + 1).all():
                w_j.dump(self._fname("basis", j_val + 1), caller)
            self._solver_state.set_value_saved_state(
                "precond_resid_norm", resid_norm, defer=True
            )
            self._solver_state.inc_iteration()

        res = type(self._iterate)(self._fname("krylov_res", self.get_iteration() - 1))
        return res.dump(res_fname, caller)


def comp_krylov_basis_coeffs(beta, h_mat):
    """
    solve the (j+2) x (j+1) Hessenberg least-squares problem
    min ||beta e1 - H y|| independently per (tracer module, region)

    h_mat: (module_cnt, j+2, j+1, region_cnt); beta: (module_cnt, region_cnt)
    returns coeff: (module_cnt, j+1, region_cnt)
    """
    module_cnt, rows, cols, region_cnt = h_mat.shape
    # batch the small dense systems: (module*region, rows, cols)
    h_batched = np.transpose(h_mat, (0, 3, 1, 2)).reshape(-1, rows, cols)
    rhs = np.zeros((h_batched.shape[0], rows))
    rhs[:, 0] = beta.reshape(-1)
    coeff = np.empty((h_batched.shape[0], cols))
    for ind in range(h_batched.shape[0]):
        coeff[ind] = np.linalg.lstsq(h_batched[ind], rhs[ind], rcond=None)[0]
    return np.transpose(
        coeff.reshape(module_cnt, region_cnt, cols), (0, 2, 1)
    )
