"""Armijo-globalized Newton's method for F(X) = 0.

Outer loop of the framework (capability parity with nk_ooc/newton_solver.py):
each iteration computes a Newton increment via the Krylov solver, limits it to
keep tracers within bounds, backtracks the step (Armijo condition, Kelley 2003
eq. A.1, per tracer module and region), copies shadow tracers onto their real
counterparts, and finishes with optional fixed-point iterations.  Convergence:
||F|| < newton_rel_tol * ||X|| per (module, region).

All actions are step-logged so a solve survives arbitrary interruption (the
out-of-core contract); step strings match the reference's on-disk trace format
so committed Newton_state.json baselines diff cleanly.  The port's own copy
of newton_krylov_ooc_tpu/core/newton.py.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..utils.helpers import class_name, fmt_vals
from .krylov import KrylovSolver
from .solver_base import SolverBase
from .solver_state import action_step_log_wrap

ARMIJO_ALPHA = 1.0e-4
ARMIJO_MAX_IND = 10

# declarative description of the solver's stats variables; the "model_state"
# category expands into mean+norm vars per tracer module, "per_tracer_module"
# into one var per module
_STATS_TABLE = {
    "iterate": ("model_state", "{method} of {tracer_module_name} Newton iterate"),
    "fcn": ("model_state", "{method} of {tracer_module_name} Newton fcn"),
    "increment": (
        "model_state",
        "{method} of {tracer_module_name} Newton increment",
    ),
    "increment_scalef": (
        "per_tracer_module",
        "factor applied to {tracer_module_name} Newton increment to satisfy "
        "bounds",
    ),
    "Armijo_factor": (
        "per_tracer_module",
        "factor applied to {tracer_module_name} Newton increment to satisfy "
        "Armijo condition",
    ),
}


class NewtonSolver(SolverBase):
    """Newton's method with Armijo backtracking and bounds limiting"""

    def __init__(self, model_state_class, solverinfo, resume, rewind):
        # the reference silently never advances its iteration counter when
        # post_newton_fp_iter < 1 (nk_ooc/newton_solver.py:302-324 -- the fp
        # loop is where inc_iteration lives), so a driver loop spins forever;
        # fail loudly instead
        if int(solverinfo["post_newton_fp_iter"]) < 1:
            raise ValueError(
                "post_newton_fp_iter must be >= 1 (the Newton iteration "
                "advances inside the fixed-point phase)"
            )
        region_cnt = model_state_class.model_config_obj.region_cnt
        super().__init__("Newton", solverinfo, region_cnt, resume, rewind)

        self._iterate = self._init_iterate_state(model_state_class)

        self._def_solver_stats_vars(
            self.gen_stats_vars_metadata(), self._iterate.tracer_modules
        )

        fcn_start = time.time()
        self._fcn = self._iterate.comp_fcn(
            self._fname("fcn"), self._solver_state, self._fname("hist")
        )
        self._put_solver_stats_vars(iterate=self._iterate, fcn=self._fcn)
        self._put_observability_vars(comp_fcn_seconds=time.time() - fcn_start)
        self._init_model_stats_vars()

    def _init_iterate_state(self, model_state_class):
        """load iterate 0, creating it from the configured initial iterate
        (with shadow tracers seeded from their real counterparts) on first run"""
        step = "Newton iterate 0 written"
        if self._solver_state.step_logged(step, per_iteration=False):
            return model_state_class(self._fname("iterate"))
        iterate = model_state_class(self._solverinfo["init_iterate_fname"])
        iterate.copy_real_tracers_to_shadow_tracers()
        iterate.dump(self._fname("iterate"), f"{class_name(self)}.__init__")
        self._solver_state.log_step(step, per_iteration=False)
        return iterate

    def _init_model_stats_vars(self):
        """define + seed the model-specific stats variables"""
        for method in (
            self._iterate.def_stats_vars,
            self._iterate.put_stats_vars_iteration_invariant,
            self._iterate.put_stats_vars,
        ):
            method(
                self._stats_file,
                self._fname("hist"),
                solver_state=self._solver_state,
            )

    @staticmethod
    def gen_stats_vars_metadata():
        """metadata for Newton solver stats vars (expanded from _STATS_TABLE)"""
        vars_metadata = {}
        for key, (category, long_name) in _STATS_TABLE.items():
            units = (
                "{tracer_module_units}" if category == "model_state" else "1"
            )
            entry = {
                "category": category,
                "dimensions": ("iteration", "region"),
                "attrs": {"long_name": long_name, "units": units},
            }
            if category == "model_state":
                entry = fmt_vals(
                    entry,
                    {
                        "method": "{method}",
                        "tracer_module_name": "{tracer_module_name}",
                        "tracer_module_units": "{tracer_module_units}",
                    },
                )
            vars_metadata[key] = entry
        vars_metadata["Krylov_iterations"] = {
            "category": "tracer_module_independent",
            "datatype": "i4",
            "dimensions": ("iteration",),
            "attrs": {
                "long_name": "number of iterations in Krylov solver",
                "units": "1",
            },
        }
        vars_metadata["comp_fcn_seconds"] = {
            "category": "tracer_module_independent",
            "dimensions": ("iteration",),
            "attrs": {
                "long_name": "wall-clock of the iteration's final function "
                "evaluation in this process (device time for in-core "
                "models; ~0 when replayed from the step log on resume)",
                "units": "seconds",
            },
        }
        return vars_metadata

    # -- logging / convergence ---------------------------------------------------

    def log(self, iterate=None, fcn=None, msg=None):
        """write current iterate/fcn diagnostics to the log"""
        prefix = f"iteration={self.get_iteration():02}"
        if msg is not None:
            prefix = f"{prefix},{msg}"
        (iterate if iterate is not None else self._iterate).log(f"{prefix},iterate")
        (fcn if fcn is not None else self._fcn).log(f"{prefix},fcn")

    def converged(self):
        """(module_cnt, region_cnt) convergence flags"""
        if self.get_iteration() < self._get_min_iter():
            return np.zeros_like(self._fcn.norm(), dtype=bool)
        return self._fcn.norm() < self._get_rel_tol() * self._iterate.norm()

    # -- Newton increment (via the Krylov solver) --------------------------------

    def _comp_increment(self):
        """solve (dF/dX) increment = -F"""
        logger = logging.getLogger(__name__)
        logger.debug("entering")

        done_step = "_comp_increment complete"
        if self._solver_state.step_logged(done_step):
            logger.debug('"%s" logged, returning result', done_step)
            return type(self._iterate)(self._fname("increment"))
        logger.debug('"%s" not logged, computing increment', done_step)

        self._solverinfo["krylov_workdir"] = os.path.join(
            self._get_workdir(), f"krylov_{self.get_iteration():02}"
        )
        inst_step = "KrylovSolver instantiated"
        krylov_rewind = self._solver_state.step_was_rewound(inst_step)
        krylov_resume = krylov_rewind or self._solver_state.step_logged(inst_step)
        if not krylov_resume:
            self.log()
        # intent logging: record the instantiation BEFORE constructing the
        # sub-solver, so a crash anywhere inside the Krylov solve replays
        # with krylov_resume=True (computed above, before this append) and
        # picks up the partial Krylov progress instead of wiping it.  On a
        # genuinely fresh Newton run krylov_resume stays False, so stale
        # Krylov state left in a reused workdir is reset, not adopted.  The
        # Newton step-log content is unchanged -- construction appends only
        # to the Krylov state -- so traces stay byte-identical.
        self._solver_state.log_step(inst_step)
        krylov = KrylovSolver(
            self._iterate,
            self._solverinfo,
            krylov_resume,
            krylov_rewind,
            self._fname("hist"),
        )

        increment = krylov.solve(self._fname("increment"), self._fcn)
        self._put_solver_stats_vars(
            Krylov_iterations=krylov.get_iteration(), increment=increment
        )
        self._solver_state.log_step(done_step)
        increment.log(f"Newton increment {self.get_iteration():02}")
        return increment

    # -- Armijo backtracking --------------------------------------------------------

    @action_step_log_wrap(step="NewtonSolver._armijo_init")
    def _armijo_init(self, solver_state):
        """seed the backtracking state (factor 0 where already converged)"""
        solver_state.set_value_saved_state(key="armijo_ind", value=0)
        solver_state.set_value_saved_state(
            key="armijo_factor", value=np.where(self.converged(), 0.0, 1.0)
        )

    def _comp_next_iterate(self, increment):
        """halve the step per (module, region) until the residual decreases"""
        logger = logging.getLogger(__name__)
        logger.debug("entering")

        self._armijo_init(solver_state=self._solver_state)
        get_saved = self._solver_state.get_value_saved_state
        ind = get_saved(key="armijo_ind")
        factor = get_saved(key="armijo_factor")

        done_step = "_comp_next_iterate complete"
        if self._solver_state.step_logged(done_step):
            logger.debug('"%s" logged, returning result', done_step)
            # a crash can land between done_step and the stats write below;
            # re-put here (idempotent: the put skips once its own step logs)
            self._put_solver_stats_vars(Armijo_factor=factor)
            state_type = type(self._iterate)
            return (
                state_type(self._fname(f"prov_Armijo_{ind:02}")),
                state_type(self._fname(f"prov_fcn_Armijo_{ind:02}")),
            )
        logger.debug('"%s" not logged, proceeding', done_step)

        caller = f"{class_name(self)}._comp_next_iterate"
        fcn_norm = self._fcn.norm()

        while ind <= ARMIJO_MAX_IND:
            prov = self._iterate + factor * increment
            prov.dump(self._fname(f"prov_Armijo_{ind:02}"), caller)
            prov_fcn = prov.comp_fcn(
                self._fname(f"prov_fcn_Armijo_{ind:02}"),
                self._solver_state,
                self._fname(f"prov_hist_Armijo_{ind:02}"),
            )

            # only the latest Armijo hist file is kept
            if ind > 0:
                os.remove(self._fname(f"prov_hist_Armijo_{(ind - 1):02}"))

            logger.info("Armijo_ind=%d", ind)

            prov_fcn_norm = prov_fcn.norm()
            increment.log_vals(
                ["ArmijoFactor", "fcn_norm", "prov_fcn_norm"],
                np.stack((factor, fcn_norm, prov_fcn_norm)),
            )
            # sufficient decrease, eq. (A.1) of Kelley 2003
            satisfied = (factor == 0.0) | (
                prov_fcn_norm <= (1.0 - ARMIJO_ALPHA * factor) * fcn_norm
            )

            if satisfied.all():
                logger.info("Armijo condition satisfied")
                self._solver_state.log_step(done_step)
                self._put_solver_stats_vars(Armijo_factor=factor)
                return prov, prov_fcn

            logger.info("Armijo condition not satisfied")
            factor = np.where(satisfied, factor, 0.5 * factor)
            ind += 1
            self._solver_state.set_value_saved_state(key="armijo_ind", value=ind)
            self._solver_state.set_value_saved_state(
                key="armijo_factor", value=factor
            )

        raise RuntimeError("Armijo_ind exceeds limit")

    # -- one Newton step ----------------------------------------------------------

    def step(self):
        """increment -> limit -> backtrack -> shadow copy -> fixed-point iters"""
        logger = logging.getLogger(__name__)
        logger.debug("entering")

        if self.get_iteration() >= int(self._solverinfo["newton_max_iter"]):
            self.log()
            raise RuntimeError("number of maximum Newton iterations exceeded")

        prov, prov_fcn, fp_iter = self._start_fp_phase()
        prov, prov_fcn = self._run_fp_iters(prov, prov_fcn, fp_iter)

        self._iterate = prov
        self._fcn = prov_fcn

        self._put_solver_stats_vars(iterate=self._iterate, fcn=self._fcn)
        self._iterate.put_stats_vars(
            self._stats_file,
            hist_fname=self._fname("hist"),
            solver_state=self._solver_state,
        )

    def _start_fp_phase(self):
        """produce the provisional iterate entering the fixed-point phase"""
        caller = f"{class_name(self)}.step"
        state = self._solver_state
        state_type = type(self._iterate)

        step = "fp iterations started"
        if state.step_logged(step):
            fp_iter = state.get_value_saved_state(key="fp_iter")
            return (
                state_type(self._fname(f"prov_fp_{fp_iter:02}")),
                state_type(self._fname(f"prov_fcn_fp_{fp_iter:02}")),
                fp_iter,
            )

        increment = self._comp_increment()
        scalef = increment.apply_limiter(self._iterate)
        self._put_solver_stats_vars(increment_scalef=scalef)

        prov, prov_fcn = self._comp_next_iterate(increment)

        fp_iter = 0
        state.set_value_saved_state(key="fp_iter", value=fp_iter)
        prov.copy_shadow_tracers_to_real_tracers()
        prov.dump(self._fname(f"prov_fp_{fp_iter:02}"), caller)

        # With shadow tracers on, comp_fcn must be re-evaluated after the
        # shadow copy.  Without them, the final Armijo evaluation already is
        # the fp-0 function value, so it is reused (and the Armijo hist file
        # renamed into the fp slot) instead of paying another model run.
        armijo_ind = state.get_value_saved_state(key="armijo_ind")
        last_armijo_hist = self._fname(f"prov_hist_Armijo_{armijo_ind:02}")
        if prov.shadow_tracers_on():
            prov_fcn = prov.comp_fcn(
                self._fname(f"prov_fcn_fp_{fp_iter:02}"),
                state,
                self._fname(f"prov_hist_fp_{fp_iter:02}"),
            )
            os.remove(last_armijo_hist)
        else:
            prov_fcn.dump(self._fname(f"prov_fcn_fp_{fp_iter:02}"), caller)
            os.rename(last_armijo_hist, self._fname(f"prov_hist_fp_{fp_iter:02}"))
        state.log_step(step)
        return prov, prov_fcn, fp_iter

    def _run_fp_iters(self, prov, prov_fcn, fp_iter):
        """post-Newton fixed-point iterations X <- X + F(X); the final one
        advances the Newton iteration and writes iterate/fcn/hist"""
        caller = f"{class_name(self)}.step"
        state = self._solver_state
        fp_total = int(self._solverinfo["post_newton_fp_iter"])

        while fp_iter < fp_total:
            step = f"prov updated for fp iteration {fp_iter:02}"
            if state.step_logged(step):
                prov = type(self._iterate)(
                    self._fname(f"prov_fp_{(fp_iter + 1):02}")
                )
            else:
                if fp_iter == 0:
                    self.log(prov, prov_fcn, "pre-fp_iter")
                prov += prov_fcn
                prov.copy_shadow_tracers_to_real_tracers()
                prov.dump(self._fname(f"prov_fp_{(fp_iter + 1):02}"), caller)
                state.log_step(step)

            final = fp_iter + 1 >= fp_total
            if final:
                # dump the new iterate BEFORE committing the iteration: a
                # crash between the two leaves the counter advanced but the
                # iterate file missing, which a resume cannot repair
                prov.dump(self._fname("iterate", state.get_iteration() + 1), caller)
                state.inc_iteration()
                res_fname = self._fname("fcn")
                hist_fname = self._fname("hist")
            else:
                res_fname = self._fname(f"prov_fcn_fp_{(fp_iter + 1):02}")
                hist_fname = self._fname(f"prov_hist_fp_{(fp_iter + 1):02}")
            fcn_start = time.time()
            prov_fcn = prov.comp_fcn(res_fname, state, hist_fname)
            if final:
                # per-step device-time observability: for in-core models
                # this wall-clock IS the model-year device time (plus
                # dispatch); logged-and-replayed evaluations record ~0
                self._put_observability_vars(
                    comp_fcn_seconds=time.time() - fcn_start
                )
            fp_iter += 1
            state.set_value_saved_state(key="fp_iter", value=fp_iter)
            self.log(prov, prov_fcn, f"fp_iter={fp_iter:02}")

        return prov, prov_fcn
