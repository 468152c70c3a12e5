"""shared infrastructure for the Newton and Krylov solvers: workdir/filename
conventions, tolerances, and stats-var plumbing.

Capability parity: nk_ooc/solver_base.py.  The port's own copy of
newton_krylov_ooc_tpu/core/solver_base.py.
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils.helpers import fmt_vals
from ..utils.ncio import mkdir_exist_okay
from .solver_state import SolverState
from .stats import StatsFile


class SolverBase:
    """base class for iterative solvers with resumable state and stats files"""

    def __init__(
        self,
        solver_name,
        solverinfo,
        region_cnt,
        resume,
        rewind,
        tolerate_missing_state=False,
    ):
        logger = logging.getLogger(__name__)
        logger.debug(
            'solver_name="%s", resume="%r", rewind="%r"', solver_name, resume, rewind
        )

        self._solver_name = solver_name
        self._solverinfo = solverinfo

        workdir = self._get_workdir()
        logger.debug('%s solver workdir="%s"', solver_name, workdir)
        mkdir_exist_okay(workdir)

        self._solver_state = SolverState(
            solver_name,
            workdir,
            resume,
            rewind,
            tolerate_missing=tolerate_missing_state,
        )
        self._stats_file = StatsFile(
            solver_name, workdir, region_cnt, self._solver_state
        )
        self._stats_vars_put_metadata = {}

    # -- conventions ----------------------------------------------------------

    def get_iteration(self):
        return self._solver_state.get_iteration()

    def _solverinfo_key(self, suffix, default=None):
        """solver-name-prefixed solverinfo lookup with optional fallback"""
        key = f"{self._solver_name}_{suffix}"
        if key in self._solverinfo:
            return self._solverinfo[key]
        return default

    def _get_workdir(self):
        workdir = self._solverinfo_key("workdir")
        return workdir if workdir is not None else self._solverinfo["workdir"]

    def _fname(self, quantity, iteration=None):
        """workdir filename for a quantity at an iteration"""
        if iteration is None:
            iteration = self.get_iteration()
        return f"{self._get_workdir()}/{quantity}_{iteration:02}.nc"

    def _get_rel_tol(self):
        return float(self._solverinfo_key("rel_tol"))

    def _get_min_iter(self):
        return int(self._solverinfo_key("min_iter", default=0))

    # -- stats-var plumbing -----------------------------------------------------
    #
    # categories:
    #   model_state: one mean + one norm var per tracer module
    #   per_tracer_module: one var per tracer module
    #   tracer_module_independent: a single var

    def _def_solver_stats_vars(self, stats_vars_dict, tracer_modules):
        """define solver stats vars, caching the put-time expansion"""
        vars_def_metadata = {}

        def expand(key, metadata, method=None):
            """per-module expansion of one stats-var template"""
            names = []
            for tracer_module in tracer_modules:
                repl = {
                    "tracer_module_name": tracer_module.name,
                    "tracer_module_units": tracer_module.units,
                }
                if method is not None:
                    repl["method"] = method
                    varname = f"{key}_{method}_{tracer_module.name}"
                else:
                    varname = f"{key}_{tracer_module.name}"
                expanded = fmt_vals(metadata, repl)
                if expanded["attrs"].get("units") == "None":
                    expanded["attrs"]["units"] = None
                vars_def_metadata[varname] = expanded
                names.append(varname)
            return names

        for key, metadata in stats_vars_dict.items():
            dimensions = metadata["dimensions"]
            if "iteration" in dimensions and dimensions[0] != "iteration":
                raise ValueError("iteration must be first dimension, if present")
            category = metadata["category"]
            entry = {"category": category, "dimensions": dimensions}
            if category == "model_state":
                entry["stats_varnames"] = {
                    method: expand(key, metadata, method)
                    for method in ("mean", "norm")
                }
            elif category == "per_tracer_module":
                entry["stats_varnames"] = expand(key, metadata)
            elif category == "tracer_module_independent":
                vars_def_metadata[key] = metadata
            else:
                raise ValueError(f"unknown category {category}")
            self._stats_vars_put_metadata[key] = entry

        # step-logged so vars are not redefined on resume
        step = f"define {self._solver_name} solver stats file vars"
        if not self._solver_state.step_logged(step, per_iteration=False):
            self._stats_file.def_vars(vars_def_metadata)
        self._solver_state.log_step(step, per_iteration=False)

    def _collect_stats_vals(self, kwargs, per_iteration):
        """expand put kwargs into a {varname: value} dict

        returns (vals_dict, pending_steps); the caller logs pending_steps
        AFTER the stats-file write so the step log stays write-ahead (a step
        reading as done implies its values are durable in the stats file)
        """
        vals_dict = {}
        pending_steps = []
        for key, vals in kwargs.items():
            put_metadata = self._stats_vars_put_metadata[key]
            has_iter_dim = "iteration" in put_metadata["dimensions"]
            if has_iter_dim != per_iteration:
                which = (
                    "_put_solver_stats_vars"
                    if has_iter_dim
                    else "_put_solver_stats_vars_iteration_independent"
                )
                raise ValueError(f"{which} should be used for {key}")
            step = f"write {key} vals to stats file"
            if self._solver_state.step_logged(step, per_iteration):
                continue
            category = put_metadata["category"]
            if category == "model_state":
                for method, reducer in (("mean", vals.mean), ("norm", vals.norm)):
                    reduced = reducer()
                    for ind, varname in enumerate(
                        put_metadata["stats_varnames"][method]
                    ):
                        vals_dict[varname] = reduced[ind]
            elif category == "per_tracer_module":
                arr = np.asarray(vals)
                for ind, varname in enumerate(put_metadata["stats_varnames"]):
                    vals_dict[varname] = arr[ind]
            elif category == "tracer_module_independent":
                vals_dict[key] = vals
            else:
                raise ValueError(f"unknown category {category}")
            pending_steps.append(step)
        return vals_dict, pending_steps

    def _put_solver_stats_vars_iteration_independent(self, **kwargs):
        """write values of vars lacking the iteration dimension"""
        vals_dict, pending = self._collect_stats_vals(kwargs, per_iteration=False)
        self._stats_file.put_vars_iteration_invariant(vals_dict)
        for step in pending:
            self._solver_state.log_step(step, per_iteration=False)

    def _put_solver_stats_vars(self, **kwargs):
        """write values of per-iteration vars at the current iteration"""
        vals_dict, pending = self._collect_stats_vals(kwargs, per_iteration=True)
        self._stats_file.put_vars(self.get_iteration(), vals_dict)
        for step in pending:
            self._solver_state.log_step(step, per_iteration=True)

    def _put_observability_vars(self, **kwargs):
        """write per-iteration observability scalars (timings etc.) WITHOUT
        step-logging: these values are not replayable (a resumed run would
        measure something different anyway) and must not perturb the step
        log, whose byte-identity against committed baselines is load-bearing
        (scripts/ci_*.sh diff Newton_state.json).

        Best-effort by design: a resumed run whose stats file predates a
        newly added observability variable skips the write (the define step
        is step-logged, so the variable does not exist in the old file) --
        observability must never abort a solve."""
        try:
            self._stats_file.put_vars(self.get_iteration(), kwargs)
        except KeyError:
            import logging

            logging.getLogger(__name__).debug(
                "observability vars %s absent from the stats file "
                "(pre-existing run); skipped", sorted(kwargs)
            )
