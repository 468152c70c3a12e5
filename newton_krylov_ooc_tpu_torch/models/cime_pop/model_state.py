"""cime_pop model state: the externally-run HPC workload.

comp_fcn stages the tracer initial condition into the model's run directory,
configures the CIME case, installs a POSTRUN hook that re-invokes the solver,
submits the batch job and exits the process (the defining out-of-core
behavior).  On re-invocation the step log fast-forwards here, the history file
is generated by natively time-averaging the model's tavg output, and
F = restart - initial condition.

Preconditioning builds explicit sparse transport matrices from
impulse-response-function (IRF) output (external `gen_A`-compatible tool, or
any drop-in) and solves the distributed systems either with the configured
MPI `solve_ABdist` command or with the on-device sparse path
(`precond_solver_mode=device`), with batch-resource sizing from per-matrix
task-count/memory tables.  Behavioral spec: nk_ooc/cime_pop/model_state.py.

The port of newton_krylov_ooc_tpu/models/cime_pop/model_state.py.  The
on-device solves (ops/sparse.py, parallel/sharded_sparse.py) run on
modelinfo's `device`: the card unless the caller asks for the CPU
(setup_solver's and nk_driver's --device); without a card "cuda" raises.

The step-log strings written here (and the `lin_eqns_soln_` intermediate
filename they embed) are load-bearing: they must match the reference's
on-disk trace format so existing solver-state files resume cleanly and
committed Newton_state.json baselines diff byte-identically.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import shutil
import stat
import subprocess
import textwrap
from datetime import datetime

from ...core.state import ModelState as ModelStateBase
from ...core.solver_state import action_step_log_wrap
from ...ops.compute import resolve_device
from ...utils.helpers import class_name
from ...utils.ncio import NCFile
from ...utils.ncmean import ann_files_to_mean_file, mon_files_to_mean_file
from ..external.cime import (
    cime_case_submit,
    cime_xmlchange,
    cime_xmlquery,
    cime_yr_cnt,
    get_pop_nl_var,
    pop_nl_var_exists,
)

_logger = logging.getLogger(__name__)


def _run_logged(cmd, **kwargs):
    """subprocess.run with the command echoed to the log first"""
    _logger.info('cmd="%s"', " ".join(cmd))
    return subprocess.run(cmd, check=True, **kwargs)


class ModelState(ModelStateBase):
    """cime_pop model state"""

    __array_priority__ = 100

    def __init__(self, fname):
        if ModelState.model_config_obj is None:
            raise RuntimeError("ModelState.model_config_obj is None")
        super().__init__(fname)

    @property
    def _modelinfo(self):
        return self.model_config_obj.modelinfo

    def _solve_opts_by_matrix(self):
        """{matrix_name: solve-opts dict for the case's ocean grid}"""
        defs = self.model_config_obj.precond_matrix_defs
        ocn_grid = cime_xmlquery(self._modelinfo["caseroot"], "OCN_GRID")
        return {
            name: defs[name]["precond_matrices_solve_opts"][ocn_grid]
            for name in self.precond_matrix_list()
        }

    # -- preconditioner-input generation ------------------------------------------

    @action_step_log_wrap(
        step="ModelStateBase.gen_precond_jacobian {precond_fname}", per_iteration=False
    )
    def gen_precond_jacobian(self, hist_fname, precond_fname, solver_state):
        """extract precond hist vars, then build the sparse transport matrices"""
        _logger.debug('hist_fname="%s", precond_fname="%s"', hist_fname, precond_fname)

        # the decorator above owns the step logging; call the base
        # implementation undecorated so it does not double-log
        ModelStateBase.gen_precond_jacobian.__wrapped__(
            self, hist_fname, precond_fname=precond_fname, solver_state=None
        )
        self._gen_precond_matrix_files(precond_fname)

    def _gen_precond_matrix_files(self, precond_fname):
        """run the matrix-generation tool (gen_A-compatible) per precond matrix"""
        modelinfo = self._modelinfo
        gen_a_exe = os.path.join(
            modelinfo["jacobian_precond_tools_dir"], "bin", "gen_A"
        )
        workdir = os.path.dirname(precond_fname)

        # {key} placeholders available to precond_matrices_opts in the defs
        subs = {
            "day_cnt": 365 * cime_yr_cnt(modelinfo),
            "precond_fname": precond_fname,
            "reg_fname": modelinfo["grid_vars_fname"],
            "irf_fname": modelinfo["irf_fname"],
        }

        defs = self.model_config_obj.precond_matrix_defs
        for matrix_name in self.precond_matrix_list():
            opts = [
                opt.format(**subs)
                for opt in defs[matrix_name]["precond_matrices_opts"]
            ]
            opts_fname = os.path.join(workdir, f"matrix_{matrix_name}.opts")
            with open(opts_fname, "w") as fptr:
                fptr.write("\n".join(opts) + "\n")

            matrix_fname = os.path.join(workdir, f"matrix_{matrix_name}.nc")
            _run_logged([gen_a_exe, "-D1", "-o", opts_fname, matrix_fname])

            with NCFile(matrix_fname, mode="a") as fptr:
                stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                fptr.prepend_history(
                    f"{stamp}: created by {gen_a_exe} called from "
                    f"{class_name(self)}._gen_precond_matrix_files"
                )
                fptr.setncattr("matrix_opts", "\n".join(opts))

    # -- comp_fcn -----------------------------------------------------------------

    def comp_fcn(self, res_fname, solver_state, hist_fname=None):
        """F(X) via one batch-submitted forward model run"""
        _logger.debug('res_fname="%s", hist_fname="%s"', res_fname, hist_fname)

        done = f"comp_fcn complete for {res_fname}"
        if solver_state.step_logged(done):
            _logger.debug("step %r already in the log; loading its result", done)
            return type(self)(res_fname)

        # submit-and-exit happens inside (first pass); on re-invocation the
        # step log skips straight past it to the hist/diff stages
        self._comp_fcn_pre_modelrun(res_fname=res_fname, solver_state=solver_state)

        _gen_hist(self._modelinfo, hist_fname)

        ms_res = self._comp_fcn_post_modelrun()
        ms_res.comp_fcn_postprocess(res_fname, f"{class_name(self)}.comp_fcn")

        solver_state.log_step(done)
        return ms_res

    @action_step_log_wrap("_comp_fcn_pre_modelrun for {res_fname}", post_exit=True)
    def _comp_fcn_pre_modelrun(self, res_fname, solver_state):
        """stage IC, configure the case, install the POSTRUN hook, submit, exit"""
        _logger.debug('res_fname="%s"', res_fname)

        modelinfo = self._modelinfo
        caseroot = modelinfo["caseroot"]
        rundir = cime_xmlquery(caseroot, "RUNDIR")

        # the model reads its tracer IC from a rundir-relative path
        ic_rel = "tracer_ic.nc"
        self.dump(
            os.path.join(rundir, ic_rel), f"{__name__}._comp_fcn_pre_modelrun"
        )
        cime_xmlchange(caseroot, "POP_PASSIVE_TRACER_RESTART_OVERRIDE", ic_rel)
        cime_xmlchange(caseroot, "CONTINUE_RUN", "FALSE")

        # seed the rundir with the reference restart pointers
        for src in glob.glob(os.path.join(modelinfo["rpointer_dir"], "rpointer.*")):
            shutil.copy(src, rundir)

        hook_fname = os.path.join(solver_state.get_workdir(), "post_modelrun.sh")
        _gen_post_modelrun_script(modelinfo, hook_fname)
        cime_xmlchange(caseroot, "POSTRUN_SCRIPT", hook_fname)

        for xml_varname in ("STOP_OPTION", "STOP_N", "RESUBMIT"):
            cime_xmlchange(caseroot, xml_varname, modelinfo[xml_varname])

        cime_case_submit(modelinfo)
        _logger.debug("submitted; the decorator exits this process next")

    def _comp_fcn_post_modelrun(self):
        """F = end-of-run restart state - initial state"""
        rundir = cime_xmlquery(self._modelinfo["caseroot"], "RUNDIR")
        with open(os.path.join(rundir, "rpointer.ocn.restart")) as fptr:
            restart_rel = fptr.readline().strip()
        return type(self)(os.path.join(rundir, restart_rel)) - self

    # -- preconditioner application -----------------------------------------------

    def apply_precond_jacobian(self, precond_fname, res_fname, solver_state):
        """distributed sparse solves of the assembled precond matrices"""
        _logger.debug('precond_fname="%s", res_fname="%s"', precond_fname, res_fname)

        done = f"apply_precond_jacobian complete for {res_fname}"
        if solver_state.step_logged(done):
            _logger.debug("step %r already in the log; loading its result", done)
            return type(self)(res_fname)

        self._apply_precond_jacobian_pre_solve_lin_eqns(res_fname, solver_state)

        soln_fname = os.path.join(
            os.path.dirname(res_fname),
            f"lin_eqns_soln_{os.path.basename(res_fname)}",
        )
        ms_res = self._apply_precond_jacobian_solve_lin_eqns(
            precond_fname, soln_fname, solver_state
        )

        # the preconditioner returns a correction: M^-1 r - r
        ms_res -= self

        # dump BEFORE logging completion: the step log is a write-ahead log,
        # so the result file must be durable when the step reads as done
        res = ms_res.dump(
            res_fname, f"{class_name(self)}.apply_precond_jacobian"
        )
        solver_state.log_step(done)
        return res

    def _apply_precond_jacobian_pre_solve_lin_eqns(self, res_fname, solver_state):
        """size and submit the preconditioner batch job, if so configured"""
        _logger.debug('res_fname="%s"', res_fname)

        done = f"_apply_precond_jacobian_pre_solve_lin_eqns complete for {res_fname}"
        if solver_state.step_logged(done):
            _logger.debug("step %r already in the log; nothing to do", done)
            return

        batch_cmd = self._modelinfo["batch_cmd_precond"]
        if batch_cmd:
            node_cnt, cpus_per_node = self._precond_resources()
            cmd = " ".join(
                [
                    " ".join(batch_cmd.split()).format(
                        node_cnt=node_cnt, cpus_per_node=cpus_per_node
                    ),
                    self._modelinfo["invoker_script_fname"],
                    "--resume",
                ]
            )
            _logger.info('cmd="%s"', cmd)
            cmd_out = subprocess.check_output(cmd, shell=True).decode()
            solver_state.log_step(done)
            _logger.info('cmd_out="%s"', cmd_out)
            _logger.debug("batch job submitted; exiting this process")
            raise SystemExit

        solver_state.log_step(done)

    def _precond_resources(self):
        """(node_cnt, cpus_per_node) for the preconditioner batch job.

        cpus_per_node is capped by the tightest per-matrix memory demand
        (the `- 0.25` acknowledges that sparser task placements run ~25%
        heavier per task) and rounded down to a power of two so the solver
        tool's 2D process grid factors evenly; node_cnt then covers the
        largest per-matrix task count at that width.
        """
        modelinfo = self._modelinfo
        gb_per_node = int(modelinfo["gigabyte_per_node"])
        width_max = int(modelinfo["cpus_per_node_max"])

        solve_opts = self._solve_opts_by_matrix().values()
        width = min(
            min(
                int(gb_per_node / opts["gigabyte_per_task"] - 0.25)
                for opts in solve_opts
            ),
            width_max,
        )
        width = 2 ** int(math.log2(width))
        node_cnt = max(
            math.ceil(opts["task_cnt"] / width) for opts in solve_opts
        )
        return node_cnt, width

    def _apply_precond_jacobian_solve_lin_eqns(
        self, precond_fname, res_fname, solver_state
    ):
        """per-matrix distributed sparse solve (solve_ABdist-compatible)"""
        _logger.debug('precond_fname="%s", res_fname="%s"', precond_fname, res_fname)

        done = f"_apply_precond_jacobian_solve_lin_eqns complete for {res_fname}"
        if solver_state.step_logged(done):
            _logger.debug("step %r already in the log; loading its result", done)
            return type(self)(res_fname)

        # the solve tools update the state file in place; start from X
        self.dump(res_fname, f"{__name__}._apply_precond_jacobian_solve_lin_eqns")

        modelinfo = self._modelinfo
        # "native": external solve_ABdist-compatible tool under mpi_cmd;
        # "device": on-device DIA/ELL BiCGSTAB solve (ops/sparse.py) -- no
        # external processes, runs on modelinfo's device;
        # "device_sharded": same solve with matrix rows sharded over every
        # visible device of that kind (parallel/sharded_sparse.py; one
        # device solves unsharded);
        # "device_mixed": float32 inner iterations in a float64
        # iterative-refinement loop at the same 1e-12 accuracy;
        # "device_sharded_mixed": both (f32 inner iterations halve the
        # gathered traffic as well)
        solver_mode = modelinfo.get("precond_solver_mode") or "native"
        if solver_mode not in (
            "native", "device", "device_sharded", "device_mixed",
            "device_sharded_mixed",
        ):
            raise ValueError(f"unknown precond_solver_mode {solver_mode!r}")
        on_device = solver_mode != "native"
        solve_opts = self._solve_opts_by_matrix() if not on_device else None

        for matrix_name, tracers in self.tracer_names_per_precond_matrix().items():
            matrix_fname = os.path.join(
                solver_state.get_workdir(), f"matrix_{matrix_name}.nc"
            )
            cur_names = tracer_names_list_to_str(tracers).split(",")
            if on_device:
                _logger.info('device solve of "%s" for %s', matrix_fname, tracers)
                _device_solve_matrix(
                    matrix_fname,
                    res_fname,
                    cur_names,
                    sharded=solver_mode.startswith("device_sharded"),
                    mixed_precision=solver_mode.endswith("_mixed"),
                    device=resolve_device(modelinfo.get("device") or "cuda"),
                )
            else:
                nprow, npcol = matrix_block_decomp(
                    solve_opts[matrix_name]["task_cnt"]
                )
                solve_exe = os.path.join(
                    modelinfo["jacobian_precond_tools_dir"], "bin", "solve_ABdist"
                )
                _run_logged(
                    modelinfo["mpi_cmd"].split()
                    + [
                        solve_exe,
                        "-D1",
                        "-n", f"{nprow},{npcol}",
                        "-v", tracer_names_list_to_str(tracers),
                        matrix_fname,
                        res_fname,
                    ]
                )

            self._apply_tracers_sflux_term(tracers, precond_fname, res_fname)

        ms_res = type(self)(res_fname)
        solver_state.log_step(done)
        return ms_res

    def _apply_tracers_sflux_term(self, tracers, precond_fname, res_fname):
        """apply surface-flux cross-tracer coupling terms post-solve"""
        model_state = type(self)(res_fname)
        with NCFile(precond_fname) as precond_fptr:
            applied = [
                tracer_module.apply_tracers_sflux_term(tracers, precond_fptr)
                for tracer_module in model_state.tracer_modules
            ]
        if any(applied):
            model_state.dump(res_fname, f"{__name__}._apply_tracers_sflux_term")


def _gen_post_modelrun_script(modelinfo, script_fname):
    """POSTRUN hook: reinvoke the solver when the run completes, or rearm the
    restart override for mid-run resubmits"""
    invoker = modelinfo["invoker_script_fname"]
    batch_cmd_script = modelinfo["batch_cmd_script"]
    resume_cmd = (
        f"{invoker} --resume"
        if batch_cmd_script is None
        else f"{' '.join(batch_cmd_script.split())} {invoker} --resume"
    )
    with open(script_fname, mode="w") as fptr:
        fptr.write(
            textwrap.dedent(
                f"""\
                #!/bin/bash
                if ./xmlquery --value RESUBMIT | grep -q '^0$'; then
                    # forward run is done, reinvoke solver
                    {resume_cmd}
                else
                    # set POP_PASSIVE_TRACER_RESTART_OVERRIDE for resubmit
                    ./xmlchange POP_PASSIVE_TRACER_RESTART_OVERRIDE=none
                fi
                """
            )
        )
    os.chmod(script_fname, os.stat(script_fname).st_mode | stat.S_IXUSR)


def _gen_hist(modelinfo, hist_fname):
    """time-average the completed run's tavg output into the hist file"""
    if hist_fname is None:
        return

    caseroot = modelinfo["caseroot"]

    # first tavg stream only; the namelist variable is an array in newer
    # model versions and a scalar in older ones
    freq_opt_var = (
        "tavg_freq_opt(1)"
        if pop_nl_var_exists(caseroot, "tavg_freq_opt(1)")
        else "tavg_freq_opt"
    )
    freq_opt = get_pop_nl_var(caseroot, freq_opt_var).split()[0].split("'")[1]
    freq_count = get_pop_nl_var(caseroot, "tavg_freq").split()[0]

    run_type = cime_xmlquery(caseroot, "RUN_TYPE")
    date0 = cime_xmlquery(
        caseroot, "RUN_REFDATE" if run_type == "branch" else "RUN_STARTDATE"
    )
    yr_str, mon_str, day_str = date0.split("-")

    # configurations outside the supported envelope fail loudly rather than
    # average the wrong files
    for supported, detail in [
        (freq_opt in ("nyear", "nmonth"), f"tavg_freq_opt_0={freq_opt}"),
        (freq_count == "1", f"tavg_freq_0={freq_count}"),
        (day_str == "01", f"initial day={day_str}"),
        (
            freq_opt != "nyear" or mon_str == "01",
            f"initial month={mon_str} for nyear tavg output",
        ),
    ]:
        if not supported:
            raise NotImplementedError(f"{detail} not implemented")

    hist_dir = cime_xmlquery(caseroot, "RUNDIR")
    case = cime_xmlquery(caseroot, "CASE")

    caller = f"{__name__}._gen_hist"
    if freq_opt == "nyear":
        ann_files_to_mean_file(
            hist_dir,
            f"{case}.pop.h.{{year:04}}.nc",
            int(yr_str),
            cime_yr_cnt(modelinfo),
            hist_fname,
            caller,
        )
    else:  # nmonth (validated above)
        mon_files_to_mean_file(
            hist_dir,
            f"{case}.pop.h.{{year:04}}-{{month:02}}.nc",
            int(yr_str),
            int(mon_str),
            12 * cime_yr_cnt(modelinfo),
            hist_fname,
            caller,
        )


def _device_solve_matrix(matrix_fname, res_fname, tracer_names, sharded=False,
                         mixed_precision=False, device="cuda"):
    """solve the gen_A CSR systems for the named tracers on `device` and
    scatter the solutions back into the state file (incl. the _OLD twins) --
    the in-process counterpart of the external solve_ABdist run.  With
    sharded=True the matrix rows distribute over every visible device of
    `device`'s kind (the in-mesh analog of the reference's nprow x npcol
    SuperLU_DIST grid); mixed_precision runs float32 inner iterations under
    float64 refinement (requires a matrix file with the recorded grid
    decomposition)."""
    import numpy as np

    from ...ops.sparse import solve_csr_systems

    with NCFile(matrix_fname) as fptr:
        row_ptr = np.asarray(fptr.var("row_ptr")[:], np.int64)
        col_ind = np.asarray(fptr.var("col_ind")[:], np.int64)
        data = np.asarray(fptr.var("data")[:], np.float64)
        row_to_cell = np.asarray(fptr.var("row_to_cell")[:], np.int64)
        # newer gen_A outputs record the grid split of the flat cell index;
        # with it the solve upgrades from Jacobi to vertical-line precond
        nhoriz = fptr.dimensions.get("grid_nhoriz")

    with NCFile(res_fname, mode="a") as fptr:
        rhs = np.stack(
            [
                np.asarray(fptr.var(name)[:], np.float64).reshape(-1)[
                    row_to_cell
                ]
                for name in tracer_names
            ]
        )
        if mixed_precision and not nhoriz:
            raise ValueError(
                "the mixed-precision precond_solver_modes need a matrix "
                "file with the grid_nhoriz dimension (newer gen_A output)"
            )
        if sharded:
            from ...parallel.sharded_sparse import solve_csr_systems_sharded

            x_batch, ok = solve_csr_systems_sharded(
                row_ptr, col_ind, data, rhs,
                row_to_cell=row_to_cell if nhoriz else None, nhoriz=nhoriz,
                mixed_precision=mixed_precision, device=device,
            )
        else:
            x_batch, ok = solve_csr_systems(
                row_ptr, col_ind, data, rhs,
                row_to_cell=row_to_cell if nhoriz else None, nhoriz=nhoriz,
                mixed_precision=mixed_precision, device=device,
            )
        if not ok.all():
            bad = [n for n, flag in zip(tracer_names, ok) if not flag]
            raise RuntimeError(f"device precond solve failed for {bad}")
        for name, x in zip(tracer_names, x_batch):
            var = fptr.var(name)
            vals = np.asarray(var[:], np.float64)
            flat = vals.reshape(-1)
            flat[row_to_cell] = x
            var[:] = vals
            if name.endswith("_CUR"):
                old_name = name[: -len("_CUR")] + "_OLD"
                try:
                    fptr.var(old_name)[:] = vals
                except KeyError:
                    pass


def matrix_block_decomp(precond_task_cnt):
    """2D (nprow x npcol) process grid for the distributed matrix solve"""
    log2_task_cnt = round(math.log2(precond_task_cnt))
    if 2**log2_task_cnt != precond_task_cnt:
        raise ValueError("precond_task_cnt must be a power of 2")
    nprow = 2 ** (log2_task_cnt // 2)
    npcol = precond_task_cnt // nprow
    return nprow, npcol


def tracer_names_list_to_str(tracer_names_list):
    """comma-separated _CUR-suffixed tracer names for the solve tool"""
    return ",".join([f"{tracer_name}_CUR" for tracer_name in tracer_names_list])
