"""a mock CIME case for the cime_pop adapter, importing no jax

A fake caseroot (an xml store of NAME=value lines behind executable
xmlquery / xmlchange shell scripts and a case.submit script), a trivial
linear "ocean model" y_end = DECAY * y + FORCING that case.submit runs
synchronously, annual tavg output, and mock
preconditioner tools (gen_A writes the scalar Jacobian and its diagonal CSR
form with the grid decomposition; solve_ABdist applies the exact inverse
Jacobian + I in place) -- the fixture of tests/test_cime_pop_adapter.py,
written with the port's netCDF layer so that either package's adapter, and
chip_smoke.py on a machine without jax, can drive it.  run_solve plays the
batch scheduler: each SystemExit of the submit-and-exit contract re-enters
the solver with resume=True.
"""

import configparser
import json
import os
import stat
import sys
import textwrap

import numpy as np

TESTS_DIR = os.path.dirname(os.path.realpath(__file__))
REPO = os.path.dirname(TESTS_DIR)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from newton_krylov_ooc_tpu_torch.utils.ncio import NCFile  # noqa: E402

NZ, NLAT, NLON = 3, 4, 5
DECAY = 0.5  # mock model: y_end = DECAY * y + FORCING
FORCING = 2.0
FIXED_POINT = FORCING / (1.0 - DECAY)

# the scripts' preamble: this module, importable in a fresh interpreter
_PREAMBLE = f"""\
import sys
sys.path.insert(0, {TESTS_DIR!r})
sys.path.insert(0, {REPO!r})
"""


def write_restart(fname, vals, history="mock restart"):
    with NCFile(fname, mode="w") as fptr:
        fptr.history = history
        fptr.create_dimensions_verify({"z_t": NZ, "nlat": NLAT, "nlon": NLON})
        for suffix in ["CUR", "OLD"]:
            var = fptr.create_variable(
                f"IAGE_{suffix}", "f8", ("z_t", "nlat", "nlon")
            )
            var[:] = vals


def write_tavg(fname, vals):
    with NCFile(fname, mode="w") as fptr:
        fptr.history = "mock tavg"
        fptr.create_dimensions_verify(
            {"time": None, "z_t": NZ, "nlat": NLAT, "nlon": NLON}
        )
        fptr.create_variable("time", "f8", ("time",))[0] = 365.0
        var = fptr.create_variable(
            "IAGE",
            "f8",
            ("time", "z_t", "nlat", "nlon"),
            attrs={"units": "years", "long_name": "mock iage tavg"},
        )
        var[0, ...] = vals
        dz = fptr.create_variable("dz", "f8", ("z_t",))
        dz[:] = np.full(NZ, 100.0e2)  # cm


def run_case_submit(xml_fname):
    """the mock model run: read tracer_ic, apply the linear update, write
    restart + rpointer + tavg (the POSTRUN hook is not invoked: the caller
    plays the scheduler)"""
    with open(xml_fname) as fptr:
        xml = dict(line.rstrip("\n").split("=", 1) for line in fptr)
    rundir = xml["RUNDIR"]
    with NCFile(os.path.join(rundir, "tracer_ic.nc")) as fptr:
        ic = fptr.var("IAGE_CUR")[:]
    end = DECAY * ic + FORCING
    write_restart(os.path.join(rundir, "mockcase.pop.r.0002.nc"), end)
    with open(os.path.join(rundir, "rpointer.ocn.restart"), "w") as fptr:
        fptr.write("mockcase.pop.r.0002.nc\n")
    write_tavg(os.path.join(rundir, "mockcase.pop.h.0001.nc"), 0.5 * (ic + end))


def run_gen_a(matrix_fname):
    """the mock gen_A: the scalar Jacobian, and the same diagonal operator in
    CSR form with the recorded grid decomposition (which enables the
    vertical-line precond and the mixed precond_solver_modes)"""
    n = NZ * NLAT * NLON
    with NCFile(matrix_fname, mode="w") as fptr:
        fptr.history = "mock gen_A"
        fptr.create_dimension("one", 1)
        fptr.create_variable("jac_scalar", "f8", ("one",))[:] = DECAY - 1.0
        fptr.create_dimension("rows_p1", n + 1)
        fptr.create_dimension("nnz", n)
        fptr.create_dimension("grid_nz", NZ)
        fptr.create_dimension("grid_nhoriz", NLAT * NLON)
        fptr.create_variable("row_ptr", "f8", ("rows_p1",))[:] = np.arange(n + 1.0)
        fptr.create_variable("col_ind", "f8", ("nnz",))[:] = np.arange(float(n))
        fptr.create_variable("data", "f8", ("nnz",))[:] = np.full(n, DECAY - 1.0)
        fptr.create_variable("row_to_cell", "f8", ("nnz",))[:] = np.arange(float(n))


def run_solve_abdist(args):
    """the mock solve_ABdist: z = x / jac + x in place for each -v tracer"""
    matrix_fname, res_fname = args[-2], args[-1]
    varnames = args[args.index("-v") + 1].split(",")
    with NCFile(matrix_fname) as fptr:
        jac = float(fptr.var("jac_scalar")[:][0])
    with NCFile(res_fname, mode="a") as fptr:
        for varname in varnames:
            vals = fptr.var(varname)[:]
            fptr.var(varname)[:] = vals / jac + vals


def _script(path, body, shell=False):
    head = "#!/bin/sh\n" if shell else "#!" + sys.executable + "\n" + _PREAMBLE
    path.write_text(head + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def build_case(tmp_path):
    """the caseroot, rundir and tools dir of a fresh mock case under
    tmp_path (a pathlib.Path)"""
    caseroot = tmp_path / "caseroot"
    rundir = tmp_path / "rundir"
    caseroot.mkdir()
    (caseroot / "CaseDocs").mkdir()
    rundir.mkdir()

    xml_fname = caseroot / "xml.txt"
    xml = {
        "RUNDIR": str(rundir),
        "CASE": "mockcase",
        "RUN_TYPE": "startup",
        "RUN_STARTDATE": "0001-01-01",
        "OCN_GRID": "gx3v7",
        "POP_PASSIVE_TRACER_RESTART_OVERRIDE": "none",
        "CONTINUE_RUN": "FALSE",
        "POSTRUN_SCRIPT": "",
        "STOP_OPTION": "nyears",
        "STOP_N": "1",
        "RESUBMIT": "0",
    }
    xml_fname.write_text("".join(f"{key}={val}\n" for key, val in xml.items()))
    # shell scripts: the adapter calls them dozens of times a solve.  CIME's
    # xmlquery --value prints without a trailing newline
    _script(caseroot / "xmlquery", f"""\
        printf '%s' "$(sed -n "s/^$2=//p" '{xml_fname}')"
        """, shell=True)
    _script(caseroot / "xmlchange", f"""\
        key="${{1%%=*}}"
        grep -v "^$key=" '{xml_fname}' > '{xml_fname}.new'
        printf '%s\\n' "$1" >> '{xml_fname}.new'
        mv '{xml_fname}.new' '{xml_fname}'
        """, shell=True)
    _script(caseroot / "case.submit", f"""\
        from cime_mock_case import run_case_submit
        run_case_submit({str(xml_fname)!r})
        """)
    # POP namelist (annual tavg output)
    (caseroot / "CaseDocs" / "pop_in").write_text(
        "tavg_freq_opt = 'nyear'\ntavg_freq = 1\n"
    )

    tools = tmp_path / "tools"
    (tools / "bin").mkdir(parents=True)
    _script(tools / "bin" / "gen_A", """\
        from cime_mock_case import run_gen_a
        run_gen_a(sys.argv[-1])
        """)
    _script(tools / "bin" / "solve_ABdist", """\
        from cime_mock_case import run_solve_abdist
        run_solve_abdist(sys.argv[1:])
        """)
    return {"caseroot": caseroot, "rundir": rundir, "tools": tools}


def build_config(tmp_path, case, precond_mode):
    """the solver's cfg for the mock case (grid vars and tracer module defs
    written under tmp_path) with the given precond_solver_mode, and its
    initial iterate written"""
    workdir = tmp_path / "workdir"
    workdir.mkdir()
    rpointer_dir = tmp_path / "rpointers"
    rpointer_dir.mkdir()
    (rpointer_dir / "rpointer.ocn.restart").write_text("mockcase.pop.r.0001.nc\n")

    # grid vars: uniform-volume 3D grid, single region
    grid_vars_fname = workdir / "grid_vars.nc"
    with NCFile(str(grid_vars_fname), mode="w") as fptr:
        fptr.history = "mock grid"
        fptr.create_dimensions_verify({"z_t": NZ, "nlat": NLAT, "nlon": NLON})
        mask = fptr.create_variable(
            "region_mask",
            "i4",
            ("z_t", "nlat", "nlon"),
            attrs={
                "long_name": "Region Mask",
                "cell_measures": "volume: grid_weight",
            },
        )
        mask[:] = np.ones((NZ, NLAT, NLON), np.int32)
        weight = fptr.create_variable("grid_weight", "f8", ("z_t", "nlat", "nlon"))
        weight[:] = np.ones((NZ, NLAT, NLON))

    defs_fname = tmp_path / "defs.yaml"
    defs_fname.write_text(textwrap.dedent("""
        tracer_module_defs:
            iage:
                region_mask_varname: "region_mask"
                tracers:
                    IAGE:
                        attrs: {units: "years"}
                        precond_matrix: iage_like
        precond_matrix_defs:
            base:
                hist_to_precond_varnames: [dz]
                precond_matrices_opts:
                    - day_cnt {day_cnt}
                precond_matrices_solve_opts:
                    gx3v7:
                        task_cnt: 4
                        gigabyte_per_task: 0.1
            iage_like:
                precond_matrices_opts:
                    - sink_type none
        """))

    config = configparser.ConfigParser(
        {
            "HOME": str(tmp_path),
            "USER": "tester",
            "repo_root": str(tmp_path),
            "logging_reproducible": "False",
        },
        allow_no_value=True,
    )
    config["DEFAULT"].update({"model_name": "cime_pop", "workdir": str(workdir)})
    config["solverinfo"] = {
        "cfg_out_fname": str(workdir / "cfg.out"),
        "logging_fname": str(workdir / "nk.log"),
        "logging_level": "INFO",
        "logging_reproducible": "False",
        "init_iterate_fname": str(tmp_path / "init_restart.nc"),
        "newton_rel_tol": "1.0e-10",
        "newton_max_iter": "5",
        "post_newton_fp_iter": "1",
        "krylov_rel_tol": "1.0e-6",
    }
    config["modelinfo"] = {
        "caseroot": str(case["caseroot"]),
        "rpointer_dir": str(rpointer_dir),
        "STOP_OPTION": "nyears",
        "STOP_N": "1",
        "RESUBMIT": "0",
        "jacobian_precond_tools_dir": str(case["tools"]),
        "batch_cmd_precond": "",
        "batch_cmd_script": None,
        "mpi_cmd": "",
        "invoker_script_fname": str(workdir / "nk_driver.sh"),
        "grid_vars_fname": str(grid_vars_fname),
        "irf_fname": str(workdir / "irf.nc"),
        "tracer_module_names": "iage",
        "tracer_module_defs_fname": str(defs_fname),
        "gigabyte_per_node": "4",
        "cpus_per_node_max": "8",
        "precond_solver_mode": precond_mode,
    }
    write_restart(config["solverinfo"]["init_iterate_fname"],
                  np.zeros((NZ, NLAT, NLON)))
    return config


def run_solve(newton_solver_cls, model_state_cls, solverinfo, max_restarts=50):
    """a full Newton solve through the submit-and-exit contract; returns
    (solver, restarts)"""
    restarts = 0
    resume = False
    while True:
        try:
            solver = newton_solver_cls(
                model_state_cls, solverinfo=solverinfo, resume=resume,
                rewind=False,
            )
            while not solver.converged().all():
                solver.step()
            return solver, restarts
        except SystemExit:
            # the submitted "job" already ran inside case.submit; re-enter
            # the solver with --resume
            restarts += 1
            resume = True
            if restarts > max_restarts:
                raise AssertionError(
                    f"mock solve did not converge in {max_restarts} restarts"
                ) from None


def solve_counts(workdir):
    """(Newton iterations, [Krylov iterations of each Newton step]) from the
    workdir's step-log files"""
    with open(os.path.join(workdir, "Newton_state.json")) as fptr:
        newton = json.load(fptr)["iteration"]
    krylov = []
    for sub in sorted(os.listdir(workdir)):
        path = os.path.join(workdir, sub, "Krylov_state.json")
        if sub.startswith("krylov_") and os.path.exists(path):
            with open(path) as fptr:
                krylov.append(json.load(fptr)["iteration"])
    return newton, krylov
