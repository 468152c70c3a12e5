"""the port's file-backed Newton-Krylov path for test_problem held against
the JAX package on the same inputs, and against the committed ci baselines,
on the CPU (--device cpu).

The host layer (config, netCDF, step logs, spatial axis) is the JAX
package's numpy code copied into the port; these tests hold each copy to
its original on the same files.  Both packages' NewtonSolvers run on one
cheap linear model (numpy comp_fcn) and must write the same step logs.  The
port's test_problem comp_fcn (the Radau year in PyTorch) is held against
JAX's and against baselines/ci_short.  The full solves are slow-marked, as
their JAX counterparts (tests/test_solver_end_to_end.py) are.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import newton_krylov_ooc_tpu.cli.baseline_cmp as jax_baseline_cmp
import newton_krylov_ooc_tpu.config.model_config as jax_model_config
import newton_krylov_ooc_tpu.config.share as jax_share
import newton_krylov_ooc_tpu.core.newton as jax_newton
import newton_krylov_ooc_tpu.core.spatial_axis as jax_spatial_axis
import newton_krylov_ooc_tpu.models.test_problem.model_state as jax_model_state
import newton_krylov_ooc_tpu.utils.ncio as jax_ncio
import newton_krylov_ooc_tpu_torch.cli.baseline_cmp as port_baseline_cmp
import newton_krylov_ooc_tpu_torch.cli.gen_invoker_script as port_invoker
import newton_krylov_ooc_tpu_torch.config.model_config as port_model_config
import newton_krylov_ooc_tpu_torch.config.share as port_share
import newton_krylov_ooc_tpu_torch.core.newton as port_newton
import newton_krylov_ooc_tpu_torch.core.solver_state as port_solver_state
import newton_krylov_ooc_tpu_torch.core.spatial_axis as port_spatial_axis
import newton_krylov_ooc_tpu_torch.models.test_problem.model_state as port_model_state
import newton_krylov_ooc_tpu_torch.models.test_problem.setup_solver as port_setup
import newton_krylov_ooc_tpu_torch.utils.ncio as port_ncio

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
BASELINES = os.path.join(REPO, "baselines")
TOLS = (port_baseline_cmp.DEFAULT_RTOL, port_baseline_cmp.DEFAULT_ATOL)

PACKAGES = {
    "jax": (jax_share, jax_spatial_axis, jax_ncio, jax_model_config,
            jax_model_state, jax_newton, ()),
    "port": (port_share, port_spatial_axis, port_ncio, port_model_config,
             port_model_state, port_newton, ("--device", "cpu")),
}


@pytest.fixture(autouse=True)
def _isolate_model_state():
    """the test_problem ModelStates keep their depth axis, config and
    integrators on the class; start and leave each test without them"""
    for pkg in PACKAGES.values():
        pkg[4].ModelState.depth = None
        pkg[4].ModelState._integrate_cache = {}
    yield
    for pkg in PACKAGES.values():
        pkg[4].ModelState.depth = None
        pkg[4].ModelState.model_config_obj = None
        pkg[4].ModelState._integrate_cache = {}


def _setup(pkg_name, workdir, module_names="iage", extra_args=(), reinvoke=False,
           init="gen_init_iterate", cls=None):
    """configure a test_problem workdir through one package's modules, as
    tests/test_solver_end_to_end.py::_setup does, and write the initial
    iterate; returns the cfg"""
    share, spatial_axis, ncio, model_config, model_state, _newton, device = \
        PACKAGES[pkg_name]
    args_list = ["--workdir", str(workdir), "--tracer_module_names", module_names,
                 *device, *extra_args]
    if not reinvoke:
        args_list.append("--persist")
    parser, args_remaining = share.common_args("e2e", "test_problem", args_list)
    config = share.read_cfg_files(parser.parse_args(args_remaining))
    modelinfo = config["modelinfo"]

    depth = spatial_axis.spatial_axis_from_defn_dict(
        defn_dict=spatial_axis.spatial_axis_defn_dict(nlevs=20))
    depth.dump(modelinfo["grid_vars_fname"], caller="tests.file_backed")
    with ncio.NCFile(modelinfo["grid_vars_fname"], mode="a") as fptr:
        var = fptr.create_variable(
            "region_mask", "i4", ("depth",),
            attrs={"long_name": "Region Mask",
                   "cell_measures": "thickness: depth_delta"})
        var[:] = np.ones(20, dtype=np.int32)

    cls = model_state.ModelState if cls is None else cls
    model_state.ModelState.model_config_obj = model_config.ModelConfig(modelinfo)
    model_state.ModelState.depth = None
    init_fname = config["solverinfo"]["init_iterate_fname"]
    os.makedirs(os.path.dirname(init_fname), exist_ok=True)
    cls(init).dump(init_fname, caller="tests.file_backed")
    return config


def _drive(pkg_name, config, cls=None, resume=False):
    _share, _axis, _ncio, _cfg, model_state, newton, _dev = PACKAGES[pkg_name]
    solver = newton.NewtonSolver(
        model_state.ModelState if cls is None else cls,
        solverinfo=config["solverinfo"], resume=resume, rewind=False)
    while not solver.converged().all():
        solver.step()
    return solver


def _step_logs(workdir):
    """the Newton and Krylov step logs, workdir canonicalised"""
    logs = {}
    names = ["Newton_state.json"] + [
        os.path.join(name, "Krylov_state.json")
        for name in sorted(os.listdir(workdir)) if name.startswith("krylov_")]
    for rel in names:
        with open(os.path.join(workdir, rel)) as fptr:
            logs[rel] = [step.replace(str(workdir), "WORKDIR")
                         for step in json.load(fptr)["step_log"]]
    return logs



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """the Radau's tensors are tiny: one intra-op thread, so that on a busy
    machine (the suite's parallel workers) no thread pool spins for them"""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

# -- the host layer ---------------------------------------------------------------


def test_model_config_matches_jax(tmp_path):
    """ModelConfig from input/test_problem/newton_krylov.cfg, through each
    package's cfg layer, on each package's grid file"""
    configs = {}
    for name in PACKAGES:
        _setup(name, tmp_path / name, module_names="iage,phosphorus,dye_decay_{suff}:001:002")
        configs[name] = PACKAGES[name][4].ModelState.model_config_obj
    jax_cfg, cfg = configs["jax"], configs["port"]
    assert cfg.tracer_module_defs == jax_cfg.tracer_module_defs
    assert cfg.precond_matrix_defs == jax_cfg.precond_matrix_defs
    assert cfg.region_cnt == jax_cfg.region_cnt == 1
    assert cfg.modelinfo["tracer_module_names"] == jax_cfg.modelinfo["tracer_module_names"]
    assert cfg.modelinfo["device"] == "cpu"
    jax_info = {key: val.replace(str(tmp_path / "jax"), "W")
                for key, val in jax_cfg.modelinfo.items()}
    info = {key: val.replace(str(tmp_path / "port"), "W")
            for key, val in cfg.modelinfo.items() if key != "device"}
    assert info == jax_info
    for varname, grid_vars in cfg.grid_vars.items():
        jax_vars = jax_cfg.grid_vars[varname]
        assert grid_vars.keys() == jax_vars.keys()
        for key, val in grid_vars.items():
            assert np.array_equal(np.asarray(val), np.asarray(jax_vars[key]))


def test_ncio_committed_fixtures():
    """input/tests/isclose_*.nc read and classified as the JAX package does"""
    fixture_dir = os.path.join(REPO, "input", "tests")
    names = ["isclose_base.nc", "isclose_same.nc", "isclose_diff.nc"]
    paths = [os.path.join(fixture_dir, name) for name in names]
    for path in paths:
        with port_ncio.NCFile(path) as fptr, jax_ncio.NCFile(path) as jax_fptr:
            assert list(fptr.variables) == list(jax_fptr.variables)
            for var in fptr.variables:
                assert np.array_equal(fptr.var(var)[:], jax_fptr.var(var)[:])
                assert fptr.var(var).attrs == jax_fptr.var(var).attrs
    for tol in (0.0, 1.0e-8, 1.0e-5, 1.0e-4):
        for other in paths:
            assert port_ncio.isclose_all_vars(paths[0], other, rtol=tol, atol=tol) \
                == jax_ncio.isclose_all_vars(paths[0], other, rtol=tol, atol=tol)
            assert port_ncio.metadata_same(paths[0], other) \
                == jax_ncio.metadata_same(paths[0], other)
    assert port_ncio.isclose_all_vars(paths[0], paths[1], rtol=0.0, atol=0.0)
    assert not port_ncio.isclose_all_vars(paths[0], paths[2], rtol=1e-8, atol=1e-8)


def test_solver_state_resume_and_rewind(tmp_path):
    """the write-ahead step log: resume replays, rewind pops the last step"""
    state = port_solver_state.SolverState("Newton", str(tmp_path))
    state.log_step("step A")
    state.log_step("step B")
    state.set_value_saved_state("beta", np.array([[1.5, 2.5]]))
    state.inc_iteration()
    state.log_step("step C")

    resumed = port_solver_state.SolverState("Newton", str(tmp_path), resume=True)
    assert resumed.get_iteration() == 1
    assert resumed.step_logged("step C")
    assert np.array_equal(resumed.get_value_saved_state("beta"), [[1.5, 2.5]])

    rewound = port_solver_state.SolverState("Newton", str(tmp_path), resume=True,
                                            rewind=True)
    assert not rewound.step_logged("step C")
    assert rewound.step_was_rewound("step C")
    with pytest.raises(RuntimeError):
        port_solver_state.SolverState("Newton", str(tmp_path), resume=False,
                                      rewind=True)


def test_spatial_axis_file_round_trip(tmp_path):
    """an axis written by either package reads back the same in both, and
    the layer integral and conservative remap agree with JAX's"""
    defn = dict(nlevs=13, delta_ratio_max=3.0)
    axis = port_spatial_axis.spatial_axis_from_defn_dict(
        port_spatial_axis.spatial_axis_defn_dict(**defn))
    jax_axis = jax_spatial_axis.spatial_axis_from_defn_dict(
        jax_spatial_axis.spatial_axis_defn_dict(**defn))
    axis.dump(str(tmp_path / "port.nc"), caller="tests.file_backed")
    jax_axis.dump(str(tmp_path / "jax.nc"), caller="tests.file_backed")
    for fname in ("port.nc", "jax.nc"):
        for read in (port_spatial_axis.spatial_axis_from_file,
                     jax_spatial_axis.spatial_axis_from_file):
            back = read(str(tmp_path / fname), "depth")
            assert np.array_equal(back.edges, jax_axis.edges)
            assert back.units == jax_axis.units
    vals = np.random.default_rng(0).normal(size=(3, 13))
    assert np.array_equal(axis.int_vals_mid(vals, axis=-1),
                          jax_axis.int_vals_mid(vals, axis=-1))
    xvals, yvals = [100.0, 400.0], [1.0, -2.0]
    assert np.array_equal(axis.remap_linear_interpolant(xvals, yvals),
                          jax_axis.remap_linear_interpolant(xvals, yvals))


def test_invoker_script_freezes_device(tmp_path):
    """setup's nk_driver.sh runs the port's driver with the same --device;
    the port's cfg layer defaults to the card, which raises without one"""
    args = port_setup.parse_args(["--workdir", str(tmp_path), "--device", "cpu",
                                  "--persist"])
    port_invoker.main(args)
    with open(tmp_path / "nk_driver.sh") as fptr:
        script = fptr.read()
    assert "-m newton_krylov_ooc_tpu_torch.cli.nk_driver" in script
    assert '--device "cpu"' in script and "--persist" in script
    assert port_setup.parse_args(["--workdir", str(tmp_path)]).device == "cuda"
    if not torch.cuda.is_available():
        config = _setup("port", tmp_path / "cuda", extra_args=("--device", "cuda"))
        assert config["modelinfo"]["device"] == "cuda"
        state = port_model_state.ModelState(config["solverinfo"]["init_iterate_fname"])
        with pytest.raises(RuntimeError, match="cuda"):
            state.comp_fcn(str(tmp_path / "fcn.nc"), None)


# -- both NewtonSolvers on one linear model ---------------------------------------


def _linear_run_module(self, tracer_module, n_time):
    """a linear year in numpy: y(T) = A y0 + b, sampled linearly in time"""
    y0 = tracer_module.get_tracer_vals_all().reshape(-1)
    n = y0.size
    rng = np.random.default_rng(n)
    a_mat = 0.6 * np.eye(n) + 0.2 * rng.random((n, n)) / n
    y1 = a_mat @ y0 + 1.0 + rng.random(n)
    frac = np.linspace(0.0, 1.0, n_time)[:, None]
    return (1.0 - frac) * y0 + frac * y1


class JaxLinearState(jax_model_state.ModelState):
    """the JAX test_problem model with a linear numpy year"""

    _run_module = _linear_run_module


class PortLinearState(port_model_state.ModelState):
    """the port's test_problem model with the same linear numpy year"""

    _run_module = _linear_run_module


def test_newton_solvers_step_logs_match(tmp_path):
    """both packages' NewtonSolver (and KrylovSolver) on the linear model:
    identical Newton and Krylov step logs, iterates within 1e-13"""
    iterates, logs = {}, {}
    for name, cls in (("jax", JaxLinearState), ("port", PortLinearState)):
        workdir = tmp_path / name
        # Newton with Krylov's 1e-2 tolerance takes 12 iterations here
        config = _setup(name, workdir, cls=cls,
                        extra_args=("--newton_max_iter", "20"))
        solver = _drive(name, config, cls=cls)
        iterates[name] = solver._iterate.get_tracer_vals("iage")
        logs[name] = _step_logs(workdir)
        assert solver.get_iteration() >= 1
    assert logs["port"] == logs["jax"]
    assert len(logs["port"]) > 1
    np.testing.assert_allclose(iterates["port"], iterates["jax"], rtol=1e-13, atol=0.0)


# -- the port's test_problem comp_fcn -----------------------------------------------


class JaxMonthState(jax_model_state.ModelState):
    """the JAX test_problem model, F over the first 30 days"""

    time_range = (0.0, 30 * 86400.0)


class PortMonthState(port_model_state.ModelState):
    """the port's test_problem model, F over the first 30 days"""

    time_range = (0.0, 30 * 86400.0)


def _comp_fcn_ci_short(tmp_path, classes):
    """F and its history of ci_short's initial iterate (iage and
    phosphorus) through each package's comp_fcn; {package: (fcn, hist)}"""
    init = os.path.join(BASELINES, "ci_short", "init_iterate_00.nc")
    out = {}
    for name, cls in classes.items():
        workdir = tmp_path / name
        _setup(name, workdir, module_names="iage,phosphorus")
        out[name] = (str(workdir / "fcn_00.nc"), str(workdir / "hist_00.nc"))
        cls(init).comp_fcn(out[name][0], None, out[name][1])
    return out


def test_comp_fcn_ci_short_month_against_jax(tmp_path):
    """ci_short's comp_fcn, F and its 101-sample history, over 30 days:
    the port's against JAX's at baseline_cmp's defaults (the full year
    against the baselines is slow-marked below)"""
    out = _comp_fcn_ci_short(tmp_path, {"jax": JaxMonthState, "port": PortMonthState})
    for port_out, jax_out in zip(out["port"], out["jax"]):
        assert port_baseline_cmp.compare(port_out, jax_out, *TOLS)
        assert jax_baseline_cmp.compare(port_out, jax_out, *TOLS)


@pytest.mark.slow
def test_comp_fcn_ci_short_against_jax_and_baselines(tmp_path):
    """ci_short's comp_fcn over the model year (a year of iage and of
    phosphorus on the CPU) against JAX's comp_fcn and against
    baselines/ci_short at baseline_cmp's defaults.  Slow-marked: alone it
    takes about 50 s, but the port's CPU year is one Python-bound thread,
    and among the suite's six parallel workers it took 673 s"""
    out = _comp_fcn_ci_short(tmp_path, {name: PACKAGES[name][4].ModelState
                                        for name in PACKAGES})
    for index, fname in enumerate(("fcn_00.nc", "hist_00.nc")):
        port_out, jax_out = out["port"][index], out["jax"][index]
        assert port_baseline_cmp.compare(port_out, jax_out, *TOLS)
        assert port_baseline_cmp.compare(port_out, os.path.join(BASELINES, "ci_short", fname),
                                         *TOLS)
        assert jax_baseline_cmp.compare(port_out, jax_out, *TOLS)


# -- full solves (slow, as in the JAX package) ------------------------------------


def _ci_setup(workdir, extra=()):
    """the port's setup_solver as scripts/ci_*.sh run it, on the CPU"""
    port_setup.main(port_setup.parse_args(
        ["--depth_nlevs", "20", "--persist", "--workdir", str(workdir),
         "--device", "cpu", *extra]))


def _compare(workdir, baseline, files, rtol=TOLS[0]):
    for rel in files:
        assert port_baseline_cmp.compare(
            os.path.join(workdir, rel),
            os.path.join(BASELINES, baseline, os.path.basename(rel)),
            rtol, TOLS[1]), rel


def _canonical_log(workdir, name):
    with open(os.path.join(workdir, "Newton_state.json")) as fptr:
        return fptr.read().replace(str(workdir), f"HOME/ci_{name}_workdir")


def _baseline_log(name):
    with open(os.path.join(BASELINES, f"ci_{name}", "Newton_state.json")) as fptr:
        return fptr.read()


@pytest.mark.slow
def test_ci_long_iage_solve(tmp_path):
    """scripts/ci_long_iage.sh through the port: setup, nk_driver.sh to
    convergence, the files at the script's tolerances, the step log byte
    for byte"""
    workdir = tmp_path / "ci_long_iage_workdir"
    _ci_setup(workdir, ["--fp_cnt", "1", "--tracer_module_names", "iage"])
    subprocess.run([str(workdir / "nk_driver.sh")], check=True, timeout=3000)
    _compare(workdir, "ci_long_iage",
             [os.path.join("krylov_00", name) for name in
              ("precond_00.nc", "precond_fcn_00.nc", "basis_00.nc",
               "perturb_fcn_w_raw_00.nc")])
    _compare(workdir, "ci_long_iage",
             [os.path.join("krylov_00", name) for name in
              ("w_raw_00.nc", "w_00.nc", "krylov_res_00.nc")]
             + ["increment_00.nc", "iterate_01.nc"], rtol=2.0e-4)
    assert _canonical_log(workdir, "long_iage") == _baseline_log("long_iage")


@pytest.mark.slow
def test_ci_zero_iage_solve(tmp_path):
    """scripts/ci_zero_iage.sh through the port: from a zero iterate to
    convergence at Newton iteration 3"""
    workdir = tmp_path / "ci_zero_iage_workdir"
    _ci_setup(workdir, ["--fp_cnt", "0", "--tracer_module_names", "iage",
                        "--init_iterate_opt", "zeros"])
    subprocess.run([str(workdir / "nk_driver.sh")], check=True, timeout=3000)
    with open(workdir / "Newton_state.json") as fptr:
        assert json.load(fptr)["iteration"] == 3


@pytest.mark.slow
def test_ci_long_dye_decay_step_log(tmp_path):
    """scripts/ci_long_dye_decay.sh through the port: ten parameterised
    dye_decay modules, the step log byte for byte"""
    workdir = tmp_path / "ci_long_dye_decay_workdir"
    _ci_setup(workdir, ["--fp_cnt", "1", "--tracer_module_names",
                        "dye_decay_{suff}:001:010", "--newton_rel_tol", "1.0e-6"])
    subprocess.run([str(workdir / "nk_driver.sh")], check=True, timeout=3000)
    assert _canonical_log(workdir, "long_dye_decay") == _baseline_log("long_dye_decay")


@pytest.mark.slow
def test_full_solve_reinvoke(tmp_path, monkeypatch):
    """out-of-core mode: every comp_fcn ends the process; the solve
    re-enters with resume and fast-forwards through the step log"""
    config = _setup("port", tmp_path / "w", reinvoke=True)
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: None)
    restarts, resume = 0, False
    while True:
        try:
            solver = _drive("port", config, resume=resume)
            break
        except SystemExit:
            restarts += 1
            resume = True
            assert restarts <= 100
    assert solver.get_iteration() == 3
    assert restarts >= solver.get_iteration()


def _kill_replay(tmp_path, monkeypatch, module_names, tracer_names, extra_args=()):
    """the solve killed after every step-log append and resumed: the same
    step logs and iterate as an uninterrupted run"""
    golden_dir = tmp_path / "golden"
    golden = _drive("port", _setup("port", golden_dir, module_names, extra_args))
    golden_vals = {name: golden._iterate.get_tracer_vals(name) for name in tracer_names}
    golden_logs = _step_logs(golden_dir)

    killed_dir = tmp_path / "killed"
    config = _setup("port", killed_dir, module_names, extra_args)
    orig_log_step = port_solver_state.SolverState.log_step
    budget = {"appends": 0}

    def killing_log_step(self, stepval, per_iteration=True):
        is_new = not self.step_logged(stepval, per_iteration)
        orig_log_step(self, stepval, per_iteration)
        if is_new:
            budget["appends"] -= 1
            if budget["appends"] <= 0:
                raise SystemExit("killed at step boundary")

    monkeypatch.setattr(port_solver_state.SolverState, "log_step", killing_log_step)
    segments, resume = 0, False
    while True:
        budget["appends"] = 1
        try:
            solver = _drive("port", config, resume=resume)
            break
        except SystemExit:
            segments += 1
            resume = True
            assert segments < 500
    assert segments == sum(len(log) for log in golden_logs.values())
    assert solver.get_iteration() == golden.get_iteration()
    assert _step_logs(killed_dir) == golden_logs
    for name in tracer_names:
        np.testing.assert_allclose(solver._iterate.get_tracer_vals(name),
                                   golden_vals[name], rtol=1e-13, atol=0.0)
    return golden.get_iteration()


@pytest.mark.slow
def test_kill_replay_every_step_boundary(tmp_path, monkeypatch):
    assert _kill_replay(tmp_path, monkeypatch, "iage", ["iage"]) == 3


@pytest.mark.slow
def test_kill_replay_multi_module(tmp_path, monkeypatch):
    _kill_replay(tmp_path, monkeypatch, "dye_decay_{suff}:004:005",
                 ["dye_decay_004", "dye_decay_005"],
                 extra_args=("--newton_rel_tol", "1.0e-6"))
