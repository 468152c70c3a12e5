"""the port's file-backed irf_offline path held against the JAX package's on
the same files, on the CPU (--device cpu): bicgstab, the synthetic
circulation and grid_vars files, the tracer modules' rate specs and rate
fields, comp_fcn's result and hist files, apply_precond_jacobian's result,
the model class's discovery, run_cmd's three commands and its profiler
trace.  The tier-1 cases run 4 x 6 x 8 with 4 seasonal months over a model
period cut to 48 steps (4 a hist segment) at the circulation's stable step;
the full solves (the ci cfg, the dense oracle, kill-replay) are
slow-marked, as their JAX counterparts (tests/test_irf_offline.py) are.
"""

import configparser
import os
import subprocess

import numpy as np
import pytest
import torch

import newton_krylov_ooc_tpu.config.model_config as jax_model_config
import newton_krylov_ooc_tpu.models.irf_offline.model_state as jax_model_state
import newton_krylov_ooc_tpu.models.irf_offline.synthetic as jax_synthetic
import newton_krylov_ooc_tpu.ops.sparse as jax_sparse
import newton_krylov_ooc_tpu_torch.cli.run_cmd as port_run_cmd
import newton_krylov_ooc_tpu_torch.config.model_config as port_model_config
import newton_krylov_ooc_tpu_torch.core.newton as port_newton
import newton_krylov_ooc_tpu_torch.core.solver_state as port_solver_state
import newton_krylov_ooc_tpu_torch.core.state as port_state
import newton_krylov_ooc_tpu_torch.models.irf_offline.model_state as port_model_state
import newton_krylov_ooc_tpu_torch.models.irf_offline.synthetic as port_synthetic
import newton_krylov_ooc_tpu_torch.ops.sparse as port_sparse
import newton_krylov_ooc_tpu_torch.utils.ncio as port_ncio

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
DEFS = os.path.join(REPO, "input", "irf_offline", "tracer_module_defs.yaml")
NZ, NLAT, NLON, MONTHS = 4, 6, 8, 4
YEAR = 365.0 * 86400.0
F64_TOL = 1e-12   # relative to max: the same float64 arithmetic
PC_TOL = 1e-10    # relative: BiCGSTAB and PCR in another summation order
STEPS = 48        # 4 steps a hist segment (13 samples, 12 segments)

PACKAGES = {
    "jax": (jax_model_config, jax_model_state),
    "port": (port_model_config, port_model_state),
}


def _circ(with_land=True):
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    if with_land:
        mask[:, 2, 3] = 0       # an island column
        mask[2:, 4, 5] = 0      # a seamount
    return port_synthetic.gen_circulation(NZ, NLAT, NLON, mask=mask,
                                          n_seasons=MONTHS)


@pytest.fixture(autouse=True)
def _isolate_model_state(monkeypatch):
    """both ModelStates keep their config and circulation on the class;
    start and leave each test without them.  The model period is cut to
    STEPS steps at the circulation's stable step (a tenth of a year or
    so), so that a hist segment takes 4 steps"""
    period = STEPS * YEAR / port_synthetic.stable_steps_per_year(_circ())
    for _cfg, model_state in PACKAGES.values():
        monkeypatch.setattr(model_state.ModelState, "time_range", (0.0, period))
        model_state.ModelState.model_config_obj = None
        model_state.ModelState._circ_key = None
    yield
    for _cfg, model_state in PACKAGES.values():
        model_state.ModelState.model_config_obj = None
        model_state.ModelState._circ_key = None


def _build_config(pkg_name, workdir, tracer_module_names="iage",
                  steps=STEPS):
    """tests/test_irf_offline.py::_build_config through one package: the
    circulation and grid_vars written by the port's synthetic module, the
    cfg's modelinfo as the package's ModelConfig; returns the cfg"""
    model_config, model_state = PACKAGES[pkg_name]
    os.makedirs(workdir, exist_ok=True)
    irf_fname = os.path.join(workdir, "irf_mean.nc")
    grid_vars_fname = os.path.join(workdir, "grid_vars.nc")
    if not os.path.exists(irf_fname):
        circ = _circ()
        port_synthetic.write_circulation(irf_fname, circ)
        port_synthetic.write_grid_vars(grid_vars_fname, circ)
    config = configparser.ConfigParser(
        {"HOME": str(workdir), "USER": "tester",
         "logging_reproducible": "False"}, allow_no_value=True)
    config["DEFAULT"].update({"model_name": "irf_offline",
                              "workdir": str(workdir)})
    config["solverinfo"] = {
        "cfg_out_fname": os.path.join(workdir, "cfg.out"),
        "logging_fname": os.path.join(workdir, "nk.log"),
        "logging_level": "INFO",
        "logging_reproducible": "False",
        "init_iterate_fname": os.path.join(workdir, "init_iterate.nc"),
        "newton_rel_tol": "1.0e-7",
        "newton_max_iter": "8",
        "post_newton_fp_iter": "1",
        "krylov_rel_tol": "1.0e-6",
    }
    config["modelinfo"] = {
        "reinvoke": "False",
        "invoker_script_fname": os.path.join(workdir, "nk_driver.sh"),
        "irf_fname": irf_fname,
        "grid_vars_fname": grid_vars_fname,
        "circ_adv_type": "upwind3",
        "steps_per_year": str(steps),
        "comp_fcn_dtype": "float64",
        "tracer_module_names": tracer_module_names,
        "tracer_module_defs_fname": DEFS,
        "device": "cpu",
    }
    model_state.ModelState.model_config_obj = None
    model_state.ModelState._circ_key = None
    model_state.ModelState.model_config_obj = model_config.ModelConfig(
        config["modelinfo"])
    return config


def _state(pkg_name, fname):
    return PACKAGES[pkg_name][1].ModelState(fname)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale > 0 else 1.0)


def _files_match(ours, ref, tol):
    """the same variables with the same dims and attributes, values within
    tol of each variable's max"""
    with port_ncio.NCFile(ours) as fo, port_ncio.NCFile(ref) as fr:
        assert sorted(fo.variables) == sorted(fr.variables)
        for name in fr.variables:
            vo, vr = fo.var(name), fr.var(name)
            assert vo.dimensions == vr.dimensions, name
            assert vo.attrs == vr.attrs, name
            assert _rel(vo[:], vr[:]) <= tol, name


# -- ops/sparse.py::bicgstab ------------------------------------------------------


@pytest.mark.parametrize("precond", [False, True])
def test_bicgstab_matches_jax(precond):
    """a nonsymmetric, diagonally dominant operator, with and without a
    Jacobi preconditioner: the JAX package's iterate count, solutions
    within 1e-10, and its zero-right-hand-side and breakdown exits"""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 40
    a = rng.normal(size=(n, n)) + np.diag(np.full(n, 12.0))
    b = rng.normal(size=n)
    d_inv = 1.0 / np.diag(a)
    ja, jd = jnp.asarray(a), jnp.asarray(d_inv)
    ta, td = torch.as_tensor(a), torch.as_tensor(d_inv)
    ref = jax_sparse.bicgstab(lambda v: ja @ v, jnp.asarray(b),
                              precond=(lambda v: jd * v) if precond else None,
                              rtol=1e-12)
    x, ok, k = port_sparse.bicgstab(lambda v: ta @ v, torch.as_tensor(b),
                                    precond=(lambda v: td * v) if precond
                                    else None, rtol=1e-12)
    assert bool(ok) and bool(ref[1]) and k == int(ref[2]) > 1
    assert _rel(x, ref[0]) < PC_TOL
    assert np.abs(a @ x.numpy() - b).max() < 1e-10 * np.abs(b).max()
    # a zero right-hand side converges at once; max_iter stops the loop
    zero = port_sparse.bicgstab(lambda v: ta @ v, torch.zeros(n,
                                                              dtype=torch.float64))
    assert bool(zero[1]) and zero[2] == 0 and not zero[0].any()
    capped = port_sparse.bicgstab(lambda v: ta @ v, torch.as_tensor(b),
                                  max_iter=2)
    assert capped[2] == 2 and not bool(capped[1])
    # a singular operator breaks down (omega = 0) as JAX's does
    broke = port_sparse.bicgstab(lambda v: 0.0 * v, torch.as_tensor(b))
    jbroke = jax_sparse.bicgstab(lambda v: 0.0 * v, jnp.asarray(b))
    assert broke[2] == int(jbroke[2]) == 1 and not bool(broke[1])


# -- synthetic files --------------------------------------------------------------


def test_synthetic_files_match_jax(tmp_path):
    """write_circulation / write_grid_vars of one seasonal circulation
    through both packages: the same files var for var, bit for bit"""
    circ = _circ()
    assert all(np.array_equal(circ[k], v) for k, v in jax_synthetic.gen_circulation(
        NZ, NLAT, NLON, mask=circ["mask"], n_seasons=MONTHS).items())
    for name, writer in (("irf", "write_circulation"),
                         ("grid", "write_grid_vars")):
        ours, ref = tmp_path / f"{name}_port.nc", tmp_path / f"{name}_jax.nc"
        getattr(port_synthetic, writer)(str(ours), circ, "tests")
        getattr(jax_synthetic, writer)(str(ref), circ, "tests")
        _files_match(str(ours), str(ref), 0.0)
    with port_ncio.NCFile(str(tmp_path / "irf_port.nc")) as fptr:
        assert fptr.dim_len("month") == MONTHS
        assert fptr.var("VDC").dimensions == ("month", "z_t", "nlat", "nlon")


# -- the model --------------------------------------------------------------------


def test_model_class_is_found():
    cls = port_state.get_model_state_class("irf_offline")
    assert cls is port_model_state.ModelState


@pytest.mark.parametrize("modules", ["iage", "abio_dic_dic14"])
def test_rate_specs_and_module_rates_match_jax(tmp_path, modules):
    """the YAML specs and their rate fields, uncoupled (iage) and coupled
    (abio_dic_dic14's cross-tracer gas exchange)"""
    res = {}
    for pkg in PACKAGES:
        _build_config(pkg, tmp_path / "w", modules)
        state = _state(pkg, "gen_init_iterate")
        tm = state.tracer_modules[0]
        res[pkg] = (tm.rate_specs(), state._module_rates(tm),
                    tm.get_tracer_vals_all(), tm.surf_flux_names())
    (specs, rates, vals, flux), (jspecs, jrates, jvals, jflux) = (
        res["port"], res["jax"])
    assert specs == jspecs and flux == jflux
    assert np.array_equal(vals, jvals)
    for ours, ref in zip(rates, jrates):
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert np.array_equal(ours, np.asarray(ref))
    assert (rates[2] is not None) == (modules == "abio_dic_dic14")


def _perturbed(pkg, seed=1):
    """the initial iterate plus seeded noise on the wet cells"""
    state = _state(pkg, "gen_init_iterate")
    mask = _circ()["mask"] > 0
    for ind, tm in enumerate(state.tracer_modules):
        vals = tm.get_tracer_vals_all()
        noise = np.random.default_rng(seed + ind).uniform(
            0.0, 0.2, vals.shape) * mask
        tm.set_tracer_vals_all(vals + noise * np.abs(vals).max(),
                               reseat_vals=True)
    return state


@pytest.mark.parametrize("modules", ["iage", "abio_dic_dic14"])
def test_comp_fcn_files_match_jax(tmp_path, modules):
    """comp_fcn's result and hist files (13 samples; for abio_dic_dic14 the
    gas-exchange and Delta-14C diagnostics) on the seasonal circulation,
    var for var"""
    for pkg in PACKAGES:
        _build_config(pkg, tmp_path / "w", modules)
        state = _perturbed(pkg)
        state.comp_fcn(str(tmp_path / f"fcn_{pkg}.nc"), None,
                       hist_fname=str(tmp_path / f"hist_{pkg}.nc"))
    _files_match(str(tmp_path / "fcn_port.nc"), str(tmp_path / "fcn_jax.nc"),
                 F64_TOL)
    _files_match(str(tmp_path / "hist_port.nc"), str(tmp_path / "hist_jax.nc"),
                 F64_TOL)
    with port_ncio.NCFile(str(tmp_path / "hist_port.nc")) as fptr:
        assert fptr.dim_len("time") == port_model_state.HIST_TIME_SAMPLES
        assert fptr.has_var("SF_ABIO_DIC_horiz_int") == (modules != "iage")


def test_apply_precond_jacobian_files_match_jax(tmp_path, caplog):
    """apply_precond_jacobian's BiCGSTAB solves, per tracer (iage) and
    joint (abio_dic_dic14), from seeded right-hand sides"""
    modules = "iage,abio_dic_dic14"
    caplog.set_level("INFO")
    for pkg in PACKAGES:
        _build_config(pkg, tmp_path / "w", modules)
        rhs = _perturbed(pkg, seed=7)
        rhs.apply_precond_jacobian(None, str(tmp_path / f"pc_{pkg}.nc"), None)
    _files_match(str(tmp_path / "pc_port.nc"), str(tmp_path / "pc_jax.nc"),
                 PC_TOL)
    logged = [rec.getMessage() for rec in caplog.records
              if "bicgstab_iterations" in rec.getMessage()]
    assert len(logged) == 2


# -- run_cmd ----------------------------------------------------------------------


def _run_cmd_workdir(tmp_path):
    """a workdir with a cfg file, the circulation and an initial iterate"""
    workdir = tmp_path / "w"
    config = _build_config("port", workdir, "iage,abio_dic_dic14")
    cfg_fname = str(workdir / "irf.cfg")
    with open(cfg_fname, "w") as fptr:
        config.write(fptr)
    _perturbed("port").dump(
        config["solverinfo"]["init_iterate_fname"], caller="tests")
    return workdir, cfg_fname, config


def _run_cmd(cfg_fname, workdir, *args):
    port_run_cmd.main(port_run_cmd.parse_args(
        ["--model_name", "irf_offline", "--cfg_fnames", cfg_fname,
         "--device", "cpu", *args, "--fname_dir", str(workdir)]))


def test_run_cmd_commands(tmp_path):
    """comp_fcn (with a hist file), gen_precond_jacobian and
    apply_precond_jacobian through run_cmd: the same files as the model
    state's own calls"""
    workdir, cfg_fname, config = _run_cmd_workdir(tmp_path)
    init = config["solverinfo"]["init_iterate_fname"]
    _run_cmd(cfg_fname, workdir, "comp_fcn", "--in_fname", init,
             "--res_fname", "fcn.nc", "--hist_fname", "hist.nc")
    _run_cmd(cfg_fname, workdir, "gen_precond_jacobian", "--in_fname", init,
             "--hist_fname", "hist.nc", "--precond_fname", "precond.nc")
    _run_cmd(cfg_fname, workdir, "apply_precond_jacobian", "--in_fname",
             "fcn.nc", "--precond_fname", "precond.nc", "--res_fname",
             "pc.nc")
    assert os.path.exists(workdir / "precond.nc")
    # the same calls on the model state directly
    port_model_state.ModelState.model_config_obj = None
    port_model_state.ModelState._circ_key = None
    _build_config("port", workdir, "iage,abio_dic_dic14")
    state = port_model_state.ModelState(init)
    state.comp_fcn(str(tmp_path / "fcn_direct.nc"), None,
                   hist_fname=str(tmp_path / "hist_direct.nc"))
    _files_match(str(workdir / "fcn.nc"), str(tmp_path / "fcn_direct.nc"), 0.0)
    _files_match(str(workdir / "hist.nc"), str(tmp_path / "hist_direct.nc"),
                 0.0)
    port_model_state.ModelState(str(workdir / "fcn.nc")).apply_precond_jacobian(
        None, str(tmp_path / "pc_direct.nc"), None)
    _files_match(str(workdir / "pc.nc"), str(tmp_path / "pc_direct.nc"), 0.0)


def test_run_cmd_profile_dir(tmp_path):
    """run_cmd --profile_dir wraps the command in torch.profiler and leaves
    its trace"""
    workdir, cfg_fname, config = _run_cmd_workdir(tmp_path)
    trace_dir = tmp_path / "trace"
    _run_cmd(cfg_fname, workdir, "comp_fcn", "--in_fname",
             config["solverinfo"]["init_iterate_fname"], "--res_fname",
             "fcn.nc", "--profile_dir", str(trace_dir))
    assert os.path.exists(workdir / "fcn.nc")
    traces = [name for name in os.listdir(trace_dir)
              if name.endswith(".trace.json")]
    assert traces and os.path.getsize(trace_dir / traces[0]) > 0


# -- full solves (slow) -----------------------------------------------------------


@pytest.mark.slow
def test_ci_script_on_the_cpu(tmp_path):
    """scripts/ci_torch_irf_offline.sh --device cpu: the ci cfg's solve,
    its stats vars and the --resume fast-forward (err_cnt=0)"""
    env = dict(os.environ, CI_WORKROOT=str(tmp_path))
    out = subprocess.run(
        [os.path.join(REPO, "scripts", "ci_torch_irf_offline.sh"), "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=3000)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "err_cnt=0" in out.stdout


def _drive(config, resume=False):
    solver = port_newton.NewtonSolver(
        port_model_state.ModelState, solverinfo=config["solverinfo"],
        resume=resume, rewind=False)
    while not solver.converged().all():
        solver.step()
    return solver


def _init(config):
    init = port_model_state.ModelState("gen_init_iterate")
    fname = config["solverinfo"]["init_iterate_fname"]
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    init.dump(fname, caller="tests.irf_offline")


@pytest.mark.slow
def test_solve_matches_dense_oracle(tmp_path, monkeypatch):
    """tests/test_irf_offline.py::test_solve_matches_dense_oracle on the
    port, over a full year at the stable step: the Newton-Krylov solve of
    iage against the fixed point of the probed dense year map"""
    monkeypatch.setattr(port_model_state.ModelState, "time_range", (0.0, YEAR))
    circ = _circ()
    config = _build_config("port", tmp_path / "w", "iage",
                           steps=port_synthetic.stable_steps_per_year(circ))
    mask = circ["mask"] > 0
    wet_idx = np.nonzero(mask.reshape(-1))[0]
    n = len(wet_idx)

    def year_map(x_wet):
        state = port_model_state.ModelState("zeros")
        full = np.zeros(mask.size)
        full[wet_idx] = x_wet
        state.tracer_modules[0].set_tracer_vals_all(
            full.reshape((1, NZ, NLAT, NLON)), reseat_vals=True)
        fcn = state.comp_fcn(None, None)
        return fcn.tracer_modules[0].get_tracer_vals_all().reshape(-1)[
            wet_idx] + x_wet

    c_vec = year_map(np.zeros(n))
    b_mat = np.stack([year_map(e) - c_vec for e in np.eye(n)], axis=1)
    x_oracle = np.linalg.solve(np.eye(n) - b_mat, c_vec)

    _init(config)
    solver = _drive(config)
    x_solved = solver._iterate.tracer_modules[0].get_tracer_vals_all().reshape(
        -1)[wet_idx]
    scale = np.abs(x_oracle).max()
    f_solved = b_mat @ x_solved + c_vec - x_solved
    amplified = np.linalg.solve(np.eye(n) - b_mat, f_solved)
    np.testing.assert_allclose(x_solved + amplified, x_oracle, rtol=0.0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(x_solved, x_oracle, rtol=0.0,
                               atol=2.0 * np.abs(amplified).max() + 1e-9 * scale)
    assert solver.get_iteration() <= 6
    assert os.path.exists(tmp_path / "w" / "Newton_stats.nc")


@pytest.mark.slow
def test_kill_replay_irf_offline(tmp_path, monkeypatch):
    """tests/test_irf_offline.py::test_kill_replay_irf_offline on the port:
    the seasonal circulation and the coupled abio_dic_dic14 module over a
    year at the stable step, the solve killed after every step-log append
    and resumed, against an uninterrupted run (the same step logs and
    iterate)"""
    import json

    def logs(workdir):
        out = {}
        names = ["Newton_state.json"] + [
            os.path.join(d, "Krylov_state.json")
            for d in sorted(os.listdir(workdir)) if d.startswith("krylov_")]
        for rel in names:
            with open(os.path.join(workdir, rel)) as fptr:
                out[rel] = [step.replace(str(workdir), "WORKDIR")
                            for step in json.load(fptr)["step_log"]]
        return out

    names = ["ABIO_DIC", "ABIO_DIC14"]
    monkeypatch.setattr(port_model_state.ModelState, "time_range", (0.0, YEAR))
    steps = port_synthetic.stable_steps_per_year(_circ())
    golden_cfg = _build_config("port", tmp_path / "golden", "abio_dic_dic14",
                               steps=steps)
    _init(golden_cfg)
    golden = _drive(golden_cfg)
    golden_vals = {n: golden._iterate.get_tracer_vals(n) for n in names}
    golden_logs = logs(tmp_path / "golden")

    config = _build_config("port", tmp_path / "killed", "abio_dic_dic14",
                           steps=steps)
    _init(config)
    orig_log_step = port_solver_state.SolverState.log_step
    budget = {"appends": 0}

    def killing_log_step(self, stepval, per_iteration=True):
        is_new = not self.step_logged(stepval, per_iteration)
        orig_log_step(self, stepval, per_iteration)
        if is_new:
            budget["appends"] -= 1
            if budget["appends"] <= 0:
                raise SystemExit("killed at step boundary")

    monkeypatch.setattr(port_solver_state.SolverState, "log_step",
                        killing_log_step)
    segments, resume = 0, False
    while True:
        budget["appends"] = 1
        try:
            solver = _drive(config, resume=resume)
            break
        except SystemExit:
            segments += 1
            resume = True
            assert segments < 1000
    assert segments == sum(len(log) for log in golden_logs.values())
    assert solver.get_iteration() == golden.get_iteration()
    assert logs(tmp_path / "killed") == golden_logs
    for n in names:
        np.testing.assert_allclose(solver._iterate.get_tracer_vals(n),
                                   golden_vals[n], rtol=1e-13, atol=0.0)
