"""the port's file-backed Newton-Krylov path for py_driver_2d held against
the JAX package on the same inputs, and against the committed ci
baselines, on the CPU (--device cpu).

The banded Jacobians (transport_bands in both cell orders, each module's
build_jac_bands) are held to JAX's and to the port's own dense Jacobians
under band_info's permutation.  comp_fcn integrates each module with the
banded Radau year; over 30 days (a time_range subclass in both packages)
its F and history files are held to JAX's at baseline_cmp's defaults, as
are the preconditioners' results and phosphorus's precond_null_space.nc.
setup_solver's grid-vars file is held to JAX's and to both ci baselines'.
The full-year setups and the solves are slow-marked, as their JAX
counterparts are.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import newton_krylov_ooc_tpu.cli.baseline_cmp as jax_baseline_cmp
import newton_krylov_ooc_tpu.config.model_config as jax_model_config
import newton_krylov_ooc_tpu.config.share as jax_share
import newton_krylov_ooc_tpu.core.newton as jax_newton
import newton_krylov_ooc_tpu.models.py_driver_2d.forced as jax_forced
import newton_krylov_ooc_tpu.models.py_driver_2d.model_state as jax_model_state
import newton_krylov_ooc_tpu.models.py_driver_2d.setup_solver as jax_setup
from newton_krylov_ooc_tpu.core.spatial_axis import (
    spatial_axis_defn_dict as jax_axis_defn,
    spatial_axis_from_defn_dict as jax_axis_from_defn,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import iage as jax_iage
from newton_krylov_ooc_tpu.models.py_driver_2d import phosphorus as jax_phos
from newton_krylov_ooc_tpu.models.py_driver_2d import physics as jax_physics
from newton_krylov_ooc_tpu.ops.banded import dense_to_bands
import newton_krylov_ooc_tpu_torch.cli.baseline_cmp as port_baseline_cmp
import newton_krylov_ooc_tpu_torch.config.model_config as port_model_config
import newton_krylov_ooc_tpu_torch.config.share as port_share
import newton_krylov_ooc_tpu_torch.core.newton as port_newton
import newton_krylov_ooc_tpu_torch.models.py_driver_2d.forced as port_forced
import newton_krylov_ooc_tpu_torch.models.py_driver_2d.model_state as port_model_state
import newton_krylov_ooc_tpu_torch.models.py_driver_2d.setup_solver as port_setup
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import iage as port_iage
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import phosphorus as port_phos
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import grid_from_numpy
from newton_krylov_ooc_tpu_torch.utils.ncio import NCFile

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
BASELINES = os.path.join(REPO, "baselines")
INPUT = os.path.join(REPO, "input", "py_driver_2d")
TOLS = (port_baseline_cmp.DEFAULT_RTOL, port_baseline_cmp.DEFAULT_ATOL)
BAND_TOL = 1e-13  # banded against dense, relative to the Jacobian's max
MONTH = 30 * 86400.0
# the small grid of the 30-day comparisons (z-major: ny <= nz)
SMALL = {"depth_nlevs": 6, "ypos_nlevs": 4}

PACKAGES = {
    "jax": (jax_share, jax_model_config, jax_model_state, jax_setup,
            jax_newton, jax_forced, ()),
    "port": (port_share, port_model_config, port_model_state, port_setup,
             port_newton, port_forced, ("--device", "cpu")),
}

FORCED_OPTS = {
    "const_decay": {
        "forced_surf_restore_opt": "const",
        "forced_surf_restore_const": "1.0",
        "forced_sms_opt": "decay",
        "forced_sms_decay_rate": "1.0 / (100.0 * 86400.0)",
    },
    "file": {
        "forced_surf_restore_opt": "file",
        "forced_surf_restore_fname": os.path.join(INPUT, "po4_surf.nc"),
        "forced_surf_restore_varname": "po4",
        "forced_sms_opt": "file",
        "forced_sms_fname": os.path.join(INPUT, "po4_sms.nc"),
        "forced_sms_varname": "po4_sms",
        "forced_sink_thres": "1.0e-3",
    },
}


def _reset_classes():
    port_model_state.ModelState.reset_class_state()
    state = jax_model_state.ModelState
    state.model_config_obj = None
    state.depth = None
    state.ypos = None
    state._integrate_cache = {}
    state._jac_cache = {}
    state._grids = {}
    jax_forced.forced._params_cache = {}


@pytest.fixture(autouse=True)
def _isolate_model_state():
    """the py_driver_2d ModelStates keep their axes, config and integrators
    on the class; start and leave each test without them"""
    _reset_classes()
    yield
    _reset_classes()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """the tensors are small: one intra-op thread"""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _setup(pkg_name, workdir, modules, modelinfo=None, persist=True):
    """a py_driver_2d workdir configured through one package's modules, its
    grid-vars file from that package's setup_solver; returns the cfg"""
    share, model_config, model_state, setup, _newton, _forced, device = \
        PACKAGES[pkg_name]
    os.makedirs(workdir, exist_ok=True)
    override = os.path.join(str(workdir), "override.cfg")
    lines = ["[modelinfo]"] + [f"{key} = {val}"
                               for key, val in (modelinfo or SMALL).items()]
    with open(override, "w") as fptr:
        fptr.write("\n".join(lines) + "\n")
    cfg_fnames = ",".join([os.path.join(INPUT, "newton_krylov.cfg"),
                           os.path.join(INPUT, "model_params.cfg"), override])
    args_list = ["--cfg_fnames", cfg_fnames, "--workdir", str(workdir),
                 "--tracer_module_names", modules, *device]
    if persist:
        args_list.append("--persist")
    parser, args_remaining = share.common_args("tests", "py_driver_2d", args_list)
    args = parser.parse_args(args_remaining)
    config = share.read_cfg_files(args)
    setup.gen_grid_vars_file(args, config["modelinfo"])
    model_state.ModelState.model_config_obj = model_config.ModelConfig(
        config["modelinfo"])
    return config


def _month_class(pkg_name):
    class Month(PACKAGES[pkg_name][2].ModelState):
        """F over the first 30 days"""

        time_range = (0.0, MONTH)

    return Month


# -- band layouts ------------------------------------------------------------------


def _grids(nz, ny):
    """the JAX grid at (nz, ny) and the port's from the same fields"""
    depth = jax_axis_from_defn(jax_axis_defn(
        axisname="depth", units="m", nlevs=nz, edge_start=0.0, edge_end=4000.0,
        delta_ratio_max=19.0))
    ypos = jax_axis_from_defn(jax_axis_defn(
        axisname="ypos", units="m", nlevs=ny, edge_start=0.0, edge_end=50.0e5,
        delta_ratio_max=1.0))
    grid = jax_physics.make_grid(depth, ypos, {"max_abs_vvel": "0.1",
                                               "horiz_mix_coeff": "1000.0"},
                                 dtype=jnp.float64)
    port = grid_from_numpy({k: np.asarray(v) for k, v in grid._asdict().items()},
                           device="cpu", dtype=torch.float64)
    return depth, ypos, grid, port


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("nz, ny", [(9, 5), (5, 9)])
def test_transport_bands_match_jax(nz, ny):
    _depth, _ypos, grid, port = _grids(nz, ny)
    t = 0.37 * physics.SEC_PER_YEAR
    dense = physics.transport_jac(port, t).numpy()
    bands = physics.transport_bands(port, t).numpy()
    assert _rel(bands, jax_physics.transport_bands(grid, t)) < BAND_TOL
    assert _rel(bands, dense_to_bands(dense, ny)) < BAND_TOL
    perm = physics.ymajor_perm(nz, ny)
    ymajor = physics.transport_bands_ymajor(port, t).numpy()
    assert _rel(ymajor, jax_physics.transport_bands_ymajor(grid, t)) < BAND_TOL
    assert _rel(ymajor, dense_to_bands(dense[np.ix_(perm, perm)], nz)) < BAND_TOL


def _module_args(name, depth, ypos):
    """(port class, JAX class, static args) of a tracer module"""
    if name == "iage":
        return (port_iage.iage, jax_iage.iage,
                (jax_iage.surf_restore_rate(depth),))
    if name == "phosphorus":
        p = jax_phos.DEFAULT_PARAMS
        return (port_phos.phosphorus, jax_phos.phosphorus,
                (*(p[key] for key in p),
                 tuple(jax_phos.light_lim_2d(depth, ypos).reshape(-1))))
    params = jax_forced.gen_forced_params(FORCED_OPTS["file"], depth, ypos)
    tables = {"surf_restore": params["surf_restore_table"],
              "sms": params["sms_table"]}
    static = ("file", params["surf_restore_rate"], 0.0, "file", 0.0, 0.0,
              params["sink_thres"])
    return (port_forced.forced, jax_forced.forced,
            static + (jax_forced._HashableTables(tables),),
            static + (port_forced._HashableTables(tables),))


@pytest.mark.parametrize("nz, ny", [(9, 5), (5, 9)])
@pytest.mark.parametrize("name", ["iage", "forced", "phosphorus"])
def test_build_jac_bands_match_jax_and_dense(name, nz, ny):
    """each module's banded Jacobian against JAX's and against the port's
    dense build_jac under band_info's permutation, z-major and y-major"""
    depth, ypos, grid, port = _grids(nz, ny)
    cls, jax_cls, static, *port_static = _module_args(name, depth, ypos)
    port_static = port_static[0] if port_static else static
    bw, perm = cls.band_info(port)
    jax_bw, jax_perm = jax_cls.band_info(grid)
    assert bw == jax_bw and np.array_equal(perm, jax_perm)
    n_trc = len(perm) // (nz * ny)
    rng = np.random.default_rng(11)
    y = np.abs(rng.standard_normal(n_trc * nz * ny)) * 2e-3 + 1e-4
    t = 0.37 * physics.SEC_PER_YEAR
    bands = cls.build_jac_bands(port, port_static, None)(
        torch.as_tensor(t), torch.as_tensor(y[perm])).numpy()
    jax_bands = np.asarray(jax_cls.build_jac_bands(grid, static, jnp.zeros(0))(
        t, jnp.asarray(y[perm])))
    assert bands.shape == jax_bands.shape
    assert _rel(bands, jax_bands) < BAND_TOL
    dense = cls.build_jac(port, port_static, None)(
        torch.as_tensor(t), torch.as_tensor(y)).numpy()
    assert _rel(dense, jax_cls.build_jac(grid, static, jnp.zeros(0))(
        t, jnp.asarray(y))) < BAND_TOL
    if bands.shape[0] == 1:
        want = dense_to_bands(dense[np.ix_(perm, perm)], bw)[None]
    else:  # one block a tracer
        m = nz * ny
        want = np.stack([dense_to_bands(
            dense[np.ix_(perm[k * m:(k + 1) * m], perm[k * m:(k + 1) * m])], bw)
            for k in range(bands.shape[0])])
    assert _rel(bands, want) < BAND_TOL


# -- setup_solver's grid file -------------------------------------------------------


@pytest.mark.parametrize("name, modelinfo", [
    ("iage", {"depth_nlevs": 30, "ypos_nlevs": 30}),
    ("iage_column_regions", {"depth_nlevs": 20, "ypos_nlevs": 3,
                             "max_abs_vvel": 0.0, "horiz_mix_coeff": 0.0}),
])
def test_grid_vars_file_matches_jax_and_baselines(tmp_path, name, modelinfo):
    """both region-mask branches: one region, and one a column when
    lateral transport is off"""
    files = {}
    for pkg in PACKAGES:
        config = _setup(pkg, tmp_path / pkg, "iage", modelinfo)
        files[pkg] = config["modelinfo"]["grid_vars_fname"]
    baseline = os.path.join(BASELINES, f"ci_py_driver_2d_{name}", "grid_vars.nc")
    for cmp in (port_baseline_cmp.compare, jax_baseline_cmp.compare):
        assert cmp(files["port"], files["jax"], *TOLS)
        assert cmp(files["port"], baseline, *TOLS)
    with NCFile(files["port"]) as fptr:
        assert fptr.var("region_mask")[:].max() == (3 if "column" in name else 1)


# -- comp_fcn over 30 days, and the preconditioners --------------------------------


def _comp_fcn_month(tmp_path, modules, modelinfo=None, precond=False):
    """F and its history over 30 days from gen_init_iterate through each
    package's comp_fcn, and with precond the preconditioner applied to F
    from the history; {package: workdir}"""
    out = {}
    for pkg in PACKAGES:
        workdir = tmp_path / pkg
        _setup(pkg, workdir, modules, {**SMALL, **(modelinfo or {})})
        state = _month_class(pkg)("gen_init_iterate")
        fcn = state.comp_fcn(str(workdir / "fcn.nc"), None, str(workdir / "hist.nc"))
        if precond:
            state.gen_precond_jacobian(str(workdir / "hist.nc"),
                                       str(workdir / "precond.nc"),
                                       solver_state=None)
            fcn.apply_precond_jacobian(str(workdir / "precond.nc"),
                                       str(workdir / "precond_res.nc"),
                                       solver_state=None)
        out[pkg] = workdir
        _reset_classes()
    return out


def _compare(out, names):
    for fname in names:
        port_out, jax_out = str(out["port"] / fname), str(out["jax"] / fname)
        assert port_baseline_cmp.compare(port_out, jax_out, *TOLS), fname
        assert jax_baseline_cmp.compare(port_out, jax_out, *TOLS), fname


@pytest.mark.parametrize("modules", ["iage", "phosphorus"])
def test_comp_fcn_month_and_precond_match_jax(tmp_path, modules):
    """F, its 61-sample history and the preconditioned F over 30 days;
    phosphorus's precond_null_space.nc too (the eigen iterations through
    the banded LU)"""
    out = _comp_fcn_month(tmp_path, modules, precond=True)
    names = ["fcn.nc", "hist.nc", "precond_res.nc"]
    if modules == "phosphorus":
        names.append("precond_null_space.nc")
    _compare(out, names)


@pytest.mark.parametrize("opts", sorted(FORCED_OPTS))
def test_forced_comp_fcn_month_matches_jax(tmp_path, opts):
    """the forced family: constant restoring with decay, and restoring and
    sources from input/py_driver_2d/po4_*.nc with the sink threshold"""
    _compare(_comp_fcn_month(tmp_path, "forced_{suff}:alpha", FORCED_OPTS[opts]),
             ["fcn.nc", "hist.nc"])


def test_comp_fcn_dtype_float32_month(tmp_path):
    """comp_fcn_dtype=float32, the counterpart of JAX's
    test_comp_fcn_dtype_float32_smoke over 30 days: within 1e-2 of the
    float64 F (uncompensated float32 stepping at the reference
    tolerance), on the same device and path"""
    results = {}
    for dtype_name in ("float64", "float32"):
        workdir = tmp_path / dtype_name
        _setup("port", workdir, "iage", {**SMALL, "comp_fcn_dtype": dtype_name})
        state = _month_class("port")("gen_init_iterate")
        fcn = state.comp_fcn(str(workdir / "fcn.nc"), None)
        results[dtype_name] = fcn.tracer_modules[0].get_tracer_vals("iage")
        _reset_classes()
    a, b = results["float32"], results["float64"]
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-2
    assert np.abs(b).max() > 0.0


def test_radau_year_log_and_device(tmp_path, caplog):
    """each year logs its counts on the device it ran on; the card's route
    raises without a card, with nothing falling back to the CPU"""
    _setup("port", tmp_path / "w", "iage")
    with caplog.at_level("INFO", logger=port_model_state.__name__):
        _month_class("port")("gen_init_iterate").comp_fcn(
            str(tmp_path / "fcn.nc"), None)
    assert "radau year: module=iage device=cpu attempts=" in caplog.text
    assert "lu_launches=0" in caplog.text
    if not torch.cuda.is_available():
        _reset_classes()
        _setup("port", tmp_path / "c", "iage")
        port_model_state.ModelState.model_config_obj.modelinfo["device"] = "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            _month_class("port")("gen_init_iterate").comp_fcn(
                str(tmp_path / "c.nc"), None)


# -- full years and solves (slow, as in the JAX package) ---------------------------


def _ci_setup(workdir, modelinfo, extra=()):
    """the port's setup_solver as scripts/ci_py_driver_2d_*.sh run it, on
    the CPU"""
    os.makedirs(workdir, exist_ok=True)
    override = os.path.join(str(workdir), "override.cfg")
    with open(override, "w") as fptr:
        fptr.write("\n".join(["[modelinfo]"] + [f"{k} = {v}" for k, v in
                                               modelinfo.items()]) + "\n")
    cfg_fnames = ",".join([os.path.join(INPUT, "newton_krylov.cfg"),
                           os.path.join(INPUT, "model_params.cfg"), override])
    port_setup.main(port_setup.parse_args(
        ["--fp_cnt", "1", "--model_name", "py_driver_2d",
         "--tracer_module_names", "iage", "--cfg_fnames", cfg_fnames,
         "--workdir", str(workdir), "--device", "cpu", *extra]))


def _cmp_files(expr_dir, baseline, names, rtol=TOLS[0], atol=TOLS[1]):
    for name in names:
        assert port_baseline_cmp.compare(
            os.path.join(expr_dir, name), os.path.join(BASELINES, baseline, name),
            rtol, atol), name


@pytest.mark.slow
def test_ci_py_driver_2d_iage_setup(tmp_path):
    """scripts/ci_py_driver_2d_iage.sh through the port: the 30 x 30 setup
    with one fixed-point year, its five files at the script's tolerances"""
    workdir = tmp_path / "ci_py_driver_2d_iage_workdir"
    _ci_setup(workdir, {"depth_nlevs": 30, "ypos_nlevs": 30})
    _cmp_files(str(workdir), "ci_py_driver_2d_iage", ["grid_vars.nc"])
    _cmp_files(str(workdir / "gen_init_iterate"), "ci_py_driver_2d_iage",
               ["fcn_0000.nc", "hist_0000.nc", "init_iterate.nc",
                "init_iterate_0000.nc"], rtol=1.0e-3, atol=1.0e-6)


@pytest.mark.slow
def test_ci_py_driver_2d_iage_column_regions_solve(tmp_path):
    """scripts/ci_py_driver_2d_iage_column_regions.sh through the port:
    setup, nk_driver.sh to convergence, every file the script compares at
    its tolerances, Newton_state.json byte for byte after the workdir
    rewrite"""
    name = "ci_py_driver_2d_iage_column_regions"
    workdir = tmp_path / f"{name}_workdir"
    _ci_setup(workdir, {"depth_nlevs": 20, "ypos_nlevs": 3, "max_abs_vvel": 0.0,
                        "horiz_mix_coeff": 0.0}, ["--persist"])
    _cmp_files(str(workdir), name, ["grid_vars.nc"])
    _cmp_files(str(workdir / "gen_init_iterate"), name,
               ["fcn_0000.nc", "hist_0000.nc", "init_iterate.nc",
                "init_iterate_0000.nc"], rtol=1.0e-3, atol=1.0e-6)
    subprocess.run([str(workdir / "nk_driver.sh")], check=True, timeout=3000)
    krylov = str(workdir / "krylov_00")
    _cmp_files(krylov, name, ["precond_00.nc"])
    _cmp_files(krylov, name, ["precond_fcn_00.nc"], rtol=2.0e-3)
    _cmp_files(krylov, name, ["basis_00.nc"], atol=5.0e-5)
    _cmp_files(krylov, name, ["perturb_fcn_w_raw_00.nc"], atol=5.0e-6)
    _cmp_files(krylov, name, ["krylov_res_00.nc"], rtol=1.9e-2)
    _cmp_files(str(workdir), name, ["increment_00.nc", "iterate_01.nc"],
               rtol=1.9e-2)
    with open(workdir / "Newton_state.json") as fptr:
        log = fptr.read().replace(str(workdir), f"HOME/{name}_workdir")
    with open(os.path.join(BASELINES, name, "Newton_state.json")) as fptr:
        assert log == fptr.read()


def _full_solve(pkg_name, workdir, modules, modelinfo, rel_tol, max_iter):
    config = _setup(pkg_name, workdir, modules, modelinfo)
    config["solverinfo"]["newton_rel_tol"] = rel_tol
    config["solverinfo"]["newton_max_iter"] = max_iter
    model_state, newton = PACKAGES[pkg_name][2], PACKAGES[pkg_name][4]
    init_fname = config["solverinfo"]["init_iterate_fname"]
    os.makedirs(os.path.dirname(init_fname), exist_ok=True)
    model_state.ModelState("gen_init_iterate").dump(init_fname, caller="tests")
    solver = newton.NewtonSolver(model_state.ModelState,
                                 solverinfo=config["solverinfo"], resume=False,
                                 rewind=False)
    while not solver.converged().all():
        solver.step()
    return solver


@pytest.mark.slow
@pytest.mark.parametrize("modules, modelinfo, rel_tol, max_iter", [
    ("phosphorus", {"depth_nlevs": 12, "ypos_nlevs": 10}, "1.0e-3", "4"),
    ("forced_{suff}:alpha", {"depth_nlevs": 12, "ypos_nlevs": 10,
                             **FORCED_OPTS["const_decay"]}, "1.0e-5", "5"),
])
def test_full_solve_matches_jax(tmp_path, modules, modelinfo, rel_tol, max_iter):
    """the counterparts of tests/test_eigen.py's phosphorus solve and
    tests/test_forced_module.py's decay solve, through both packages: the
    same Newton count and iterates within the solve's newton_rel_tol of
    max|x| (the two packages' eigen iterations and Radau step sequences
    round differently, so each stops at its own iterate within the
    stopping tolerance: phosphorus's differ by 8.2e-6 of max|x| on the
    CPU), phosphorus's null-space file written and po4 positive, alpha
    within [0, 1]"""
    solvers = {}
    for pkg in PACKAGES:
        solvers[pkg] = _full_solve(pkg, tmp_path / pkg, modules, modelinfo,
                                   rel_tol, max_iter)
        _reset_classes()
    assert solvers["port"].get_iteration() == solvers["jax"].get_iteration()
    assert solvers["port"].get_iteration() <= int(max_iter)
    port_x = solvers["port"]._iterate.tracer_modules[0].get_tracer_vals_all()
    jax_x = solvers["jax"]._iterate.tracer_modules[0].get_tracer_vals_all()
    assert _rel(port_x, jax_x) < float(rel_tol)
    if modules == "phosphorus":
        krylov = sorted(d for d in os.listdir(tmp_path / "port")
                        if d.startswith("krylov_"))
        assert os.path.exists(tmp_path / "port" / krylov[0] / "precond_null_space.nc")
        assert port_x[0].min() > 0.0
    else:
        assert port_x.max() <= 1.0 + 1e-6 and port_x.min() >= -1e-9
    with open(tmp_path / "port" / "Newton_state.json") as fptr:
        assert json.load(fptr)["iteration"] == solvers["port"].get_iteration()
