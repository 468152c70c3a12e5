"""the port's cime_pop adapter held against the JAX package's on the CPU:
twins of tests/test_cime_pop_hist.py, tests/test_cime_pop_setup.py and
tests/test_ncmean.py (the same inputs through both packages; their files
compared variable by variable, attributes included, without the global
`history` attribute that names the package), setup_solver's main on the mock
CIME case (the invoker script names the port), and the mock CIME case's
Newton solve (tests/cime_mock_case.py) through both adapters:
precond_solver_mode=device in tier 1, the other four modes and the batch
preconditioner slow-marked, as tests/test_cime_pop_adapter.py marks its own.
"""

import os

import numpy as np
import pytest
import torch

import newton_krylov_ooc_tpu.config.model_config as jax_model_config
import newton_krylov_ooc_tpu.core.newton as jax_newton
import newton_krylov_ooc_tpu.models.cime_pop.model_state as jax_ms
import newton_krylov_ooc_tpu.models.cime_pop.setup_solver as jax_ss
import newton_krylov_ooc_tpu.utils.ncmean as jax_ncmean
import newton_krylov_ooc_tpu_torch.config.model_config as port_model_config
import newton_krylov_ooc_tpu_torch.core.newton as port_newton
import newton_krylov_ooc_tpu_torch.models.cime_pop.model_state as port_ms
import newton_krylov_ooc_tpu_torch.models.cime_pop.setup_solver as port_ss
import newton_krylov_ooc_tpu_torch.utils.ncmean as port_ncmean
import cime_mock_case as mock
from newton_krylov_ooc_tpu_torch.utils.ncio import NCFile

NZ, NLAT, NLON = 3, 4, 5
DAYS_IN_MONTH = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
PACKAGES = {"jax": (jax_ms, jax_ss, jax_ncmean),
            "port": (port_ms, port_ss, port_ncmean)}


def assert_same_files(fname_a, fname_b):
    """two netCDF files alike: dimensions, variables (values, dtypes,
    dimensions, attributes) and global attributes other than history"""
    with NCFile(str(fname_a)) as fa, NCFile(str(fname_b)) as fb:
        assert {n: fa.dim_len(n) for n in fa.dimensions} == {
            n: fb.dim_len(n) for n in fb.dimensions}
        assert set(fa.variables) == set(fb.variables)
        for name, var in fa.variables.items():
            other = fb.var(name)
            assert var.dimensions == other.dimensions, name
            assert var.datatype == other.datatype, name
            assert var.attrs == other.attrs, name
            np.testing.assert_array_equal(np.asarray(var[:]),
                                          np.asarray(other[:]), err_msg=name)
        attrs_a = {k: v for k, v in fa.attrs.items() if k != "history"}
        attrs_b = {k: v for k, v in fb.attrs.items() if k != "history"}
        assert attrs_a == attrs_b


# -- twins of tests/test_cime_pop_hist.py -----------------------------------


def _patch_case(monkeypatch, tmp_path, *, freq_opt, freq, run_type="startup",
                startdate="0001-01-01", refdate="0001-01-01"):
    """route both packages' namelist/xml queries to canned values"""
    xml = {"RUN_TYPE": run_type, "RUN_STARTDATE": startdate,
           "RUN_REFDATE": refdate, "RUNDIR": str(tmp_path), "CASE": "case0"}
    nl = {"tavg_freq_opt(1)": f"'{freq_opt}'", "tavg_freq": freq}
    for ms_mod, _ss, _nm in PACKAGES.values():
        monkeypatch.setattr(ms_mod, "cime_xmlquery",
                            lambda caseroot, var: xml[var])
        monkeypatch.setattr(ms_mod, "pop_nl_var_exists",
                            lambda caseroot, var: var in nl)
        monkeypatch.setattr(ms_mod, "get_pop_nl_var",
                            lambda caseroot, var: nl[var])
        monkeypatch.setattr(ms_mod, "cime_yr_cnt", lambda modelinfo: 1)


def _write_tavg(path, value):
    with NCFile(str(path), mode="w") as fptr:
        fptr.create_dimensions_verify({"time": None, "z": 2})
        var = fptr.create_variable("TR", "f8", ("time", "z"),
                                   attrs={"units": "mol/m^3"})
        var[:] = np.full((1, 2), float(value))


def _gen_hist_both(tmp_path):
    out = {}
    for name, (ms_mod, _ss, _nm) in PACKAGES.items():
        out[name] = str(tmp_path / f"hist_{name}.nc")
        ms_mod._gen_hist({"caseroot": "unused"}, out[name])
    assert_same_files(out["jax"], out["port"])
    return out["port"]


def test_gen_hist_nmonth_weighted_mean(monkeypatch, tmp_path):
    _patch_case(monkeypatch, tmp_path, freq_opt="nmonth", freq="1")
    month_days = np.array(DAYS_IN_MONTH, np.float64)
    for month in range(1, 13):
        _write_tavg(tmp_path / f"case0.pop.h.0001-{month:02}.nc", month)
    hist_fname = _gen_hist_both(tmp_path)
    expected = (np.arange(1, 13) * month_days).sum() / month_days.sum()
    with NCFile(hist_fname) as fptr:
        assert np.allclose(np.asarray(fptr.var("TR")[:]), expected)
        assert "model_state._gen_hist" in fptr.history


def test_gen_hist_nyear_branch_refdate(monkeypatch, tmp_path):
    _patch_case(monkeypatch, tmp_path, freq_opt="nyear", freq="1",
                run_type="branch", startdate="0099-01-01",
                refdate="0003-01-01")
    _write_tavg(tmp_path / "case0.pop.h.0003.nc", 7.0)
    with NCFile(_gen_hist_both(tmp_path)) as fptr:
        assert np.allclose(np.asarray(fptr.var("TR")[:]), 7.0)


@pytest.mark.parametrize(
    "kwargs,detail",
    [
        (dict(freq_opt="ndays", freq="1"), "tavg_freq_opt_0"),
        (dict(freq_opt="nyear", freq="2"), "tavg_freq_0"),
        (dict(freq_opt="nyear", freq="1", startdate="0001-01-15"), "day"),
        (dict(freq_opt="nyear", freq="1", startdate="0001-07-01"), "month"),
    ],
)
def test_gen_hist_rejects_unsupported(monkeypatch, tmp_path, kwargs, detail):
    _patch_case(monkeypatch, tmp_path, **kwargs)
    for ms_mod, _ss, _nm in PACKAGES.values():
        with pytest.raises(NotImplementedError, match=detail):
            ms_mod._gen_hist({"caseroot": "unused"}, str(tmp_path / "h.nc"))


def test_gen_hist_no_hist_fname_is_noop(monkeypatch):
    def boom(*args):
        raise AssertionError("should not query the case")

    monkeypatch.setattr(port_ms, "cime_xmlquery", boom)
    port_ms._gen_hist({"caseroot": "unused"}, None)


def test_matrix_block_decomp():
    for task_cnt in (1, 2, 64, 128, 256, 512):
        assert port_ms.matrix_block_decomp(task_cnt) == \
            jax_ms.matrix_block_decomp(task_cnt)
    assert port_ms.matrix_block_decomp(64) == (8, 8)
    assert port_ms.matrix_block_decomp(128) == (8, 16)
    with pytest.raises(ValueError):
        port_ms.matrix_block_decomp(96)
    assert port_ms.tracer_names_list_to_str(["A", "B"]) == "A_CUR,B_CUR"


def test_post_modelrun_script_matches_jax(tmp_path):
    """the POSTRUN hook, with and without a batch command, byte for byte"""
    for batch in (None, "qsub  -q regular --"):
        info = {"invoker_script_fname": "/w/nk_driver.sh",
                "batch_cmd_script": batch}
        port_ms._gen_post_modelrun_script(info, str(tmp_path / "port.sh"))
        jax_ms._gen_post_modelrun_script(info, str(tmp_path / "jax.sh"))
        text = (tmp_path / "port.sh").read_text()
        assert text == (tmp_path / "jax.sh").read_text()
        assert "/w/nk_driver.sh --resume" in text
        assert os.access(tmp_path / "port.sh", os.X_OK)


# -- twins of tests/test_cime_pop_setup.py ----------------------------------


def _write_hist(path, val):
    with NCFile(str(path), mode="w") as fptr:
        fptr.create_dimension("time", None)
        fptr.create_dimensions_verify({"z_t": NZ, "nlat": NLAT, "nlon": NLON})
        fptr.create_variable("time", "f8", ("time",))[0:1] = [float(val)]
        var = fptr.create_variable(
            "UET", "f8", ("time", "z_t", "nlat", "nlon"),
            attrs={"units": "cm^3/s"},
        )
        var[0:1] = np.full((1, NZ, NLAT, NLON), float(val))


def _modelinfo(tmp_path, name, **kwargs):
    info = {
        "caseroot": str(tmp_path / "caseroot"),
        "irf_case": "irf_case",
        "irf_hist_dir": str(tmp_path),
        "irf_fname": str(tmp_path / f"irf_{name}.nc"),
        "irf_hist_freq_opt": "nyear",
        "irf_hist_start_date": "0001-01-01",
        "irf_hist_yr_cnt": "2",
    }
    info.update(kwargs)
    return info


def _gen_irf_both(tmp_path, **kwargs):
    for name, (_ms, ss, _nm) in PACKAGES.items():
        ss.gen_irf_file(_modelinfo(tmp_path, name, **kwargs))
    assert_same_files(tmp_path / "irf_jax.nc", tmp_path / "irf_port.nc")
    return tmp_path / "irf_port.nc"


def test_gen_irf_file_nyear_mean(tmp_path):
    for year, val in ((3, 10.0), (4, 20.0), (5, 99.0)):
        _write_hist(tmp_path / f"irf_case.pop.h.{year:04d}.nc", val)
    out = _gen_irf_both(tmp_path, irf_hist_start_date="0003-01-01")
    with NCFile(str(out)) as fptr:
        np.testing.assert_allclose(np.asarray(fptr.var("UET")[:]), 15.0)


def test_gen_irf_file_nmonth_midyear_start(tmp_path):
    month0 = 7
    vals = {}
    for inc in range(12):
        year = 1 + (month0 - 1 + inc) // 12
        month = (month0 - 1 + inc) % 12 + 1
        vals[inc] = float(10 * inc + 1)
        _write_hist(tmp_path / f"irf_case.pop.h.{year:04d}-{month:02d}.nc",
                    vals[inc])
    out = _gen_irf_both(tmp_path, irf_hist_freq_opt="nmonth",
                        irf_hist_start_date="0001-07-01", irf_hist_yr_cnt="1")
    weights = [DAYS_IN_MONTH[(month0 - 1 + inc) % 12] for inc in range(12)]
    expected = sum(w * vals[i] for i, w in enumerate(weights)) / sum(weights)
    with NCFile(str(out)) as fptr:
        np.testing.assert_allclose(np.asarray(fptr.var("UET")[:]), expected)


def test_irf_window_defaults_from_case(tmp_path, monkeypatch):
    queries = {"RUN_TYPE": "branch", "RUN_REFDATE": "0007-03-01"}
    for _ms, ss, _nm in PACKAGES.values():
        monkeypatch.setattr(ss, "cime_xmlquery",
                            lambda caseroot, var: queries[var])
        monkeypatch.setattr(ss, "cime_yr_cnt", lambda modelinfo: 4)
    info = _modelinfo(tmp_path, "port", irf_hist_start_date=None,
                      irf_hist_yr_cnt=None)
    assert port_ss._irf_averaging_window(info) == (7, 3, 4)
    assert jax_ss._irf_averaging_window(info) == (7, 3, 4)
    queries = {"RUN_TYPE": "startup", "RUN_STARTDATE": "0002-01-01"}
    assert port_ss._irf_averaging_window(info) == (2, 1, 4)


@pytest.mark.parametrize(
    "kwargs, detail",
    [
        ({"irf_hist_freq_opt": "nday"}, "irf_hist_freq_opt=nday"),
        ({"irf_hist_start_date": "0001-01-15"}, "irf_hist_day0=15"),
        ({"irf_hist_start_date": "0001-05-01"},
         "irf_hist_month0=05 not implemented for nyear"),
    ],
)
def test_gen_irf_file_rejects_unsupported(tmp_path, kwargs, detail):
    for name, (_ms, ss, _nm) in PACKAGES.items():
        with pytest.raises(NotImplementedError, match=detail.split()[0]):
            ss.gen_irf_file(_modelinfo(tmp_path, name, **kwargs))


def _write_irf_grid_file(path, uet=None):
    """an IRF file carrying the POP grid fields gen_grid_vars_file reads
    (with uet, a tavg file whose record variable UET gen_irf_file averages)"""
    kmt = np.zeros((NLAT, NLON), np.int32)
    kmt[1, :] = NZ          # full-depth ocean row
    kmt[2, :] = 1           # single-layer shelf row
    kmt[3, 0] = NZ          # Black Sea column (see REGION_MASK below)
    region = np.zeros((NLAT, NLON), np.int32)
    region[kmt > 0] = 1
    region[3, 0] = -13      # POP's Black Sea region code
    with NCFile(str(path), mode="w") as fptr:
        if uet is not None:
            fptr.create_dimension("time", None)
        fptr.create_dimensions_verify({"z_t": NZ, "nlat": NLAT, "nlon": NLON})
        if uet is not None:
            fptr.create_variable("UET", "f8", ("time", "z_t", "nlat", "nlon"))[
                0:1] = np.full((1, NZ, NLAT, NLON), uet)
        fptr.create_variable("dz", "f8", ("z_t",))[:] = np.full(NZ, 500.0)
        fptr.create_variable("TAREA", "f8", ("nlat", "nlon"))[:] = np.full(
            (NLAT, NLON), 2.0e4)
        fptr.create_variable("KMT", "i4", ("nlat", "nlon"))[:] = kmt
        fptr.create_variable("REGION_MASK", "i4", ("nlat", "nlon"))[:] = region
        fptr.history = "irf file"
    return kmt


@pytest.mark.parametrize("include_black_sea", ["True", "False"])
def test_gen_grid_vars_file(tmp_path, include_black_sea):
    irf_fname = tmp_path / "irf.nc"
    _write_irf_grid_file(irf_fname)
    out = {}
    for name, (_ms, ss, _nm) in PACKAGES.items():
        out[name] = str(tmp_path / f"grid_vars_{name}.nc")
        ss.gen_grid_vars_file({"irf_fname": str(irf_fname),
                               "grid_vars_fname": out[name],
                               "include_black_sea": include_black_sea})
    assert_same_files(out["jax"], out["port"])
    with NCFile(out["port"]) as fptr:
        mask = np.asarray(fptr.var("region_mask")[:])
        weight = np.asarray(fptr.var("grid_weight")[:])
        history = fptr.history
    assert (mask[:, 1, :] == 1).all()
    assert (mask[0, 2, :] == 1).all() and (mask[1:, 2, :] == 0).all()
    assert (mask[:, 0, :] == 0).all()
    assert (mask[:, 3, 0] == (2 if include_black_sea == "True" else 0)).all()
    np.testing.assert_allclose(weight[mask > 0], (500.0e-2) * (2.0e4 * 1e-4))
    assert (weight[mask == 0] == 0.0).all()
    assert "gen_grid_vars_file" in history and "irf file" in history


# -- twins of tests/test_ncmean.py ------------------------------------------


def _write_monthly(dir_in, year, month, uet_val):
    fname = f"hist.{year:04d}-{month:02d}.nc"
    with NCFile(str(dir_in / fname), mode="w") as fptr:
        fptr.create_dimension("time", None)
        fptr.create_dimensions_verify({"z_t": 2, "nlat": 3, "nlon": 4})
        fptr.create_variable("time", "f8", ("time",))[0:1] = [
            float(12 * year + month)]
        var = fptr.create_variable(
            "UET", "f8", ("time", "z_t", "nlat", "nlon"),
            attrs={"units": "cm^3/s"},
        )
        var[0:1] = np.full((1, 2, 3, 4), uet_val)
        fptr.create_variable("TAREA", "f8", ("nlat", "nlon"))[:] = np.full(
            (3, 4), 7.0)
    return fname


def test_files_to_mean_file_weighted(tmp_path):
    fnames = [_write_monthly(tmp_path, 1, month, float(month))
              for month in (1, 2)]
    out = {name: nm.files_to_mean_file(str(tmp_path), fnames, [3.0, 1.0],
                                       f"mean_{name}.nc", "tests.ncmean")
           for name, (_ms, _ss, nm) in PACKAGES.items()}
    assert_same_files(out["jax"], out["port"])
    with NCFile(out["port"]) as fptr:
        np.testing.assert_allclose(np.asarray(fptr.var("UET")[:]),
                                   (3.0 * 1.0 + 1.0 * 2.0) / 4.0)
        np.testing.assert_allclose(np.asarray(fptr.var("TAREA")[:]), 7.0)
        assert "mean of 2 files" in fptr.history
        assert "newton_krylov_ooc_tpu_torch.utils.ncmean" in fptr.history


def test_mon_files_to_climatology_file(tmp_path):
    for year in (1, 2):
        for month in range(1, 13):
            _write_monthly(tmp_path, year, month,
                           10.0 * month + (1.0 if year == 1 else -1.0))
    out = {name: nm.mon_files_to_climatology_file(
        str(tmp_path), "hist.{year:04d}-{month:02d}.nc", 1, 2,
        f"climatology_{name}.nc", "tests.ncmean")
        for name, (_ms, _ss, nm) in PACKAGES.items()}
    assert_same_files(out["jax"], out["port"])
    with NCFile(out["port"]) as fptr:
        assert fptr.dim_len("month") == 12
        got = np.asarray(fptr.var("UET")[:])
        assert got.shape == (12, 2, 3, 4)
        np.testing.assert_allclose(got[:, 0, 0, 0], 10.0 * np.arange(1, 13))
        assert not fptr.has_var("time")
        assert "monthly climatology" in fptr.history
    # consumable as the port's seasonal circulation field
    from newton_krylov_ooc_tpu_torch.ops.transport3d import (
        build_transport3d,
        transport_coef_n_time,
    )

    coef = build_transport3d(np.ones((2, 3, 4), np.int32), np.full(2, 100.0),
                             np.full((3, 4), 7.0), uet=got, device="cpu",
                             dtype=torch.float64)
    assert transport_coef_n_time(coef) == 12


# -- setup_solver's main on the mock case ------------------------------------


def test_setup_solver_main_on_the_mock_case(tmp_path):
    """the port's setup_solver on a mock case: rpointers snapshotted, the
    IRF mean and grid vars files as JAX's, and an invoker script that runs
    the port's nk_driver with --device"""
    case = mock.build_case(tmp_path)
    (case["rundir"] / "rpointer.ocn.restart").write_text("case.pop.r.nc\n")
    hist_dir = tmp_path / "hist"
    hist_dir.mkdir()
    for month in range(1, 13):
        _write_irf_grid_file(hist_dir / f"irf_case.pop.h.0001-{month:02d}.nc",
                             uet=float(month))
    for name, (_ms, ss, _nm) in PACKAGES.items():
        workdir = tmp_path / f"work_{name}"
        override = tmp_path / f"override_{name}.cfg"
        override.write_text(
            "[modelinfo]\n"
            f"caseroot={case['caseroot']}\n"
            f"irf_hist_dir={hist_dir}\n"
            "irf_case=irf_case\n"
            "irf_hist_start_date=0001-01-01\n"
            "irf_hist_yr_cnt=1\n")
        cfgs = ",".join([os.path.join(mock.REPO, "input", "cime_pop",
                                      "newton_krylov.cfg"), str(override)])
        argv = ["--cfg_fnames", cfgs, "--workdir", str(workdir)]
        if name == "port":
            argv += ["--device", "cpu"]
        ss.main(ss.parse_args(argv))
    assert (case["caseroot"] / "rpointers" / "rpointer.ocn.restart").exists()
    for fname in ("irf.nc", "grid_vars.nc"):
        assert_same_files(tmp_path / "work_jax" / fname,
                          tmp_path / "work_port" / fname)
    invoker = (tmp_path / "work_port" / "nk_driver.sh").read_text()
    assert "-m newton_krylov_ooc_tpu_torch.cli.nk_driver" in invoker
    assert '--device "cpu"' in invoker
    assert "newton_krylov_ooc_tpu.cli" not in invoker


# -- the mock CIME case's Newton solve through both adapters ----------------


def _mock_solve(tmp_path, package, mode):
    model_config, newton, ms_mod = {
        "jax": (jax_model_config, jax_newton, jax_ms),
        "port": (port_model_config, port_newton, port_ms),
    }[package]
    root = tmp_path / package
    root.mkdir()
    config = mock.build_config(root, mock.build_case(root), mode)
    config["modelinfo"]["device"] = "cpu"
    ms_mod.ModelState.model_config_obj = model_config.ModelConfig(
        config["modelinfo"])
    try:
        solver, restarts = mock.run_solve(newton.NewtonSolver,
                                          ms_mod.ModelState,
                                          config["solverinfo"])
    finally:
        ms_mod.ModelState.model_config_obj = None
    iterate = solver._iterate.tracer_modules[0].get_tracer_vals("IAGE")
    workdir = root / "workdir"
    return {"iterate": iterate, "restarts": restarts,
            "counts": mock.solve_counts(str(workdir)),
            "hist": sorted(workdir.glob("hist_*.nc")),
            "matrix": list(workdir.glob("krylov_00/matrix_iage_like.nc"))}


def _check_against_jax(tmp_path, mode):
    port = _mock_solve(tmp_path, "port", mode)
    jax_res = _mock_solve(tmp_path, "jax", mode)
    assert port["restarts"] >= 2
    assert np.allclose(port["iterate"], mock.FIXED_POINT, rtol=1e-8)
    np.testing.assert_allclose(port["iterate"], jax_res["iterate"],
                               rtol=1e-12)
    assert port["counts"] == jax_res["counts"]
    assert port["restarts"] == jax_res["restarts"]
    assert port["hist"] and port["matrix"]
    assert_same_files(jax_res["hist"][0], port["hist"][0])


def test_mock_cime_pop_solve_device(tmp_path):
    """precond_solver_mode=device: the fixed point FORCING / (1 - DECAY),
    JAX's iterate within 1e-12, its Newton and Krylov counts and restarts"""
    _check_against_jax(tmp_path, "device")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["native", "device_sharded", "device_mixed",
                                  "device_sharded_mixed"])
def test_mock_cime_pop_solve_other_modes(tmp_path, mode):
    _check_against_jax(tmp_path, mode)


@pytest.mark.slow
def test_mock_cime_pop_batch_precond(tmp_path):
    """the batch-submitted preconditioner: the job sized from the per-matrix
    task_cnt / gigabyte tables (task_cnt 4 at 0.1 GB on 4 GB nodes of at
    most 8 cpus: 1 node, 8 cpus), submitted, and the process exits"""
    config = mock.build_config(tmp_path, mock.build_case(tmp_path), "native")
    submit_log = tmp_path / "submit.txt"
    qsub = tmp_path / "qsub"
    qsub.write_text(f"#!/bin/sh\necho \"$@\" >> {submit_log}\n")
    qsub.chmod(qsub.stat().st_mode | 0o100)
    config["modelinfo"]["batch_cmd_precond"] = (
        f"{qsub} --nodes {{node_cnt}} --cpus {{cpus_per_node}}")
    port_ms.ModelState.model_config_obj = port_model_config.ModelConfig(
        config["modelinfo"])
    try:
        solver, _restarts = mock.run_solve(
            port_newton.NewtonSolver, port_ms.ModelState,
            config["solverinfo"], max_restarts=80)
    finally:
        port_ms.ModelState.model_config_obj = None
    iterate = solver._iterate.tracer_modules[0].get_tracer_vals("IAGE")
    assert np.allclose(iterate, mock.FIXED_POINT, rtol=1e-8)
    submissions = submit_log.read_text().strip().splitlines()
    assert submissions
    for line in submissions:
        assert line.startswith("--nodes 1 --cpus 8 ")
        assert line.endswith("--resume")


def test_model_state_class_is_found():
    from newton_krylov_ooc_tpu_torch.core.state import get_model_state_class

    assert get_model_state_class("cime_pop") is port_ms.ModelState
