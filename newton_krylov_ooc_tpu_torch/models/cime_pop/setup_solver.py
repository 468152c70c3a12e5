#!/usr/bin/env python
"""set up files needed to run the NK solver for cime_pop: rpointer snapshot,
IRF (impulse-response-function) mean file via native time-averaging, and 3D
grid vars (region mask from KMT/REGION_MASK, volume weights).
Capability parity: nk_ooc/cime_pop/setup_solver.py; the port of
newton_krylov_ooc_tpu/models/cime_pop/setup_solver.py.  The generated
invoker script runs the port's nk_driver with this invocation's --device,
the device of the on-device preconditioner solves.
"""

import glob
import logging
import os
import shutil
import sys
from datetime import datetime

import numpy as np

from ...cli import gen_invoker_script
from ...config.model_config import ModelConfig
from ...config.share import (
    args_replace,
    common_args,
    logging_config,
    read_cfg_files,
    repro_fname,
)
from ...utils.helpers import strtobool
from ...utils.ncio import NCFile, extract_dimensions, mkdir_exist_okay
from ...utils.ncmean import ann_files_to_mean_file, mon_files_to_mean_file
from ..external.cime import cime_xmlquery, cime_yr_cnt


def parse_args(args_list_in=None):
    args_list = [] if args_list_in is None else args_list_in
    parser, args_remaining = common_args(
        "setup solver for cime_pop model", "cime_pop", args_list
    )
    parser.add_argument(
        "--skip_irf_gen",
        help="skip generating irf file if it exists, default is to overwrite it",
        action="store_true",
    )
    return args_replace(parser.parse_args(args_remaining))


def main(args):
    config = read_cfg_files(args)
    solverinfo = config["solverinfo"]
    modelinfo = config["modelinfo"]

    logging_config(solverinfo, filemode="w")
    logger = logging.getLogger(__name__)
    logger.info('args.cfg_fnames="%s"', repro_fname(solverinfo, args.cfg_fnames))

    mkdir_exist_okay(solverinfo["workdir"])

    # snapshot rpointer files so failed runs can be replayed
    rundir = cime_xmlquery(modelinfo["caseroot"], "RUNDIR")
    rpointer_dir = modelinfo["rpointer_dir"]
    mkdir_exist_okay(rpointer_dir)
    for src in glob.glob(os.path.join(rundir, "rpointer.*")):
        shutil.copy(src, rpointer_dir)

    args.model_name = "cime_pop"
    gen_invoker_script.main(args)

    irf_fname = modelinfo["irf_fname"]
    if os.path.exists(irf_fname) and args.skip_irf_gen:
        logger.info(
            'irf_fname="%s" exists, skipping generation',
            repro_fname(modelinfo, irf_fname),
        )
    else:
        logger.info('generating irf_fname="%s"', repro_fname(modelinfo, irf_fname))
        mkdir_exist_okay(os.path.dirname(irf_fname))
        gen_irf_file(modelinfo)

    grid_vars_fname = modelinfo["grid_vars_fname"]
    logger.info('grid_vars_fname="%s"', repro_fname(modelinfo, grid_vars_fname))
    mkdir_exist_okay(os.path.dirname(grid_vars_fname))
    gen_grid_vars_file(modelinfo)

    # confirm that generated files can be read
    ModelConfig(modelinfo)


def _irf_averaging_window(modelinfo):
    """(year0, month0, yr_cnt) of the IRF output to be averaged, defaulting to
    the case's own run-duration settings"""
    start_date = modelinfo["irf_hist_start_date"]
    if start_date is None:
        run_type = cime_xmlquery(modelinfo["caseroot"], "RUN_TYPE")
        varname = "RUN_REFDATE" if run_type == "branch" else "RUN_STARTDATE"
        start_date = cime_xmlquery(modelinfo["caseroot"], varname)
    year0, month0, day0 = start_date.split("-")

    if day0 != "01":
        raise NotImplementedError(f"irf_hist_day0={day0} not implemented")

    yr_cnt = modelinfo["irf_hist_yr_cnt"]
    if yr_cnt is None:
        yr_cnt = cime_yr_cnt(modelinfo)
    return int(year0), int(month0), int(yr_cnt)


def gen_irf_file(modelinfo):
    """time-average IRF tracer output into the IRF mean file"""
    freq = modelinfo["irf_hist_freq_opt"]
    if freq not in ("nyear", "nmonth"):
        raise NotImplementedError(f"irf_hist_freq_opt={freq} not implemented")

    year0, month0, yr_cnt = _irf_averaging_window(modelinfo)
    caller = f"{__name__}.gen_irf_file"
    irf_case = modelinfo["irf_case"]

    if freq == "nyear":
        if month0 != 1:
            raise NotImplementedError(
                f"irf_hist_month0={month0:02d} not implemented for nyear "
                "tavg output"
            )
        ann_files_to_mean_file(
            modelinfo["irf_hist_dir"],
            f"{irf_case}.pop.h.{{year:04}}.nc",
            year0,
            yr_cnt,
            modelinfo["irf_fname"],
            caller,
        )
    else:
        mon_files_to_mean_file(
            modelinfo["irf_hist_dir"],
            f"{irf_case}.pop.h.{{year:04}}-{{month:02}}.nc",
            year0,
            month0,
            12 * yr_cnt,
            modelinfo["irf_fname"],
            caller,
        )


def gen_grid_vars_file(modelinfo):
    """3D grid vars from the IRF file: region mask from KMT/REGION_MASK
    (Black Sea optionally region 2), volume weights"""
    irf_fname = modelinfo["irf_fname"]

    with NCFile(irf_fname) as fptr_in:
        history_in = fptr_in.history
        thickness = 1.0e-2 * fptr_in.var("dz")[:]  # cm -> m
        area = 1.0e-4 * fptr_in.var("TAREA")[:]  # cm^2 -> m^2
        kmt = fptr_in.var("KMT")[:]
        region_mask = fptr_in.var("REGION_MASK")[:]
        dimensions_3d = extract_dimensions(fptr_in, ["z_t", "KMT"])

    # vectorized 3D mask: ocean cells above the bottom (k < KMT) are region 1;
    # the Black Sea (REGION_MASK == -13) optionally becomes region 2
    nz = next(iter(dimensions_3d.values()))
    k_idx = np.arange(nz)[:, None, None]
    ocean = k_idx < kmt[None, :, :]
    mask = np.where(ocean & (region_mask[None, :, :] > 0), 1, 0).astype(np.int32)
    if strtobool(modelinfo["include_black_sea"]):
        mask = np.where(ocean & (region_mask[None, :, :] == -13), 2, mask)

    weight = thickness[:, None, None] * np.where(mask > 0, area[None, :, :], 0.0)

    with NCFile(modelinfo["grid_vars_fname"], mode="w") as fptr_out:
        datestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        msg = (
            f"{datestamp}: created by {__name__}.gen_grid_vars_file "
            f"from {irf_fname}"
        )
        fptr_out.history = msg if history_in is None else "\n".join([msg, history_in])

        fptr_out.create_dimensions_verify(dimensions_3d)

        fptr_out.create_variable(
            "region_mask",
            "i4",
            tuple(dimensions_3d),
            attrs={
                "long_name": "Region Mask",
                "cell_measures": "volume: grid_weight",
            },
        )
        fptr_out.create_variable(
            "DYN_REGMASK",
            "i4",
            tuple(dimensions_3d)[1:],
            attrs={"long_name": "Surface Region Mask"},
        )
        fptr_out.create_variable(
            "grid_weight",
            "f8",
            tuple(dimensions_3d),
            attrs={"long_name": "Ocean Grid-Cell Volume", "units": "m^3"},
        )
        fptr_out.var("region_mask")[:] = mask
        fptr_out.var("DYN_REGMASK")[:] = mask[0, :]
        fptr_out.var("grid_weight")[:] = weight


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
