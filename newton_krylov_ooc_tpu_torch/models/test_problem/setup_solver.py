#!/usr/bin/env python
"""set up files needed to run the NK solver for test_problem: depth axis +
grid-vars file, invoker script, initial iterate (with optional fixed-point
warm-up runs), and an optional comp_fcn profile.
Capability parity: nk_ooc/test_problem/setup_solver.py; the port of
newton_krylov_ooc_tpu/models/test_problem/setup_solver.py.  --device (cuda,
the default, or cpu) picks where F is evaluated, and the generated
nk_driver.sh passes it on to every re-invoked solver process.

    python -m newton_krylov_ooc_tpu_torch.models.test_problem.setup_solver \
        --fp_cnt 1 --depth_nlevs 20 --persist --workdir WORKDIR [--device cpu]
"""

import logging
import os
import sys

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
from ...core.spatial_axis import spatial_axis_defn_dict
from ...utils.ncio import NCFile, mkdir_exist_okay
from ..setup_common import add_setup_args, axis_from_cfg, warmup_and_write_init_iterate
from .model_state import ModelState

CALLER = "newton_krylov_ooc_tpu_torch.models.test_problem.setup_solver.main"


def parse_args(args_list_in=None):
    parser, args_remaining = common_args(
        "setup solver for test_problem model",
        "test_problem",
        [] if args_list_in is None else args_list_in,
    )
    nlevs_defn = spatial_axis_defn_dict(axisname="depth")["nlevs"]
    parser.add_argument(
        "--depth_nlevs",
        type=nlevs_defn["type"],
        help=nlevs_defn["help"],
        default=nlevs_defn["value"],
    )
    add_setup_args(parser)
    return args_replace(parser.parse_args(args_remaining))


def write_grid_vars(depth, modelinfo):
    """grid-vars file: the depth axis plus a trivial (single-region) mask"""
    grid_vars_fname = modelinfo["grid_vars_fname"]
    mkdir_exist_okay(os.path.dirname(grid_vars_fname))
    depth.dump(grid_vars_fname, CALLER)
    with NCFile(grid_vars_fname, mode="a") as fptr:
        var = fptr.create_variable(
            "region_mask",
            "i4",
            (depth.axisname,),
            attrs={
                "long_name": "Region Mask",
                "cell_measures": f"thickness: {depth.dump_names['delta']}",
            },
        )
        var[:] = np.ones(len(depth), dtype=np.int32)


def main(args):
    config = read_cfg_files(args)
    solverinfo = config["solverinfo"]
    modelinfo = config["modelinfo"]

    logging_config(solverinfo, filemode="w")
    logger = logging.getLogger(__name__)
    logger.info('args.cfg_fnames="%s"', repro_fname(solverinfo, args.cfg_fnames))

    mkdir_exist_okay(solverinfo["workdir"])

    args.model_name = "test_problem"
    gen_invoker_script.main(args)

    depth = axis_from_cfg(modelinfo["depth_axisname"], args, modelinfo)
    logger.info(
        'grid_vars_fname="%s"',
        repro_fname(modelinfo, modelinfo["grid_vars_fname"]),
    )
    write_grid_vars(depth, modelinfo)

    # confirm the model configures against the generated grid file
    ModelState.model_config_obj = ModelConfig(modelinfo)

    init_iterate = ModelState(args.init_iterate_opt)
    warmup_and_write_init_iterate(init_iterate, args, solverinfo, CALLER)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
