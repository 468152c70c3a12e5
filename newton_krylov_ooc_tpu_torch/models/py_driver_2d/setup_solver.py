#!/usr/bin/env python
"""set up files needed to run the NK solver for py_driver_2d: depth + ypos
axes, grid-vars file (area weights; per-column regions when lateral transport
is disabled), invoker script, initial iterate with fixed-point warm-up.
Capability parity: nk_ooc/py_driver_2d/setup_solver.py; the port of
newton_krylov_ooc_tpu/models/py_driver_2d/setup_solver.py.  --device (cuda,
the default, or cpu) picks where F is evaluated, and the generated
nk_driver.sh passes it on to every re-invoked solver process.

    python -m newton_krylov_ooc_tpu_torch.models.py_driver_2d.setup_solver \
        --fp_cnt 1 --cfg_fnames CFGS --workdir WORKDIR [--device cpu]
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
from ...utils.ncio import NCFile, mkdir_exist_okay
from ..setup_common import add_setup_args, axis_from_cfg, warmup_and_write_init_iterate
from .model_state import ModelState

CALLER = "newton_krylov_ooc_tpu_torch.models.py_driver_2d.setup_solver.main"


def parse_args(args_list_in=None):
    parser, args_remaining = common_args(
        "setup solver for py_driver_2d model",
        "py_driver_2d",
        [] if args_list_in is None else args_list_in,
    )
    add_setup_args(parser)
    return args_replace(parser.parse_args(args_remaining))


def gen_grid_vars_file(args, modelinfo):
    """grid-vars file: both axes, area weights, region mask (per-ypos-column
    regions when advection and horizontal mixing are both disabled)"""
    axes = {
        name: axis_from_cfg(name, args, modelinfo) for name in ("depth", "ypos")
    }
    weight = np.outer(axes["depth"].delta, axes["ypos"].delta)

    lateral_off = (
        float(modelinfo["max_abs_vvel"]) == 0.0
        and float(modelinfo["horiz_mix_coeff"]) == 0.0
    )
    if lateral_off:
        # columns are decoupled: each solves as its own region
        mask = np.broadcast_to(
            np.arange(1, weight.shape[1] + 1, dtype=np.int32), weight.shape
        ).copy()
    else:
        mask = np.ones(weight.shape, dtype=np.int32)

    with NCFile(modelinfo["grid_vars_fname"], mode="w") as fptr:
        fptr.stamp_history(f"{__name__}.gen_grid_vars_file")
        for axis in axes.values():
            fptr.create_dimensions_verify(axis.dump_dimensions())
            fptr.create_vars(axis.dump_vars_metadata())
            axis.dump_write(fptr)
        weight_var = fptr.create_variable(
            "grid_weight",
            "f8",
            ("depth", "ypos"),
            attrs={"long_name": "grid-cell area", "units": "m^2"},
        )
        weight_var[:] = weight
        mask_var = fptr.create_variable(
            "region_mask",
            "i4",
            ("depth", "ypos"),
            attrs={
                "long_name": "Region Mask",
                "cell_measures": "area: grid_weight",
            },
        )
        mask_var[:] = mask


def main(args):
    config = read_cfg_files(args)
    solverinfo = config["solverinfo"]
    modelinfo = config["modelinfo"]

    logging_config(solverinfo, filemode="w")
    logger = logging.getLogger(__name__)
    logger.info('args.cfg_fnames="%s"', repro_fname(solverinfo, args.cfg_fnames))

    mkdir_exist_okay(solverinfo["workdir"])

    args.model_name = "py_driver_2d"
    gen_invoker_script.main(args)

    logger.info(
        'grid_vars_fname="%s"',
        repro_fname(modelinfo, modelinfo["grid_vars_fname"]),
    )
    mkdir_exist_okay(os.path.dirname(modelinfo["grid_vars_fname"]))
    gen_grid_vars_file(args, modelinfo)

    ModelState.model_config_obj = ModelConfig(modelinfo)

    init_iterate = ModelState(args.init_iterate_opt)
    warmup_and_write_init_iterate(
        init_iterate, args, solverinfo, CALLER, iter_digits=4
    )


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
