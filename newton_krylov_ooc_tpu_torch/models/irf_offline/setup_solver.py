#!/usr/bin/env python
"""set up files needed to run the NK solver for irf_offline: circulation
(IRF mean) + grid-vars files (generated synthetically unless the cfg points
at existing ones), invoker script, and the initial iterate with optional
fixed-point warm-up runs.  The port of
newton_krylov_ooc_tpu/models/irf_offline/setup_solver.py.  --device (cuda,
the default, or cpu) picks where F is evaluated, and the generated
nk_driver.sh passes it on to every re-invoked solver process.

A self-contained synthetic gyre serves demonstrations and CI; a real IRF
mean file drops in via the cfg's irf_fname.

    python -m newton_krylov_ooc_tpu_torch.models.irf_offline.setup_solver \
        --fp_cnt 1 --nz 4 --nlat 6 --nlon 8 --workdir WORKDIR [--device cpu]
"""

import logging
import os
import sys

from ...cli import gen_invoker_script
from ...config.model_config import ModelConfig
from ...config.share import (
    args_replace,
    common_args,
    logging_config,
    read_cfg_files,
    repro_fname,
)
from ...utils.ncio import mkdir_exist_okay
from ..setup_common import add_setup_args, warmup_and_write_init_iterate
from . import synthetic
from .model_state import ModelState

CALLER = "newton_krylov_ooc_tpu_torch.models.irf_offline.setup_solver.main"


def parse_args(args_list_in=None):
    parser, args_remaining = common_args(
        "setup solver for irf_offline model",
        "irf_offline",
        [] if args_list_in is None else args_list_in,
    )
    parser.add_argument("--nz", type=int, default=10, help="synthetic grid levels")
    parser.add_argument("--nlat", type=int, default=12, help="synthetic grid rows")
    parser.add_argument("--nlon", type=int, default=16, help="synthetic grid cols")
    parser.add_argument(
        "--seasonal_months",
        type=int,
        default=0,
        help="generate a seasonal synthetic circulation with this many "
        "monthly samples (0 = steady annual mean)",
    )
    add_setup_args(parser)
    return args_replace(parser.parse_args(args_remaining))


def main(args):
    config = read_cfg_files(args)
    solverinfo = config["solverinfo"]
    modelinfo = config["modelinfo"]

    logging_config(solverinfo, filemode="w")
    logger = logging.getLogger(__name__)
    logger.info('args.cfg_fnames="%s"', repro_fname(solverinfo, args.cfg_fnames))

    mkdir_exist_okay(solverinfo["workdir"])

    args.model_name = "irf_offline"
    gen_invoker_script.main(args)

    irf_fname = modelinfo["irf_fname"]
    grid_vars_fname = modelinfo["grid_vars_fname"]
    if os.path.exists(irf_fname):
        if args.seasonal_months:
            logger.warning(
                'irf_fname="%s" already exists; --seasonal_months ignored '
                "(and steps_per_year not re-derived) -- remove the file to "
                "regenerate",
                repro_fname(modelinfo, irf_fname),
            )
    else:
        logger.info(
            'generating synthetic circulation, irf_fname="%s"',
            repro_fname(modelinfo, irf_fname),
        )
        circ = synthetic.gen_circulation(
            args.nz,
            args.nlat,
            args.nlon,
            n_seasons=args.seasonal_months or None,
        )
        mkdir_exist_okay(os.path.dirname(irf_fname))
        synthetic.write_circulation(irf_fname, circ, CALLER)
        mkdir_exist_okay(os.path.dirname(grid_vars_fname))
        synthetic.write_grid_vars(grid_vars_fname, circ, CALLER)
        steps = synthetic.stable_steps_per_year(circ)
        if steps > int(modelinfo["steps_per_year"]):
            logger.info("raising steps_per_year to the stability bound %d", steps)
            modelinfo["steps_per_year"] = str(steps)

    ModelState.model_config_obj = ModelConfig(modelinfo)

    init_iterate = ModelState(args.init_iterate_opt)
    warmup_and_write_init_iterate(init_iterate, args, solverinfo, CALLER)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
