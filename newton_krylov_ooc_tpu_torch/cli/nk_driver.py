#!/usr/bin/env python
"""driver for the Newton-Krylov solver.

Runs Newton iterations until the per-(module, region) convergence criterion is
met; honors --resume/--rewind (step-log replay) and a KILL sentinel file.
Capability parity: nk_ooc/nk_driver.py; the port of
newton_krylov_ooc_tpu/cli/nk_driver.py.  It runs one process: the JAX
nk_driver's multi-host bootstrap is not ported.  F is evaluated on --device
(cuda, the default, or cpu), which setup_solver freezes into nk_driver.sh.

    WORKDIR/nk_driver.sh   # as generated by setup_solver
    python -m newton_krylov_ooc_tpu_torch.cli.nk_driver --persist \
        --workdir WORKDIR [--device cpu]
"""

import logging
import os
import sys

from ..config.model_config import ModelConfig
from ..config.share import args_replace, common_args, logging_config, read_cfg_files
from ..core.newton import NewtonSolver
from ..core.state import get_model_state_class

KILL_SENTINEL = "KILL"


def parse_args(args_list_in=None):
    parser, args_remaining = common_args(
        "invoke Newton-Krylov solver",
        "test_problem",
        [] if args_list_in is None else args_list_in,
    )
    for flag, help_text in [
        ("--resume", "resume Newton's method from solver's saved state"),
        ("--rewind", "rewind last step to recover from error"),
    ]:
        parser.add_argument(flag, help=help_text, action="store_true", default=False)
    return args_replace(parser.parse_args(args_remaining))


def build_solver(config, resume, rewind, lvl=logging.INFO):
    """configure the model classes and construct the Newton solver"""
    model_state_class = get_model_state_class(config["DEFAULT"]["model_name"], lvl)
    model_state_class.model_config_obj = ModelConfig(config["modelinfo"], lvl)
    return NewtonSolver(
        model_state_class,
        solverinfo=config["solverinfo"],
        resume=resume,
        rewind=rewind,
    )


def main(args):
    config = read_cfg_files(args)
    logging_config(config["solverinfo"], filemode="a")
    logger = logging.getLogger(__name__)

    if os.path.exists(KILL_SENTINEL):
        logger.warning("KILL file detected, exiting")
        raise SystemExit

    lvl = logging.DEBUG if args.resume else logging.INFO
    solver = build_solver(config, args.resume, args.rewind, lvl)

    while not solver.converged().all():
        solver.step()

    logger.info("Newton convergence criterion satisfied")
    solver.log()


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
