#!/usr/bin/env python
"""standalone driver for model-state methods (comp_fcn, gen_precond_jacobian,
apply_precond_jacobian) outside the solver -- debugging/benchmarking surface.

The port of newton_krylov_ooc_tpu/cli/run_cmd.py, for any model of the
port.  solver_state=None disables step logging and reinvocation (pure
in-core execution).  F runs on --device (cuda, the default, or cpu).
--profile_dir wraps the command in torch.profiler and writes its Chrome
trace there.

    python -m newton_krylov_ooc_tpu_torch.cli.run_cmd comp_fcn \
        --model_name irf_offline --cfg_fnames CFGS --in_fname IN \
        --res_fname OUT [--hist_fname HIST] [--device cpu]
"""

import contextlib
import functools
import logging
import os
import sys
import time

import torch

from ..config.model_config import ModelConfig
from ..config.share import args_replace, common_args, logging_config, read_cfg_files
from ..core.state import get_model_state_class

CMD_CHOICES = ["comp_fcn", "gen_precond_jacobian", "apply_precond_jacobian"]

ARG_SPECS = [
    ("--fname_dir", "directory that relative fname arguments are relative to", "."),
    ("--hist_fname", "name of history file", None),
    ("--precond_fname", "name of precond file", None),
    ("--in_fname", "name of file with input", None),
    ("--res_fname", "name of file for result", None),
    (
        "--profile_dir",
        "write a torch.profiler trace of the command to this directory "
        "(a Chrome trace: chrome://tracing or Perfetto; device time on a "
        "card)",
        None,
    ),
]


def parse_args(args_list_in=None):
    args_list = [] if args_list_in is None else args_list_in
    parser, args_remaining = common_args(
        "standalone driver for model_state methods", "test_problem", args_list
    )
    parser.add_argument("cmd", choices=CMD_CHOICES, help="command to run")
    for flag, help_text, default in ARG_SPECS:
        parser.add_argument(flag, help=help_text, default=default)
    return args_replace(parser.parse_args(args_remaining))


def main(args):
    config = read_cfg_files(args)
    logging_config(config["solverinfo"], filemode="a")
    logger = logging.getLogger(__name__)
    logger.info('args.cmd="%s"', args.cmd)

    model_state_class = get_model_state_class(
        config["DEFAULT"]["model_name"], logging.INFO
    )
    model_state_class.model_config_obj = ModelConfig(config["modelinfo"], logging.INFO)

    def resolve(fname):
        if fname is None or os.path.isabs(fname):
            return fname
        return os.path.join(args.fname_dir, fname)

    ms_in = model_state_class(resolve(args.in_fname))

    if args.profile_dir is not None:
        profile_ctx = functools.partial(_profiled, args, logger)
    else:
        profile_ctx = contextlib.nullcontext

    with profile_ctx():
        _dispatch(args, ms_in, resolve)

    logger.info("done")


@contextlib.contextmanager
def _profiled(args, logger):
    """torch.profiler over the command (the card's kernels too, when one is
    visible), its Chrome trace written under args.profile_dir"""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    start = time.time()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    trace_fname = os.path.join(args.profile_dir, f"{args.cmd}.trace.json")
    prof.export_chrome_trace(trace_fname)
    logger.info('cmd="%s" wall-clock %.6f s; profiler trace in %s', args.cmd,
                time.time() - start, trace_fname)


def _dispatch(args, ms_in, resolve):
    if args.cmd == "comp_fcn":
        ms_in.log("state_in")
        result = ms_in.comp_fcn(
            resolve(args.res_fname),
            solver_state=None,
            hist_fname=resolve(args.hist_fname),
        )
        result.log("fcn")
    elif args.cmd == "gen_precond_jacobian":
        ms_in.gen_precond_jacobian(
            resolve(args.hist_fname),
            resolve(args.precond_fname),
            solver_state=None,
        )
    else:  # apply_precond_jacobian (argparse restricts the choices)
        ms_in.log("state_in")
        result = ms_in.apply_precond_jacobian(
            resolve(args.precond_fname),
            resolve(args.res_fname),
            solver_state=None,
        )
        result.log("precond_res")


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
