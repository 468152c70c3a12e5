#!/usr/bin/env python
"""generate the self-reinvocation script (nk_driver.sh).

The out-of-core mechanism: models that exit after submitting work re-enter the
solver by running this generated script with --resume; the step log then
fast-forwards through completed work.  Capability parity:
nk_ooc/gen_invoker_script.py; the port of
newton_krylov_ooc_tpu/cli/gen_invoker_script.py.  The script runs the port's
nk_driver, under this invocation's interpreter, with its --device.
"""

import logging
import os
import shlex
import stat
import sys

from ..config.share import (
    args_replace,
    cfg_override_args,
    common_args,
    read_cfg_files,
    repro_fname,
)
from ..utils.ncio import mkdir_exist_okay


def _frozen_cli_args(args):
    """serialize the override args (as given on this invocation) for the script"""
    parts = [f'--cfg_fnames "{args.cfg_fnames}"']
    if "model_name" in args:
        parts.append(f'--model_name "{args.model_name}"')
    if "device" in args:
        parts.append(f'--device "{args.device}"')
    for argname, metadata in cfg_override_args.items():
        if argname not in args:
            continue
        value = getattr(args, argname)
        if metadata.get("action") == "store_true":
            if value:
                parts.append(f"--{argname}")
        elif value is not None:
            parts.append(f'--{argname} "{value}"')
    return " ".join(parts)


def gen_invoker_script(args, modelinfo, repo_root):
    """write the invoker script with the current cfg/args frozen in"""
    invoker_script_fname = modelinfo["invoker_script_fname"]
    mkdir_exist_okay(os.path.dirname(invoker_script_fname))

    logger = logging.getLogger(__name__)
    logger.info("generating %s", repro_fname(modelinfo, invoker_script_fname))

    lines = [
        "#!/bin/bash",
        f"cd {repo_root}",
        "if [ -f scripts/newton_krylov_env_cmds ]; then",
        "    source scripts/newton_krylov_env_cmds",
        "fi",
    ]
    if getattr(args, "deprecation_warning_to_error", False):
        lines.append("export PYTHONWARNINGS=error::DeprecationWarning")
    mpi_env = modelinfo.get("mpi_cmd_env_cmds_fname", None)
    if mpi_env is not None:
        lines.append(f"source {mpi_env}")
    # the interpreter that generated the script runs every re-invocation
    lines.append(
        f"{shlex.quote(sys.executable)} -m newton_krylov_ooc_tpu_torch.cli.nk_driver "
        f'{_frozen_cli_args(args)} "$@"'
    )

    with open(invoker_script_fname, mode="w") as fptr:
        fptr.write("\n".join(lines) + "\n")

    fstat = os.stat(invoker_script_fname)
    os.chmod(invoker_script_fname, fstat.st_mode | stat.S_IXUSR)


def parse_args(args_list_in=None):
    parser, args_remaining = common_args(
        "generate script for invoking nk_driver",
        "test_problem",
        [] if args_list_in is None else args_list_in,
    )
    return args_replace(parser.parse_args(args_remaining))


def main(args):
    config = read_cfg_files(args)
    gen_invoker_script(args, config["modelinfo"], config["DEFAULT"]["repo_root"])


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
