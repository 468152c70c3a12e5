"""layered configuration system: INI cfg files + CLI overrides + logging setup.

Capability parity with nk_ooc/share.py: configparser cfg files with
interpolation (sections DEFAULT/solverinfo/modelinfo, multi-file override
chains), a declarative table of CLI flags that override cfg entries (including
model-conditional flags like --persist), {model_name}/{suff} substitution in
string args, cfg echo for provenance, and reproducible-logging support.
The on-disk cfg format and keys match the reference so user configurations
carry over unchanged.  The port's own copy of
newton_krylov_ooc_tpu/config/share.py.
"""

from __future__ import annotations

import argparse
import configparser
import logging
import os
import sys

from ..utils.helpers import strtobool
from ..utils.ncio import mkdir_exist_okay


def repo_root():
    """root of this repository (two levels above this file's package)"""
    here = os.path.realpath(__file__)
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


class _Override:
    """one CLI flag that overrides a cfg entry"""

    def __init__(self, section, override_var=None, flag=False, override_val=None,
                 model_names=None):
        self.section = section
        self.override_var = override_var
        self.flag = flag  # store_true-style switch
        self.override_val = override_val
        self.model_names = model_names  # None = all models

    def applies_to(self, model_name):
        return self.model_names is None or model_name in self.model_names

    def add_to_parser(self, parser, argname):
        target = self.override_var or argname
        help_text = f"override {target} from cfg file"
        if self.flag:
            parser.add_argument(f"--{argname}", help=help_text, action="store_true")
        else:
            parser.add_argument(f"--{argname}", help=help_text, default=None)

    def apply(self, config, argname, value):
        target = self.override_var or argname
        if target not in config[self.section]:
            raise ValueError(f"{target} not in cfg section {self.section}")
        if self.flag:
            if value:
                config[self.section][target] = self.override_val
        elif value is not None:
            config[self.section][target] = value


_OVERRIDES = {
    "workdir": _Override("DEFAULT"),
    "logging_fname": _Override("solverinfo"),
    "logging_reproducible": _Override("DEFAULT", flag=True, override_val="True"),
    "logging_level": _Override("solverinfo"),
    "newton_max_iter": _Override("solverinfo"),
    "newton_rel_tol": _Override("solverinfo"),
    "init_iterate_fname": _Override("solverinfo"),
    "tracer_module_names": _Override("modelinfo"),
    "persist": _Override(
        "modelinfo",
        override_var="reinvoke",
        flag=True,
        override_val="False",
        model_names=["test_problem", "py_driver_2d", "irf_offline"],
    ),
}

# legacy-compatible view of the table (consumed by gen_invoker_script)
cfg_override_args = {
    name: {
        "section": ov.section,
        **({"override_var": ov.override_var} if ov.override_var else {}),
        **({"action": "store_true", "override_val": ov.override_val} if ov.flag else {}),
        **({"model_names": ov.model_names} if ov.model_names else {}),
    }
    for name, ov in _OVERRIDES.items()
}


def common_args(description, model_name, args_list):
    """argument parser with the framework's common options

    returns (parser, args_remaining); --model_name is pre-parsed so it can
    rebind the default cfg-file chain and conditional flags
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument(
        "--model_name",
        default=model_name,
        help="name of the model that solver is being applied to; "
        "using a non-default value alters subsequent options",
    )
    pre_args, args_remaining = pre.parse_known_args(args_list)

    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[pre],
    )

    input_dir = os.path.join(repo_root(), "input", pre_args.model_name)
    cfg_chain = [os.path.join(input_dir, "newton_krylov.cfg")]
    params_fname = os.path.join(input_dir, "model_params.cfg")
    if os.path.exists(params_fname):
        cfg_chain.append(params_fname)
    parser.add_argument(
        "--cfg_fnames",
        help="names of configuration files",
        default=",".join(cfg_chain),
    )

    for argname, override in _OVERRIDES.items():
        if override.applies_to(pre_args.model_name):
            override.add_to_parser(parser, argname)

    parser.add_argument(
        "--device",
        help="device that evaluates F: cuda (the card) or cpu; "
        "cuda raises when no card is visible",
        default="cuda",
    )

    return parser, args_remaining


def args_replace(args):
    """apply {model_name} substitution to string args ({suff} passes through)"""
    subs = {"model_name": args.model_name, "suff": "{suff}"}
    for name, value in vars(args).items():
        if isinstance(value, str):
            setattr(args, name, value.format(**subs))
    return args


def read_cfg_files(args):
    """read the cfg-file chain, apply CLI overrides, echo cfg for provenance"""
    defaults = {
        "HOME": os.environ.get("HOME", os.path.expanduser("~")),
        "USER": os.environ.get("USER", os.environ.get("LOGNAME", "user")),
        "repo_root": repo_root(),
    }
    config = configparser.ConfigParser(defaults, allow_no_value=True)
    if not config.read(args.cfg_fnames.split(",")):
        raise RuntimeError(f"cfg_fnames not read: {args.cfg_fnames}")

    _reject_unexpected_empty_values(args.cfg_fnames, config)

    for argname, override in _OVERRIDES.items():
        if argname in args:
            override.apply(config, argname, getattr(args, argname))
    if "device" in args:
        config["modelinfo"]["device"] = args.device

    cfg_out_fname = config["solverinfo"]["cfg_out_fname"]
    if cfg_out_fname is not None:
        mkdir_exist_okay(os.path.dirname(cfg_out_fname))
        with open(cfg_out_fname, "w") as fptr:
            config.write(fptr)

    return config


def _reject_unexpected_empty_values(cfg_fnames, config):
    """only names listed in no_value_allowed may be valueless"""
    allowed = config["DEFAULT"].get("no_value_allowed", None)
    allowed_names = set([] if allowed is None else allowed.split(","))
    allowed_names.add("no_value_allowed")
    for section in config.sections():
        for name, value in config[section].items():
            if value is None and name not in allowed_names:
                raise ValueError(
                    f"{name} not allowed to be empty in cfg file {cfg_fnames}"
                )


def logging_config(solverinfo, filemode):
    """configure logging to stdout + logfile; reproducible mode strips
    timestamps/PIDs so logs are diffable"""
    fields = ["%(filename)s", "%(funcName)s", "%(message)s"]
    if not strtobool(solverinfo["logging_reproducible"]):
        fields = ["%(asctime)s", "%(process)s"] + fields
    mkdir_exist_okay(os.path.dirname(solverinfo["logging_fname"]))
    logging.basicConfig(
        format=":".join(fields),
        level=solverinfo["logging_level"],
        handlers=[
            logging.StreamHandler(stream=sys.stdout),
            logging.FileHandler(filename=solverinfo["logging_fname"], mode=filemode),
        ],
        force=True,
    )


def repro_fname(cfg_section, fname):
    """fname with user-specific path components masked, for reproducible logs"""
    if not strtobool(cfg_section["logging_reproducible"]):
        return fname
    return fname.replace(cfg_section["workdir"], "$workdir").replace(
        cfg_section["repo_root"], "$repo_root"
    )
