"""shared machinery for the per-model setup_solver CLIs: common argument sets,
axis construction from cfg+CLI, comp_fcn profiling, fixed-point warm-up of the
initial iterate, and writing it where the solver expects it.  The port's own
copy of newton_krylov_ooc_tpu/models/setup_common.py."""

from __future__ import annotations

import cProfile
import logging
import os
import pstats

from ..core.spatial_axis import spatial_axis_defn_dict, spatial_axis_from_defn_dict
from ..config.share import repro_fname
from ..utils.ncio import mkdir_exist_okay


def add_setup_args(parser, default_fp_cnt=2):
    """arguments shared by all setup_solver CLIs"""
    parser.add_argument(
        "--init_iterate_opt",
        help="option for specifying initial iterate",
        default="gen_init_iterate",
    )
    parser.add_argument(
        "--fp_cnt",
        type=int,
        help="number of fixed point iterations to apply to init_iterate",
        default=default_fp_cnt,
    )
    parser.add_argument(
        "--prof_comp_fcn_fname",
        help="profile comp_fcn call; write output to provided argument",
        default=None,
    )
    parser.add_argument(
        "--deprecation_warning_to_error",
        help="treat DeprecationWarning warnings as errors",
        action="store_true",
    )


def axis_from_cfg(axisname, args, modelinfo):
    """build a SpatialAxis from modelinfo '<axis>_<key>' entries, with CLI
    attributes of the same names taking precedence"""
    defn_dict = {}
    for key, defn in spatial_axis_defn_dict(axisname=axisname).items():
        cfg_key = f"{axisname}_{key}"
        if cfg_key in modelinfo:
            defn_dict[key] = (defn["type"])(modelinfo[cfg_key])
        if hasattr(args, cfg_key):
            defn_dict[key] = getattr(args, cfg_key)
    return spatial_axis_from_defn_dict(
        defn_dict=spatial_axis_defn_dict(**defn_dict)
    )


def profile_comp_fcn(init_iterate, prof_fname):
    """cProfile one function evaluation, print the top-20 entries by time"""
    cProfile.runctx(
        "init_iterate.comp_fcn(res_fname=None, solver_state=None, hist_fname=None)",
        globals=None,
        locals={"init_iterate": init_iterate},
        filename=prof_fname,
    )
    pstats.Stats(prof_fname).strip_dirs().sort_stats("time").print_stats(20)


def warmup_and_write_init_iterate(init_iterate, args, solverinfo, caller,
                                  iter_digits=2):
    """optionally run fp_cnt fixed-point iterations X <- X + F(X) (with shadow
    copies), then write the initial iterate where the solver expects it"""
    logger = logging.getLogger(__name__)

    if args.prof_comp_fcn_fname is not None:
        profile_comp_fcn(init_iterate, args.prof_comp_fcn_fname)
        return None

    if args.fp_cnt > 0:
        warmup_dir = os.path.join(solverinfo["workdir"], "gen_init_iterate")
        mkdir_exist_okay(warmup_dir)

        def warmup_fname(prefix, fp_iter):
            return os.path.join(
                warmup_dir, f"{prefix}_{fp_iter:0{iter_digits}}.nc"
            )

        for fp_iter in range(args.fp_cnt):
            logger.info("fp_iter=%d", fp_iter)
            init_iterate.dump(warmup_fname("init_iterate", fp_iter), caller)
            fcn = init_iterate.comp_fcn(
                warmup_fname("fcn", fp_iter),
                None,
                warmup_fname("hist", fp_iter),
            )
            init_iterate += fcn
            init_iterate.copy_shadow_tracers_to_real_tracers()

    init_iterate_fname = solverinfo["init_iterate_fname"]
    logger.info(
        'init_iterate_fname="%s"', repro_fname(solverinfo, init_iterate_fname)
    )
    mkdir_exist_okay(os.path.dirname(init_iterate_fname))
    init_iterate.dump(init_iterate_fname, caller)
    return init_iterate
