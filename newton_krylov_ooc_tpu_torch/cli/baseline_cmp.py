#!/usr/bin/env python
"""compare a netCDF file to a baseline: metadata equality + unit-aware
np.isclose on all common variables.  Exit code 0 on match, 1 otherwise.
Capability parity: nk_ooc/baseline_cmp.py; the port's own copy of
newton_krylov_ooc_tpu/cli/baseline_cmp.py.
"""

import argparse
import logging
import os
import sys

from ..utils.ncio import isclose_all_vars, metadata_same

DEFAULT_RTOL = 1.0e-7
DEFAULT_ATOL = 2.0e-9


def parse_args(args_list_in=None):
    parser = argparse.ArgumentParser(
        description="compare netCDF file to baseline",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--fname", help="name of file to be compared")
    parser.add_argument("--expr_dir", help="directory with file")
    parser.add_argument("--baseline_dir", help="directory with baseline file")
    parser.add_argument(
        "--rtol", help="relative tolerance", type=float, default=DEFAULT_RTOL
    )
    parser.add_argument(
        "--atol", help="absolute tolerance", type=float, default=DEFAULT_ATOL
    )
    return parser.parse_args([] if args_list_in is None else args_list_in)


def compare(expr_fname, baseline_fname, rtol, atol):
    """True when metadata match and all common variables are close"""
    ok = metadata_same(expr_fname, baseline_fname)
    ok &= isclose_all_vars(expr_fname, baseline_fname, rtol=rtol, atol=atol)
    return ok


def main(args):
    logging.basicConfig(
        format="%(filename)s:%(funcName)s:%(message)s",
        level="INFO",
        stream=sys.stdout,
    )
    logger = logging.getLogger(__name__)

    expr_fname = os.path.join(args.expr_dir, args.fname)
    baseline_fname = os.path.join(args.baseline_dir, args.fname)
    logger.info("expr_fname = %s", expr_fname)
    logger.info("baseline_fname = %s", baseline_fname)

    sys.exit(0 if compare(expr_fname, baseline_fname, args.rtol, args.atol) else 1)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
