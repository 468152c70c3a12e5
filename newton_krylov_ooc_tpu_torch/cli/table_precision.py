"""whether B1's table or its scan chain moves its year away from float64.

B1 (csrc/iage_year.cu) solves each CN step from a table of Thomas factors
(m, w, cp) formed once in float32 by its table kernel, and runs the chain
as affine-map scans over a column's lanes (a reassociation of the serial
Thomas chain).  Either may move its float32 year from the float64 year.
This script runs B1's step in plain PyTorch (ops/imex_cuda.py::
build_iage_year_factored) four ways: the factors formed in float32 or
formed in float64 and rounded once, and the chain serial or in the
kernel's scan order (its lanes, fmaf rounding emulated).  Each year, and the
plain float32 year (divide-form PCR columns), is held against the plain
float64 year from chip_smoke.py phase 2's JVP-route input (source zeroed,
seeded standard-normal noise); each line gives the largest and the RMS
difference relative to float64's max|y|.

    python -m newton_krylov_ooc_tpu_torch.cli.table_precision \
        [nz ny steps] [--seeds 0 1 2]

At phase 2's grid over the first tenth of the year (40 x 50, 876 hourly
steps, the default) a seed takes about 15 s on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.py_driver_2d import physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
from ..ops import imex_cuda
from .incore_spinup import MODELINFO, build_axes

HOURS_A_YEAR = 8760


def variants(ny):
    """{name: (factor dtype, lanes)}: the table's factors formed in float32
    or formed in float64 and rounded once, the chain serial or as B1's scan
    over its lanes"""
    lanes = imex_cuda.column_lanes(ny)
    return {"f32 table, serial": (None, None),
            "f64 table, serial": (torch.float64, None),
            "f32 table, scan": (None, lanes),
            "f64 table, scan": (torch.float64, lanes)}


def compare(nz, ny, n_steps, seed):
    """{year: (max, rms)} of each variant's and the plain float32 year's
    difference from the plain float64 year over n_steps hourly steps,
    relative to float64's max|y|"""
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((2, nz, ny))
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    source = np.zeros((2, 1, 1))
    span = (0.0, physics.SEC_PER_YEAR * n_steps / HOURS_A_YEAR)
    grids = {dtype: physics.make_grid(depth, ypos, MODELINFO, device="cpu",
                                      dtype=dtype)
             for dtype in (torch.float32, torch.float64)}
    y0 = np.random.default_rng(seed).standard_normal((2, nz, ny))
    ref = imex_cuda.build_iage_year_plain(
        grids[torch.float64], diag, source, span, n_steps)(
        torch.as_tensor(y0))
    scale = float(ref.abs().max())
    years = {"plain f32 (PCR)": imex_cuda.build_iage_year_plain(
        grids[torch.float32], diag, source, span, n_steps)}
    for name, (factor_dtype, lanes) in variants(ny).items():
        years[name] = imex_cuda.build_iage_year_factored(
            grids[torch.float32], diag, source, span, n_steps, factor_dtype,
            lanes)
    out = {}
    for name, year in years.items():
        diff = year(torch.as_tensor(y0, dtype=torch.float32)).double() - ref
        out[name] = (float(diff.abs().max()) / scale,
                     float(diff.pow(2).mean().sqrt()) / scale)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="B1's table and scan chain against float64, on the CPU")
    parser.add_argument("shape", type=int, nargs="*", default=[40, 50, 876],
                        help="nz ny steps (hourly)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = parser.parse_args(argv)
    nz, ny, n_steps = args.shape
    for seed in args.seeds:
        errs = compare(nz, ny, n_steps, seed)
        print(json.dumps({"grid": f"{nz}x{ny}", "steps": n_steps,
                          "seed": seed,
                          "max_rel": {k: v[0] for k, v in errs.items()},
                          "rms_rel": {k: v[1] for k, v in errs.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
