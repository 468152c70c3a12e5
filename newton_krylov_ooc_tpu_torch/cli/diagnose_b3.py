"""where float32 loses kernel B3's deep columns: the CN column solve.

The bench's 256-level columns (its vertical mixing, the iage surface
restoring of both tracers, and its step: 12,615 a year), `ny` of them,
start from seeded standard-normal noise (a stand-in for a Krylov
direction) and take `steps` Crank-Nicolson steps, each increment
Kahan-added to a float32 state as B3 adds it.  Each variant computes the
increment its own way, and each line gives the largest difference from the
same steps in float64, relative to float64's max|y|.  The variants take the
candidates one at a time: the column solve (the TPU kernel's
reciprocal-form PCR, Thomas, the per-step year's divide-form PCR) and its
precision, the flux-form right-hand side h M y, the Kahan add, and what
float32 can represent at all (float64 steps from float32-rounded grid
inputs).

    python -m newton_krylov_ooc_tpu_torch.cli.diagnose_b3 [ny] [steps]

At 256 x 64 it takes about 45 s at 300 steps and three minutes at 1,261
(the first tenth of the bench's year) on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.py_driver_2d import physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
from ..ops.imex_block_cuda import _pcr_recip_rows
from ..ops.tridiag import pcr_solve, thomas_solve
from ..parallel.sharded_year import ShardedYearData
from .incore_spinup import MODELINFO, build_axes

NZ = 256
BENCH_STEPS = 12615  # a year of the bench's million-cell grid
SEED = 61
F32, F64 = torch.float32, torch.float64


def _along_rows(solve_last):
    """a solver along the last axis as one along the first"""
    def solve(dl, d, du, b):
        return solve_last(dl.T, d.T, du.T, b.T).T
    return solve


SOLVES = {"reciprocal PCR": _pcr_recip_rows,
          "Thomas": _along_rows(thomas_solve),
          "divide-form PCR": _along_rows(pcr_solve)}


def cn_increment(kv, diag, dz_r, y, h, rhs_dtype, solve_dtype, solve):
    """B3's CN increment over h of (nz, W) columns: the flux-form
    right-hand side h M y in rhs_dtype, the system (I - h/2 M) dv = h M y
    built and solved in solve_dtype by solve (along the first axis); kv is
    (nz-1, W), diag (nz, W), dz_r (nz,)"""
    def bands_and_rhs(dtype, with_rhs):
        kv_d, dzr = kv.to(dtype), dz_r.to(dtype)[:, None]
        zero = kv_d.new_zeros((1, kv_d.shape[1]))
        du = torch.cat([kv_d * dzr[:-1], zero])
        dl = torch.cat([zero, kv_d * dzr[1:]])
        if not with_rhs:
            return du, dl
        y_d = y.to(dtype)
        flux = kv_d * (y_d[1:] - y_d[:-1])
        m_v = dzr * (torch.cat([flux, zero]) - torch.cat([zero, flux])) \
            + diag.to(dtype) * y_d
        return h * m_v

    rhs = bands_and_rhs(rhs_dtype, True).to(solve_dtype)
    du, dl = bands_and_rhs(solve_dtype, False)
    dmain = -(du + dl) + diag.to(solve_dtype)
    half = 0.5 * h
    return solve(-half * dl, 1.0 - half * dmain, -half * du, rhs)


# (label, the state's dtype, rhs dtype, solve dtype, solve, Kahan add)
VARIANTS = (
    ("float32, reciprocal PCR (the TPU kernel)", F32, F32, F32,
     "reciprocal PCR", True),
    ("float32, Thomas", F32, F32, F32, "Thomas", True),
    ("float32, divide-form PCR (the per-step year)", F32, F32, F32,
     "divide-form PCR", True),
    ("float64 right-hand side, float32 Thomas solve", F32, F64, F32,
     "Thomas", True),
    ("float32 right-hand side, float64 solve", F32, F32, F64,
     "reciprocal PCR", True),
    ("float64 increment, rounded once (the repair)", F32, F64, F64,
     "reciprocal PCR", True),
    ("float64 increment, plain float32 add", F32, F64, F64,
     "reciprocal PCR", False),
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ny", nargs="?", type=int, default=64)
    parser.add_argument("steps", nargs="?", type=int, default=1261)
    args = parser.parse_args(argv)
    torch.set_num_threads(4)
    ny = args.ny
    depth, ypos = build_axes(NZ, ny)
    data = ShardedYearData(depth, ypos, MODELINFO, 1)
    grid = {name: getattr(data, name)
            for name in ("depth_mid", "dz_mid", "dz_mid_r", "dz_r")}
    grid.update(ypos_mid=data.ypos_mid[0], wvel=data.wvel[0])
    rate = surf_restore_rate(depth)
    diag = np.zeros((NZ, 2 * ny))
    diag[0, :ny] = -rate
    diag[0, ny:] = -SURF_SLOW_FACTOR * rate
    dt = physics.SEC_PER_YEAR / BENCH_STEPS
    y0 = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        (NZ, 2 * ny)))

    def columns(state_dtype, increment, kahan=True, rounded=False):
        """the CN steps from the noise; increment(kv, diag, dz_r, y, h)"""
        g = {name: torch.as_tensor(arr) for name, arr in grid.items()}
        d = torch.as_tensor(diag)
        if rounded:
            g = {name: arr.float().double() for name, arr in g.items()}
            d = d.float().double()
        y, c = y0.to(state_dtype), torch.zeros_like(y0, dtype=state_dtype)
        for i in range(args.steps):
            kv = physics.vert_mixing_coeff_arrays(
                g["depth_mid"], g["dz_mid"], g["dz_mid_r"], g["ypos_mid"],
                g["wvel"], (i + 1) * dt).repeat(1, 2)
            incr = increment(kv, d, g["dz_r"], y, dt).to(state_dtype)
            if kahan:
                adj = incr + c
                y_new = y + adj
                y, c = y_new, adj - (y_new - y)
            else:
                y = y + incr
        return y

    def f64_increment(kv, d, dz_r, y, h):
        return cn_increment(kv, d, dz_r, y, h, F64, F64, _pcr_recip_rows)

    ref = columns(F64, f64_increment)
    scale = float(ref.abs().max())

    def report(label, y):
        print(json.dumps({"variant": label, "nz": NZ, "ny": ny,
                          "steps": args.steps,
                          "rel_err_vs_f64": float((y.double() - ref).abs()
                                                  .max()) / scale,
                          "max_abs_y": scale}), flush=True)

    for label, state, rhs_dt, solve_dt, solve, kahan in VARIANTS:
        def increment(kv, d, dz_r, y, h, rhs_dt=rhs_dt, solve_dt=solve_dt,
                      solve=SOLVES[solve]):
            return cn_increment(kv, d, dz_r, y, h, rhs_dt, solve_dt, solve)
        report(label, columns(state, increment, kahan))
    report("float64 from float32-rounded grid inputs",
           columns(F64, f64_increment, rounded=True))


if __name__ == "__main__":
    main()
