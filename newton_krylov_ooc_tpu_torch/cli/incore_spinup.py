"""device-resident Newton-Krylov spin-up of py_driver_2d iage.

Port of examples/incore_spinup.py: the IMEX year (one CUDA kernel launch
per year for float32 on the card), exact Jacobian-vector products,
left-preconditioned GMRES, float32 with Kahan-compensated accumulation.

    python -m newton_krylov_ooc_tpu_torch.cli.incore_spinup [nz] [ny] [n_steps] \
        [--device cuda] [--newton-rel-tol 3e-5]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.incore import NewtonKrylovInCore
from ..core.spatial_axis import (
    spatial_axis_defn_dict,
    spatial_axis_from_defn_dict,
)
from ..models.py_driver_2d.incore import IageKernel
from ..ops.compute import resolve_device

MODELINFO = {"max_abs_vvel": "0.1", "horiz_mix_coeff": "1000.0"}
# the example's solver settings besides newton_rel_tol; the solve is
# host-driven, as the JAX example's
SOLVER = dict(krylov_rel_tol=1e-2, newton_max_iter=8)


def build_axes(nz, ny):
    """the py_driver_2d depth (stretched) and ypos (uniform) axes"""
    depth = spatial_axis_from_defn_dict(
        defn_dict=spatial_axis_defn_dict(
            nlevs=nz, edge_end=4000.0, delta_ratio_max=19.0
        )
    )
    ypos = spatial_axis_from_defn_dict(
        defn_dict=spatial_axis_defn_dict(
            axisname="ypos", nlevs=ny, edge_start=0.0, edge_end=50.0e5,
            delta_ratio_max=1.0, units="m",
        )
    )
    return depth, ypos


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("nz", nargs="?", type=int, default=40)
    parser.add_argument("ny", nargs="?", type=int, default=50)
    parser.add_argument("n_steps", nargs="?", type=int, default=4380)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--newton-rel-tol", type=float, default=3e-5)
    return parser.parse_args(argv)


def main(argv=None):
    """run the spin-up; returns (kernel, x, fcn, info) for callers that
    check the result"""
    args = parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    depth, ypos = build_axes(args.nz, args.ny)
    print(
        f"grid {args.nz}x{args.ny}, {args.n_steps} IMEX steps/year, "
        f"device {device} ({name})"
    )

    kernel = IageKernel(
        depth, ypos, MODELINFO, device=device, dtype=torch.float32,
        n_steps=args.n_steps,
    )
    solver = NewtonKrylovInCore(kernel, newton_rel_tol=args.newton_rel_tol,
                                **SOLVER)

    start = time.time()
    x, fcn, info = solver.solve(kernel.init_iterate())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - start
    info["seconds"] = elapsed

    rel = float((info["fcn_norm"] / info["x_norm"]).max())
    print(
        f"converged in {info['iterations']} Newton iterations, "
        f"{elapsed:.1f}s wall; final rel resid {rel:.2e}"
    )
    print(f"spun-up max ideal age: {float(x.max()):.1f} years")
    return kernel, x, fcn, info


if __name__ == "__main__":
    main()
