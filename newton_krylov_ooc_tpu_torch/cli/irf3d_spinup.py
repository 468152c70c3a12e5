"""3D offline IRF-transport spin-up: a family of linear tracer modules
riding an ocean circulation, solved on one device or on a latitude (x
longitude) sharded mesh.

Port of examples/irf3d_spinup.py.  A family of tracer modules (a decaying
dye and an ideal-age tracer), then the gas-exchange-coupled abiotic
DIC+DIC14 pair, ride a synthetic gyre circulation (seasonal with `months`
> 0) and solve to their cyclostationary state: the IMEX year, exact
linear JVPs, the fused left-preconditioned GMRES (jit_gmres, as the JAX
example runs both solves: basis, coefficients and least squares on the
device, one stop flag read an Arnoldi step) and the column-local PCR
vertical preconditioner.

    python -m newton_krylov_ooc_tpu_torch.cli.irf3d_spinup \\
        [nz] [nlat] [nlon] [shards] [months] [--device cuda|cpu] \\
        [--shards-per-device N]

`shards` is a shard count N (latitude-sharded) or NYxNX (a latitude x
longitude process grid).  One shard runs the year on one device (kernel
B4, csrc/transport3d_year.cu, for float32 on the card); more run the
per-step sharded year (parallel/sharded_transport3d.py, plain PyTorch, as
the JAX kernel runs its shard_map year).  A mesh of N shards needs N /
shards-per-device cards: `4 --shards-per-device 4` puts four shards on one
card; on the CPU every shard lies on the one CPU device.  The solver
settings are the JAX example's.

    python -m newton_krylov_ooc_tpu_torch.cli.irf3d_spinup 4 8 6 2x2 0 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.incore import NewtonKrylovInCore
from ..models.irf_offline import synthetic
from ..ops.compute import resolve_device
from ..parallel.mesh import make_mesh, mesh_devices
from ..parallel.sharded_transport3d import ShardedTransport3dKernel

SOLVER = {
    "newton_rel_tol": 1e-6,
    "krylov_rel_tol": 1e-3,
    "newton_max_iter": 8,
    "krylov_max_dim": 40,
}

# one family: every module shares the transport, differs in its rates
FAMILY_SPECS = [
    [{"name": "DYE", "source_per_year": 0.1, "sink_rate_per_year": 0.5}],
    [{"name": "IAGE", "source_per_year": 1.0,
      "surf_restore_pv_cm_s": 5.0e-3}],
]

# the gas-exchange-coupled pair, one module of two tracers
ABIO_SPECS = [[
    {"name": "ABIO_DIC", "surf_flux_const_cm_s": 1.05e-2,
     "surf_flux_d": {"ABIO_DIC": -5.0e-3}},
    {"name": "ABIO_DIC14", "sink_rate_per_year": 1.2097e-4,
     "surf_flux_d": {"ABIO_DIC": 4.25e-3, "ABIO_DIC14": -5.0e-3}},
]]


# the JAX bench's gx3 3D spin-up (bench.py:1034, 1082-1106): POP gx3v7
# extents, two modules of one tracer with volumetric sinks, at least 2000
# steps a year, and its solver settings; chip_smoke.py phases 6-7 and
# cli/profile_irf3d.py run it on the card
GX3 = (60, 116, 100)
GX3_MIN_STEPS = 2000
GX3_SPECS = [
    [{"name": "DYE_A", "source_per_year": 0.1, "sink_rate_per_year": 0.5}],
    [{"name": "DYE_B", "source_per_year": 0.1, "sink_rate_per_year": 1.0,
      "surf_restore_pv_cm_s": 5.0e-3}],
]
GX3_SOLVER = {"newton_rel_tol": 1e-5, "krylov_rel_tol": 1e-2,
              "newton_max_iter": 6, "krylov_max_dim": 20}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("nz", nargs="?", type=int, default=10)
    parser.add_argument("nlat", nargs="?", type=int, default=24)
    parser.add_argument("nlon", nargs="?", type=int, default=20)
    parser.add_argument("shards", nargs="?", default="1")
    parser.add_argument("months", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--shards-per-device", type=int, default=1,
                        help="mesh shards on each card (default 1)")
    return parser.parse_args(argv)


def build_mesh(shards, device, shards_per_device=1):
    """the mesh `shards` names (N, or NYxNX) on `device`'s kind, or None
    for one shard (the kernel then runs on `device` alone)"""
    if "x" in shards:
        n_y, n_x = (int(v) for v in shards.split("x"))
    else:
        n_y, n_x = int(shards), None
    n_shards = n_y * (n_x or 1)
    if n_shards == 1:
        return None
    return make_mesh(1, n_y, devices=mesh_devices(device, n_shards,
                                                  shards_per_device),
                     n_space_x=n_x)


def _solve(kernel, device):
    solver = NewtonKrylovInCore(kernel, jit_gmres=True, **SOLVER)
    start = time.time()
    x, fcn, info = solver.solve(kernel.init_iterate())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    info["seconds"] = time.time() - start
    return x, fcn, info


def main(argv=None):
    """run both spin-ups; returns [(kernel, x, fcn, info)] for the family
    and for the coupled pair, for callers that check the results"""
    args = parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mesh = build_mesh(args.shards, device, args.shards_per_device)
    placement = {"device": device} if mesh is None else {"mesh": mesh}
    circ = synthetic.gen_circulation(
        args.nz, args.nlat, args.nlon, n_seasons=args.months or None
    )
    n_steps = synthetic.stable_steps_per_year(circ)
    layout = "one shard" if mesh is None else " x ".join(
        f"{size} {axis}" for axis, size in mesh.shape.items()
        if axis != "module")
    print(
        f"grid {args.nz}x{args.nlat}x{args.nlon}, "
        f"{args.months or 'steady'} season(s), {n_steps} steps/year, "
        f"{layout} on device {device} ({name})"
    )

    results = []
    kernel = ShardedTransport3dKernel(circ, FAMILY_SPECS, n_steps,
                                      dtype=torch.float32, **placement)
    x, fcn, info = _solve(kernel, device)
    rel = info["fcn_norm"] / info["x_norm"]
    print(
        f"spun up {len(FAMILY_SPECS)} modules in {info['seconds']:.2f} s: "
        f"max rel residual {rel.max():.2e}, newton iterations "
        f"{info['iterations']}"
    )
    results.append((kernel, x, fcn, info))

    kernel2 = ShardedTransport3dKernel(circ, ABIO_SPECS, n_steps,
                                       dtype=torch.float32, **placement)
    x2, fcn2, info2 = _solve(kernel2, device)
    rel2 = info2["fcn_norm"] / info2["x_norm"]
    surf = x2[0, :, 0].cpu().numpy()
    wet0 = np.asarray(circ["mask"])[0] > 0
    ratio = (surf[1][wet0] / surf[0][wet0]).mean()
    print(
        f"abio_dic_dic14 spun up in {info2['seconds']:.2f} s: "
        f"max rel residual {rel2.max():.2e}, "
        f"mean surface DIC14/DIC ratio {ratio:.3f} "
        f"(gas-exchange balance 0.85)"
    )
    results.append((kernel2, x2, fcn2, info2))
    return results


if __name__ == "__main__":
    main()
