"""sharded Newton-Krylov spin-up of a py_driver_2d iage module family.

Port of examples/sharded_spinup.py: a batch of parameterized iage-family
modules (aging rates 1.0, 1.25, ... yr/yr, four per module block) split
over the mesh's 'module' axis, the ypos grid over 'space'; the year runs in
blocks of --block-steps steps on every shard through kernel B3
(ops/imex_block_cuda.py, float32), with halo columns exchanged between
blocks.  --plain-year runs the per-step sharded year in float64 instead.
The solve is NewtonKrylovInCore with the fused GMRES (jit_gmres, as the
JAX example runs it): the Krylov basis, coefficients and least squares stay
on the device, one stop flag read an Arnoldi step.  F and JVP seconds are
timed, synchronised, and reported.

    python -m newton_krylov_ooc_tpu_torch.cli.sharded_spinup \
        [n_module] [n_space] [ny] [n_steps] [--device cuda|cpu] \
        [--shards-per-device N] [--block-steps 8] [--plain-year]

A mesh of n_module x n_space shards needs n_module * n_space /
shards-per-device cards; --shards-per-device 4 puts a (1, 4) mesh on one
card.  On the CPU every shard lies on the one CPU device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.incore import NewtonKrylovInCore
from ..ops.compute import resolve_device
from ..parallel.mesh import make_mesh, mesh_devices
from ..parallel.sharded_year import ShardedIageKernel
from .incore_spinup import MODELINFO, build_axes

NZ = 24
YEAR = 365.0 * 86400.0
SOLVER = dict(newton_rel_tol=1e-4, krylov_rel_tol=1e-3, newton_max_iter=12,
              krylov_max_dim=30)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_module", nargs="?", type=int, default=1)
    parser.add_argument("n_space", nargs="?", type=int, default=1)
    parser.add_argument("ny", nargs="?", type=int, default=48)
    parser.add_argument("n_steps", nargs="?", type=int, default=2920)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--shards-per-device", type=int, default=1,
                        help="mesh shards on each card (default 1)")
    parser.add_argument("--block-steps", type=int, default=8,
                        help="interior steps per B3 block (default 8)")
    parser.add_argument("--plain-year", action="store_true",
                        help="the per-step sharded year in float64")
    return parser.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, spent):
    """fn, adding each synchronised call's seconds and count to spent"""
    def hook(*args):
        _sync(device)
        start = time.perf_counter()
        out = fn(*args)
        _sync(device)
        spent[0] += time.perf_counter() - start
        spent[1] += 1
        return out
    return hook


def build_kernel(args):
    """the family kernel the arguments describe"""
    device = resolve_device(args.device)
    n_shards = args.n_module * args.n_space
    mesh = make_mesh(args.n_module, args.n_space,
                     devices=mesh_devices(device, n_shards,
                                          args.shards_per_device))
    depth, ypos = build_axes(NZ, args.ny)
    rates = (1.0 + 0.25 * np.arange(4 * args.n_module)) / YEAR
    return ShardedIageKernel(
        mesh, depth, ypos, MODELINFO, rates, n_steps=args.n_steps,
        use_kernel=not args.plain_year, block_steps=args.block_steps,
    )


def main(argv=None):
    """run the spin-up; returns (kernel, x, fcn, info) for callers that
    check the result; info adds seconds, f_seconds, f_evals, jvp_seconds
    and jvp_evals"""
    args = parse_args(argv)
    kernel = build_kernel(args)
    device = kernel.device
    spent_f, spent_jvp = [0.0, 0], [0.0, 0]
    kernel.comp_fcn = _timed(kernel.comp_fcn, device, spent_f)
    kernel.jvp = _timed(kernel.jvp, device, spent_jvp)
    devices = sorted({str(d) for row in kernel.mesh.devices for d in row})
    year = "per-step float64" if args.plain_year else (
        f"B3 blocks of {args.block_steps} steps, float32")
    print(
        f"mesh: {args.n_module} module x {args.n_space} space over "
        f"{', '.join(devices)}; state ({kernel.module_batch}, 2, {NZ}, "
        f"{args.ny}); {args.n_steps} steps/year; {year}"
    )

    solver = NewtonKrylovInCore(kernel, jit_gmres=True, **SOLVER)
    start = time.perf_counter()
    x, fcn, info = solver.solve(kernel.init_iterate())
    _sync(device)
    info.update(seconds=time.perf_counter() - start, f_seconds=spent_f[0],
                f_evals=spent_f[1], jvp_seconds=spent_jvp[0],
                jvp_evals=spent_jvp[1])
    rel = info["fcn_norm"] / info["x_norm"]
    print(
        f"converged in {info['iterations']} Newton iterations, "
        f"{info['seconds']:.1f} s wall (F {spent_f[0]:.1f} s in "
        f"{spent_f[1]}, JVP {spent_jvp[0]:.1f} s in {spent_jvp[1]}); "
        f"max rel residual {rel.max():.2e}"
    )
    print("surface age by module (years):",
          x[:, 0, 0, 0].double().cpu().numpy().round(3))
    return kernel, x, fcn, info


if __name__ == "__main__":
    main()
