"""where the time of the iage solve goes on the card, by torch.profiler.

Runs chip_smoke.py phase 3's solve (cli/incore_spinup.py's IageKernel at
40 x 50, 8760 steps a year, float32 on kernel B1, newton_rel_tol 1e-5) with
the host-driven GMRES, the fused GMRES (jit_gmres) and the fused Newton
solve (jit_newton), each after a warm-up solve: first unprofiled, for its
wall time, then under the profiler.  For each it prints one JSON line for
each of the kernels that take the most device time, and one with the
unprofiled and profiled wall times, the device's busy time (the sum of
every kernel's and copy's device time), its idle share of the profiled
wall time, and the Newton and Krylov counts.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_iage

Needs a CUDA card.  The profiler's trace adds host time, so the idle share
is an upper bound; the unprofiled wall time bounds it from below as
1 - busy / wall.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..core.incore import NewtonKrylovInCore
from ..models.py_driver_2d.incore import IageKernel
from ..ops.compute import resolve_device
from .incore_spinup import MODELINFO, build_axes
from .profile_irf3d import _device_events

NZ, NY, N_STEPS = 40, 50, 8760
SOLVER = dict(newton_rel_tol=1e-5, krylov_rel_tol=1e-2, newton_max_iter=8)
ROUTES = {"host": {}, "jit_gmres": {"jit_gmres": True},
          "jit_newton": {"jit_newton": True}}
TOP, NAME_CHARS = 6, 72


def _solve(kernel, flags):
    torch.cuda.synchronize()
    start = time.perf_counter()
    _, _, info = NewtonKrylovInCore(kernel, **SOLVER, **flags).solve(
        kernel.init_iterate())
    torch.cuda.synchronize()
    return time.perf_counter() - start, info


def main():
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kernel = IageKernel(*build_axes(NZ, NY), MODELINFO, device=device,
                        n_steps=N_STEPS)
    for route, flags in ROUTES.items():
        _solve(kernel, flags)                    # warm-up
        wall, _ = _solve(kernel, flags)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_profiled, info = _solve(kernel, flags)
        events = sorted(_device_events(prof), key=lambda e: -e[2])
        for name, count, micros in events[:TOP]:
            print(json.dumps({"solve": route, "kernel": name[:NAME_CHARS],
                              "launches": count, "total_ms": micros / 1e3,
                              "mean_us": micros / max(count, 1)}),
                  flush=True)
        busy = sum(micros for _, _, micros in events) / 1e6
        print(json.dumps({
            "solve": route, "wall_s": wall,
            "wall_profiled_s": wall_profiled, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall_profiled,
            "device_idle_share_unprofiled": 1.0 - busy / wall,
            "device_launches": sum(count for _, count, _ in events),
            "newton_iterations": info["iterations"],
            "krylov_iterations": [int(k) for k in info["krylov_iterations"]],
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
