"""where the time of the 3D spin-up goes on the card, by torch.profiler.

Runs the JAX bench's gx3 spin-up (cli/irf3d_spinup.py's GX3 settings:
60 x 116 x 100, two modules, float32, kernel B4) on one CUDA card and
prints, as JSON lines:
  * the device time of each CUDA kernel over one B4 year (after a warm-up
    year): its name, launches, total and mean time;
  * over a whole solve (the second in the process): the wall time, the
    device's busy time (the sum of every kernel's and copy's device time)
    and its idle share.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_irf3d

Needs a CUDA card; the profiler's trace of ~90,000 launches adds host
time to the profiled solve, so its wall time is not the solve's own.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..core.incore import NewtonKrylovInCore
from ..models.irf_offline import synthetic
from ..ops.compute import resolve_device
from ..parallel.sharded_transport3d import ShardedTransport3dKernel
from .irf3d_spinup import GX3, GX3_MIN_STEPS, GX3_SOLVER, GX3_SPECS


def _device_events(prof):
    """(name, launches, device µs) of every device-side entry"""
    return [
        (evt.key, evt.count, evt.self_device_time_total)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
    ]


def main():
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    circ = synthetic.gen_circulation(*GX3)
    n_steps = max(GX3_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    kernel = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                      dtype=torch.float32)
    x0 = kernel.init_iterate()
    kernel.comp_fcn(x0)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel.comp_fcn(x0)
        torch.cuda.synchronize()
    for name, count, micros in sorted(_device_events(prof), key=lambda e: -e[2]):
        print(json.dumps({"year_kernel": name, "launches": count,
                          "total_ms": micros / 1e3,
                          "mean_us": micros / max(count, 1)}), flush=True)

    NewtonKrylovInCore(kernel, **GX3_SOLVER).solve(x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        _, _, info = NewtonKrylovInCore(kernel, **GX3_SOLVER).solve(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    busy = sum(micros for _, _, micros in _device_events(prof)) / 1e6
    print(json.dumps({
        "solve_wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "newton_iterations": info["iterations"],
        "krylov_iterations": [int(k) for k in info["krylov_iterations"]],
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
