"""where the time of the 3D years goes on the card, by torch.profiler.

Runs the JAX bench's gx3 spin-up (cli/irf3d_spinup.py's GX3 settings:
60 x 116 x 100, two modules, float32, kernel B4) on one CUDA card and
prints, as JSON lines:
  * B4's layout (csrc/transport3d_year.cu: one cooperative launch a year,
    tiles of whole columns, resident in shared memory or walked, two grid
    syncs a step): its tile, blocks and grid syncs a year;
  * the device time of each CUDA kernel over one F year (after a warm-up
    year): its name, launches, total and mean time -- B4's year is one
    launch, so its line is the year's kernel time, and its time a step
    that divided by the steps;
  * over a whole solve (the second in the process): the wall time, the
    device's busy time (the sum of every kernel's and copy's device time)
    and its idle share.
With --gx1 it profiles instead one year at the bench's gx1 settings
(60 x 384 x 320, 2000 steps, one tracer, no rates) of the stream kernel B5
in each mode (upwind3, stencil, stencil in bf16) and of B4 on the same
inputs (its tiles walked, the state in device memory), each after a
warm-up year: the same per-kernel lines, by mode.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_irf3d [--gx1]

Needs a CUDA card; the profiler's trace adds host time to the profiled
solve (the preconditioner's and the host loop's launches), so its wall
time is not the solve's own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

import torch
from torch.profiler import ProfilerActivity, profile

from ..core.incore import NewtonKrylovInCore
from ..models.irf_offline import synthetic
from ..ops.compute import resolve_device
from ..ops.transport3d_cuda import (
    SEC_PER_YEAR,
    build_transport3d_year,
    cuda_launches_per_year,
    grid_syncs_per_year,
)
from ..ops.transport3d_stream_cuda import build_transport3d_year_stream
from ..parallel.sharded_transport3d import (
    ShardedTransport3dKernel,
    family_year_inputs,
)
from .irf3d_spinup import GX3, GX3_MIN_STEPS, GX3_SOLVER, GX3_SPECS


def _device_events(prof):
    """(name, launches, device µs) of every device-side entry"""
    return [
        (evt.key, evt.count, evt.self_device_time_total)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
    ]


GX1 = (60, 384, 320)
GX1_MIN_STEPS = 2000


def profile_year(label, year, y0, card):
    """one JSON line per CUDA kernel of one year, after a warm-up year"""
    year(y0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        year(y0)
        torch.cuda.synchronize()
    for name, count, micros in sorted(_device_events(prof), key=lambda e: -e[2]):
        print(json.dumps({"year": label, "kernel": name, "launches": count,
                          "total_ms": micros / 1e3,
                          "mean_us": micros / max(count, 1), "card": card}),
              flush=True)


def profile_gx1(device, card):
    """B5 in each mode and B4, one gx1 year each (bench.py:859-866)"""
    circ = synthetic.gen_circulation(*GX1)
    n_steps = max(GX1_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    span = (0.0, SEC_PER_YEAR)
    wet = torch.as_tensor(circ["mask"] > 0, dtype=torch.float32, device=device)
    y0 = wet * torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 1.0, (1,) + GX1), dtype=torch.float32, device=device)
    shed = {"recip_area": 1.0 / circ["TAREA"], "recip_dz": 1.0 / circ["dz"],
            "t_dim": 1}
    for label, kwargs in (("B5 upwind3", {}), ("B5 stencil", {"stencil": True}),
                          ("B5 stencil bf16",
                           {"stencil": True, "coef_bf16": True})):
        year = build_transport3d_year_stream(coef, kv, dz_r, None, None, span,
                                             n_steps, **shed, **kwargs,
                                             device=device)
        profile_year(label, year, y0, card)
        del year
    zeros = np.zeros((1, GX1[0], GX1[1] * GX1[2]))
    profile_year("B4", build_transport3d_year(coef, kv, dz_r, zeros, zeros,
                                              span, n_steps, device=device),
                 y0, card)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gx1", action="store_true",
                        help="profile the gx1 stream years instead of gx3")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if args.gx1:
        profile_gx1(device, card)
        return
    circ = synthetic.gen_circulation(*GX3)
    n_steps = max(GX3_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    kernel = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                      dtype=torch.float32)
    coef, kv, dz_r, diag, src, _ = family_year_inputs(circ, GX3_SPECS)
    plan = build_transport3d_year(coef, kv, dz_r, diag, src,
                                  (0.0, SEC_PER_YEAR), n_steps,
                                  device=device).plan
    print(json.dumps({"B4_tile": [plan.ty, plan.tx],
                      "resident": plan.resident, "blocks": plan.grid,
                      "launches_per_year": cuda_launches_per_year(n_steps),
                      "grid_syncs_per_year": grid_syncs_per_year(n_steps),
                      "steps": n_steps, "card": card}), flush=True)
    x0 = kernel.init_iterate()
    kernel.comp_fcn(x0)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel.comp_fcn(x0)
        torch.cuda.synchronize()
    for name, count, micros in sorted(_device_events(prof), key=lambda e: -e[2]):
        print(json.dumps({"year_kernel": name, "launches": count,
                          "total_ms": micros / 1e3,
                          "mean_us": micros / max(count, 1),
                          "us_per_step": micros / max(count, 1) / n_steps}),
              flush=True)

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
