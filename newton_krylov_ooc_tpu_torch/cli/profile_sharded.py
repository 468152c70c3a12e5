"""where the time of the blocked sharded year goes on the card, by
torch.profiler.

Profiles, after a warm-up year each, on one CUDA card:
  * the JAX bench's million-cell blocked year (256 x 2000, one module of
    two tracers, 12,615 steps, blocks of 8 steps, a (1, 1) mesh): the
    device time of each CUDA kernel (B3's one cooperative launch for the
    year's interior, and the plain PyTorch edge steps: the CN half steps
    and the final Heun) and the year's device idle share;
  * one F year of cli/sharded_spinup.py's spin-up at the example's
    defaults (4 modules, 24 x 48, 2920 steps) on a (1, 1) mesh and on 4
    shards of the card (all four in the same launch): the same lines,
    with B3's layout (steps between its in-launch halo exchanges, owned
    columns a tile, tiles) and the host's halo copies a year.
It prints one JSON line for each of the four kernels that take the most
device time, and one a year with the wall time, the device's busy time
(the sum of every kernel's and copy's device time) and its idle share.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_sharded

Needs a CUDA card.  The profiler's trace adds host time to each profiled
year, so its wall time and idle share are upper bounds.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.py_driver_2d import physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
from ..ops.compute import resolve_device
from ..parallel.mesh import make_mesh
from ..ops import imex_block_cuda
from ..parallel import sharded_year
from ..parallel.sharded_year import build_sharded_year_blocked
from . import sharded_spinup
from .incore_spinup import MODELINFO, build_axes
from .profile_irf3d import _device_events

BIG = (256, 2000)
BIG_STEPS = 12615   # the bench's stable_step_count at 256 x 2000
TOP, NAME_CHARS = 4, 72   # the kernels printed a year, their names cut
MESHES = (("(1, 1)", ["1", "1"]),
          ("(1, 4) on one card",
           ["1", "4", "--shards-per-device", "4", "--block-steps", "4"]))


def profile_year(label, year, y0, card):
    """per-kernel lines and the idle share of one year after a warm-up"""
    year(y0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        year(y0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = sorted(_device_events(prof), key=lambda e: -e[2])
    for name, count, micros in events[:TOP]:
        print(json.dumps({"year": label, "kernel": name[:NAME_CHARS],
                          "launches": count, "total_ms": micros / 1e3,
                          "mean_us": micros / max(count, 1)}), flush=True)
    busy = sum(micros for _, _, micros in events) / 1e6
    print(json.dumps({"year": label, "wall_s": wall, "device_busy_s": busy,
                      "device_idle_share": 1.0 - busy / wall, "card": card}),
          flush=True)


def main():
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    nz, ny = BIG
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((1, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    year = build_sharded_year_blocked(
        make_mesh(1, 1, devices=[device]), depth, ypos, MODELINFO, diag,
        np.full((1, 2), 1.0 / physics.SEC_PER_YEAR, np.float32),
        (0.0, physics.SEC_PER_YEAR), BIG_STEPS, block_steps=8)
    y0 = torch.full((1, 2, nz, ny), 0.5, dtype=torch.float32, device=device)
    profile_year(f"million-cell {nz}x{ny}x{BIG_STEPS}", year, y0, card)
    del year

    for label, argv in MESHES:
        kernel = sharded_spinup.build_kernel(
            sharded_spinup.parse_args(argv + ["--device", "cuda"]))
        before = (imex_block_cuda.iage_block_launches,
                  sharded_year.halo_copies)
        profile_year(f"spin-up F {label}", kernel._year,
                     kernel.init_iterate(), card)
        print(json.dumps({
            "year": f"spin-up F {label}",
            "b3_launches_per_year":
                (imex_block_cuda.iage_block_launches - before[0]) / 2,
            "host_halo_copies_per_year":
                (sharded_year.halo_copies - before[1]) / 2}), flush=True)


if __name__ == "__main__":
    main()
