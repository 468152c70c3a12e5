"""what kernel B7's steps a launch cost on the card, and where the time of
the blocked sharded 3D year goes.

On one CUDA card, for one shard's slab of the two configurations
chip_smoke.py's phase 13 runs -- (a) the coupled dic/dic14 pair at gx1's
horizontal extent (3 x 384 x 320, T = 2, blocks of 4, a 416-row slab) and
(b) the steady upwind3 year at full gx1 depth (60 x 384 x 320, T = 1, a
392-row slab at k = 1, and a 4-shard 112-row slab at k = 2) -- it times
one block of k steps in one cooperative launch (CUDA events, the median
of five after a warm-up) for k = 1, 2 and the configuration's k (the slab
grows 8 rows a step more), and prints one JSON line each: the schedule's
persistent blocks and tiles a block, the shared memory, microseconds a
block and a step.  Then it profiles one year of (a) on 1 and 8 shards of
the card (torch.profiler, after a warm-up year): wall ms, B7's device ms
and the device's idle share.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_block3d

Needs a CUDA card.  The profiler adds host time to the profiled year, so
its wall time and idle share are upper bounds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.irf_offline import synthetic
from ..ops.compute import resolve_device
from ..ops.transport3d_block_cuda import build_block3d_steps
from ..ops.transport3d_cuda import SEC_PER_YEAR, _cn_bands
from ..ops.transport3d_stream_cuda import _factor_rate_field
from ..parallel.mesh import make_mesh
from ..parallel.sharded_transport3d import (
    build_sharded_transport3d_year_blocked,
    family_year_inputs,
)
from .profile_irf3d import _device_events

# chip_smoke.py phase 13's configurations
COUPLED = (3, 384, 320)
COUPLED_SPECS = [[
    {"name": "dic", "sink_rate_per_year": 0.02,
     "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0,
     "surf_flux_d": {"dic14": 1.5e-4}},
    {"name": "dic14", "source_per_year": 1.0e-3},
]]
GX1 = (60, 384, 320)
REPS = 5


def slab_case(shape, specs, n_space, k, device):
    """(build_block3d_steps' arguments, its keywords, the operands) for
    shard 0's slab of a year on n_space latitude shards, k steps a block"""
    nz, nlat, nlon = shape
    circ = synthetic.gen_circulation(*shape)
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, specs)
    t_dim = diag.shape[0]
    rows = nlat // n_space + 8 * k
    names = [n for n, a in sorted(coef.items()) if a is not None]
    dlb, dub = _cn_bands(kv.numpy(), dz_r.numpy(), nz, nlat, nlon)

    def slab(arr):
        """shard 0's block of (..., nlat, nlon): 4 k zero rows past the
        physical edge, its own rows and 4 k of its neighbour's"""
        pad = [(0, 0)] * (np.ndim(arr) - 2) + [(4 * k, 4 * k), (0, 0)]
        return torch.as_tensor(np.pad(np.asarray(arr, np.float64), pad)
                               [..., :rows, :], dtype=torch.float32,
                               device=device).contiguous()

    wet = slab(circ["mask"] > 0)
    y = wet * torch.rand((t_dim, nz, rows, nlon), generator=torch.Generator(
        device).manual_seed(0), device=device)
    ops = [y, torch.zeros_like(y), torch.stack([slab(coef[n]) for n in names]),
           slab(dlb), slab(dub)]
    rates = [np.asarray(a).reshape(t_dim, nz, nlat, nlon) for a in (diag, src)]
    has = [bool(np.any(a)) for a in rates]
    fac = [_factor_rate_field(a, circ["mask"] > 0) if h else None
           for a, h in zip(rates, has)]
    ops += [slab(a) for a, h, f in zip(rates, has, fac) if h and f is None]
    kwargs = dict(has_diag=has[0], has_src=has[1], diag_fac=fac[0],
                  src_fac=fac[1], couple=couple)
    dt = SEC_PER_YEAR / max(2000, synthetic.stable_steps_per_year(circ))
    return (names, nz, rows, nlon, t_dim, dt, k), kwargs, ops


def time_block(fn, ops):
    """median µs of one block call over REPS, after a warm-up"""
    fn(*ops)
    times = []
    for _ in range(REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*ops)
        end.record()
        torch.cuda.synchronize()
        times.append(1e3 * start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None):
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cases = (("(a) coupled 3 levels, 1 shard", COUPLED, COUPLED_SPECS, 1, 4),
             ("(a) coupled 3 levels, 8 shards", COUPLED, COUPLED_SPECS, 8, 4),
             ("(b) gx1, 1 shard", GX1, [[{"name": "T"}]], 1, 1),
             ("(b) gx1, 4 shards", GX1, [[{"name": "T"}]], 4, 2))
    for label, shape, specs, n_space, k_cfg in cases:
        for k in sorted({1, 2, k_cfg}):
            args, kwargs, ops = slab_case(shape, specs, n_space, k, device)
            fn = build_block3d_steps(*args, **kwargs, device=device)
            micros = time_block(fn, ops)
            sched = fn.schedule(1)
            print(json.dumps({
                "slab": label, "rows": args[2], "k": k,
                "grid": sched.grids[0],
                "tiles_per_block": sched.tiles_per_block[0],
                "smem_bytes": fn.smem_bytes, "us_per_block": micros,
                "us_per_step": micros / k, "card": card}), flush=True)
    # one year of (a) on 1 and 8 shards
    circ = synthetic.gen_circulation(*COUPLED)
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ,
                                                          COUPLED_SPECS)
    y0 = torch.rand((2,) + COUPLED, device=device) * torch.as_tensor(
        circ["mask"] > 0, dtype=torch.float32, device=device)
    for n in (1, 8):
        year = build_sharded_transport3d_year_blocked(
            make_mesh(1, n, devices=[device] * n), coef, kv, dz_r, diag, src,
            (0.0, SEC_PER_YEAR), 368, block_steps=4, couple=couple)
        year(y0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            year(y0)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - start)
        events = _device_events(prof)
        busy = sum(micros for _, _, micros in events) / 1e3
        b7_ms = sum(micros for name, _, micros in events
                    if "block3d_kernel" in name) / 1e3
        print(json.dumps({"year": f"(a) coupled, {n} shard(s), 368 steps",
                          "wall_ms": wall, "device_busy_ms": busy,
                          "b7_device_ms": b7_ms,
                          "idle_share": 1.0 - busy / wall, "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
