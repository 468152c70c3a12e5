#!/usr/bin/env python
"""time the float64 Radau year of the file-backed test_problem model.

For the iage (20 unknowns) and phosphorus (120 unknowns) tendencies at
20 levels, from the gen_init_iterate profiles, rtol = atol = 1e-12 (the
model's), it prints what a process's first integration pays (the first
forward-mode derivative, the first LUs, the stages' capture) and then, for
each number of fast Newton iterations and of fast attempts a replay, the
milliseconds a step attempt of a warm integration over `--days` days with
the runs of each stage.  Every setting gives the same step sequence; only
the time moves.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_radau          # the card
    python -m newton_krylov_ooc_tpu_torch.cli.profile_radau --device cpu
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..core.spatial_axis import spatial_axis_defn_dict, spatial_axis_from_defn_dict
from ..models.test_problem import physics
from ..ops import radau
from ..ops.compute import resolve_device

PROFILES = {
    "iage": [([125.0, 650.0], [0.0, 1000.0])],
    "phosphorus": [([125.0, 375.0], [0.0, 4.1]), ([100.0, 250.0], [7.3e-2, 0.0]),
                   ([175.0, 425.0], [1.8e-2, 0.0])] * 2,
}


def timed(device, fn):
    """(result, seconds) of one call, synchronised on a card"""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - start


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--days", type=float, default=30.0)
    parser.add_argument("--fast-iters", type=int, nargs="+", default=[2, 3])
    parser.add_argument("--per-replay", type=int, nargs="+", default=[2, 4, 8])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip(), flush=True)

    depth = spatial_axis_from_defn_dict(spatial_axis_defn_dict(nlevs=20))
    grid = physics.column_grid(depth, device=device)
    tends = {"iage": physics.make_iage_tend(grid),
             "phosphorus": physics.make_phosphorus_tend(grid, 1)}
    y0s = {name: torch.as_tensor(np.concatenate(
        [np.interp(depth.mid, d, v) for d, v in profile]), device=device)
        for name, profile in PROFILES.items()}
    span = (0.0, args.days * 86400.0)
    t_eval = np.linspace(*span, 11)
    t0 = torch.zeros((), dtype=torch.float64, device=device)

    # what a process pays once
    _, first_jac = timed(device, lambda: radau.forward_jacobian(
        tends["iage"], t0, y0s["iage"]))
    _, again_jac = timed(device, lambda: radau.forward_jacobian(
        tends["iage"], t0, y0s["iage"]))
    solver = radau.Radau5(tends["iage"], 20, span, t_eval, device=device,
                          rtol=1e-12, atol=1e-12)
    _, first_year = timed(device, lambda: solver.integrate(y0s["iage"]))
    _, warm_year = timed(device, lambda: solver.integrate(y0s["iage"]))
    print(f"first forward-mode Jacobian {first_jac:.4f} s (again {again_jac:.4f}); "
          f"first integration, stages captured, {first_year:.4f} s "
          f"(warm {warm_year:.4f})", flush=True)

    saved = radau.FAST_NEWTON_ITERS, radau.ATTEMPTS_PER_REPLAY
    try:
        for fast in args.fast_iters:
            radau.FAST_NEWTON_ITERS = fast
            for per_replay in args.per_replay:
                radau.ATTEMPTS_PER_REPLAY = per_replay
                for name, fun in tends.items():
                    solver = radau.Radau5(
                        fun, y0s[name].shape[0], span, t_eval, device=device,
                        rtol=1e-12, atol=1e-12)
                    solver.integrate(y0s[name])
                    solver.runs.clear()
                    (_, info), seconds = timed(
                        device, lambda: solver.integrate(y0s[name]))
                    print(f"fast_iters={fast} per_replay={per_replay} {name}: "
                          f"ms_an_attempt={1e3 * seconds / info['n_attempts']:.4f} "
                          f"attempts={info['n_attempts']} nfev={info['nfev']} "
                          f"nlu={info['nlu']} runs={dict(solver.runs)}", flush=True)
    finally:
        radau.FAST_NEWTON_ITERS, radau.ATTEMPTS_PER_REPLAY = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
