#!/usr/bin/env python
"""time the float64 Radau year of the file-backed test_problem and
py_driver_2d models.

For the iage (20 unknowns) and phosphorus (120 unknowns) tendencies at
20 levels, from the gen_init_iterate profiles, rtol = atol = 1e-12 (the
model's), it prints what a process's first integration pays (the first
forward-mode derivative, the first LUs, the stages' capture) and then, for
each number of fast Newton iterations and of fast attempts a replay, the
milliseconds a step attempt of a warm integration over `--days` days with
the runs of each stage.  Every setting gives the same step sequence; only
the time moves.

With --py-driver-2d it times the banded Radau of py_driver_2d's iage
module at model_params.cfg's 40 x 50 instead (two tracers, stage systems 2
x 2000 x 81, float64 at 2e-7, from gen_init_iterate; --grid 30 30 is
ci_py_driver_2d_iage's, 2 x 900 x 61) over `--days` days:
the milliseconds a step attempt of a warm integration replayed from its
CUDA graphs, then, from an eager integration of the same window under
torch.profiler, banded_lu's device time a step attempt by part -- the
stage factors, the Newton iterations' solves, the error estimate's solves
-- and the rest of the attempt (the graph-replayed milliseconds less
banded_lu's).  The parts are torch.profiler.record_function ranges around
ops/radau.py's calls of ops/banded.py.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_radau          # the card
    python -m newton_krylov_ooc_tpu_torch.cli.profile_radau --device cpu
    python -m newton_krylov_ooc_tpu_torch.cli.profile_radau --py-driver-2d \
        [--grid 30 30]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import model_config, share
from ..core.spatial_axis import spatial_axis_defn_dict, spatial_axis_from_defn_dict
from ..models.py_driver_2d import model_state as pd2d_state
from ..models.py_driver_2d import setup_solver as pd2d_setup
from ..models.test_problem import physics
from ..ops import radau
from ..ops.compute import resolve_device

PD2D_INPUT = os.path.join(share.repo_root(), "input", "py_driver_2d")

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


def pd2d_iage_state(workdir, days, device, grid):
    """a py_driver_2d model state of iage on a (depth, ypos) grid of
    model_params.cfg's axes from gen_init_iterate, its year cut to `days`
    days, configured on workdir as the solver configures it"""
    pd2d_state.ModelState.reset_class_state()
    parser, rest = share.common_args("profile_radau", "py_driver_2d", [
        "--cfg_fnames", ",".join(os.path.join(PD2D_INPUT, name) for name in
                                 ("newton_krylov.cfg", "model_params.cfg")),
        "--workdir", workdir, "--tracer_module_names", "iage", "--persist",
        "--device", str(device)])
    args = parser.parse_args(rest)
    config = share.read_cfg_files(args)
    config["modelinfo"]["depth_nlevs"], config["modelinfo"]["ypos_nlevs"] = (
        str(n) for n in grid)
    pd2d_setup.gen_grid_vars_file(args, config["modelinfo"])
    pd2d_state.ModelState.model_config_obj = model_config.ModelConfig(
        config["modelinfo"])

    class Window(pd2d_state.ModelState):
        time_range = (0.0, days * 86400.0)

    return Window("gen_init_iterate")


@contextlib.contextmanager
def banded_ranges():
    """each banded LU call of ops/radau.py inside a record_function range
    named by the part of the attempt that makes it"""
    part = ["factor"]
    saved = []

    def within(name, label):
        method = getattr(radau.Radau5, name)

        def wrapped(self, *args, **kwargs):
            outer, part[0] = part[0], label
            try:
                return method(self, *args, **kwargs)
            finally:
                part[0] = outer

        saved.append((radau.Radau5, name, method))
        setattr(radau.Radau5, name, wrapped)

    def ranged(name, factor):
        fn = getattr(radau, name)

        def wrapped(*args, **kwargs):
            label = "factor" if factor else part[0]
            with torch.profiler.record_function(f"banded_lu {label}"):
                return fn(*args, **kwargs)

        saved.append((radau, name, fn))
        setattr(radau, name, wrapped)

    within("_newton", "newton solves")
    within("_decide", "error solves")
    for name in ("banded_lu_factor_blocks", "banded_lu_factor_pair"):
        if hasattr(radau, name):
            ranged(name, True)
    for name in ("banded_lu_solve_blocks", "banded_lu_solve_pair"):
        if hasattr(radau, name):
            ranged(name, False)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _device_us(event):
    for key in ("device_time_total", "cuda_time_total"):
        if hasattr(event, key):
            return float(getattr(event, key))
    return 0.0


def profile_pd2d(days, device, grid):
    """banded_lu's device time a step attempt of a py_driver_2d iage year,
    by part, and the rest of the attempt"""
    with tempfile.TemporaryDirectory(prefix="profile_radau_") as work:
        state = pd2d_iage_state(work, days, device, grid)
        module = state.tracer_modules[0]
        solver, params, perm, _inv = state._integrator(module, 2)
        params.copy_(torch.as_tensor(module.tend_params(), dtype=params.dtype))
        y0 = torch.as_tensor(module.get_tracer_vals_all().reshape(-1),
                             dtype=solver.dtype, device=device)[perm]
        solver.integrate(y0)  # captures the stages' graphs
        (_, info), seconds = timed(device, lambda: solver.integrate(y0))
        attempts = info["n_attempts"]
        graph_ms = 1e3 * seconds / attempts

        eager = radau.Radau5(
            solver.fun, solver.n, (0.0, days * 86400.0),
            [0.0, days * 86400.0], device=device, rtol=solver.rtol,
            atol=solver.atol, max_step=solver.max_step,
            jac_bands=solver.jac, bandwidth=solver.bandwidth)
        # a state before the first integration: the stages run eagerly
        eager.state = eager._initial_state(y0)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with banded_ranges(), torch.profiler.profile(activities=activities) as prof:
            (_, info_e), _ = timed(device, lambda: eager.integrate(y0))
    parts = {}
    kernels = {}
    for event in prof.key_averages():
        if event.key.startswith("banded_lu "):
            parts[event.key[len("banded_lu "):]] = _device_us(event)
        elif "factor_kernel" in event.key or "solve_kernel" in event.key:
            kind = "factor" if "factor_kernel" in event.key else "solve"
            kernels[kind] = kernels.get(kind, 0.0) + float(
                getattr(event, "self_device_time_total",
                        getattr(event, "self_cuda_time_total", 0.0)))
    n_eager = info_e["n_attempts"]
    per = {key: round(val / n_eager, 2) for key, val in parts.items()}
    banded_us = sum(per.values())
    print(json.dumps({
        f"py_driver_2d iage {grid[0]}x{grid[1]}": f"{days:g} days",
        "attempts": attempts, "nfev": info["nfev"], "nlu": info["nlu"],
        "ms_an_attempt": round(graph_ms, 4),
        "eager_attempts": n_eager,
        "banded_lu_us_an_attempt": per,
        "banded_lu_us_an_attempt_total": round(banded_us, 2),
        "kernel_us_an_attempt": {key: round(val / n_eager, 2)
                                 for key, val in kernels.items()},
        "rest_ms_an_attempt": round(graph_ms - banded_us / 1e3, 4),
    }), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--days", type=float, default=30.0)
    parser.add_argument("--fast-iters", type=int, nargs="+", default=[2, 3])
    parser.add_argument("--per-replay", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--py-driver-2d", action="store_true",
                        help="time the py_driver_2d iage year instead")
    parser.add_argument("--grid", type=int, nargs=2, default=[40, 50],
                        metavar=("NZ", "NY"),
                        help="its depth and ypos levels (model_params.cfg's)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip(), flush=True)
    if args.py_driver_2d:
        profile_pd2d(args.days, device, args.grid)
        return 0

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
