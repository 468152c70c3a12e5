#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main path: the py_driver_2d iage
in-core spin-up at full size (40 x 50 depth x ypos, 8760 IMEX steps a
year), through the hand-written CUDA year kernel.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernel is built for sm_90a) and nvcc.
Phases, one line of numbers each; any failure raises and exits non-zero:
  0 device: the card's name and power limit, TF32 off;
  1 build: the kernel from newton_krylov_ooc_tpu_torch/csrc/, with the
    compiler's register and shared-memory report;
  2 kernel against its plain PyTorch version at full size, with the aging
    source on (F) and zeroed (the JVP route), and both timed;
  3 the Newton-Krylov solve through the port's CLI entry point, checked for
    convergence, for launches of the kernel, and against a float64 plain
    evaluation of F at the solution.
Then one JSON line describing each kernel of the path and, last, one JSON
line naming the device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from newton_krylov_ooc_tpu_torch.cli import incore_spinup
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import IageKernel
from newton_krylov_ooc_tpu_torch.ops import compute, imex_cuda

NZ, NY, N_STEPS = 40, 50, 8760
F32_TOL = 5e-5   # kernel vs f32 plain, relative to max|y|: f32 rounding
F64_TOL = 1e-4   # kernel vs f64 plain: Kahan keeps f32 near f64
SOLVE_TOL = 1e-5
REPS = 5


def phase(num, title, **numbers):
    body = " ".join(f"{key}={val}" for key, val in numbers.items())
    print(f"phase {num} {title}: {body}", flush=True)


def timed(fn, *args):
    """(result, milliseconds) of one synchronised call"""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def rel_err(a, b, scale):
    return float((a.double() - b.double()).abs().max()) / scale


def main():
    # -- 0: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    device = compute.resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    compute.check_no_tf32()
    phase(0, "device", name=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, tf32="off")
    print(smi, flush=True)

    # -- 1: build the kernel from the checkout's sources
    lib_path, build_s = imex_cuda.build_library()
    report = lib_path.with_suffix(".log").read_text().strip().splitlines()
    phase(1, "build", seconds=f"{build_s:.2f}", library=lib_path.name)
    for line in report:
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- 2: kernel against the plain version at full size
    depth, ypos = incore_spinup.build_axes(NZ, NY)
    grids = {
        dtype: physics.make_grid(depth, ypos, incore_spinup.MODELINFO,
                                 device=device, dtype=dtype)
        for dtype in (torch.float32, torch.float64)
    }
    probe = IageKernel(depth, ypos, incore_spinup.MODELINFO, device=device,
                       n_steps=N_STEPS)
    diag = probe._vert_diag
    span = (0.0, physics.SEC_PER_YEAR)
    rng = np.random.default_rng(0)
    inputs = {
        "F": (np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR),
              probe.init_iterate().cpu().numpy()),
        "JVP": (np.zeros((2, 1, 1)), rng.standard_normal((2, NZ, NY))),
    }
    worst_abs, kernel_ms, plain_ms = 0.0, [], []
    for route, (source, y0_np) in inputs.items():
        year_k = imex_cuda.build_iage_year(grids[torch.float32], diag, source,
                                           span, N_STEPS, device=device)
        y0 = torch.as_tensor(y0_np, dtype=torch.float32, device=device)
        timed(year_k, y0)  # warm-up
        runs = [timed(year_k, y0) for _ in range(REPS)]
        y_k = runs[-1][0]
        ms = statistics.median(run[1] for run in runs)
        y_32, ms_32 = timed(
            imex_cuda.build_iage_year_plain(grids[torch.float32], diag, source,
                                            span, N_STEPS), y0)
        y_64, _ = timed(
            imex_cuda.build_iage_year_plain(grids[torch.float64], diag, source,
                                            span, N_STEPS), y0.double())
        scale = float(y_64.abs().max())
        err_32, err_64 = rel_err(y_k, y_32, scale), rel_err(y_k, y_64, scale)
        phase(2, f"kernel vs plain ({route})", rel_err_f32=err_32,
              rel_err_f64=err_64, kernel_ms_per_year=ms,
              plain_f32_ms_per_year=ms_32, max_abs_y=scale)
        if not (err_32 <= F32_TOL and err_64 <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: kernel disagrees with the plain year ({route}): "
                f"{err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{err_64:.3e} vs f64 (bound {F64_TOL})"
            )
        worst_abs = max(worst_abs, float((y_k - y_32).abs().max()))
        kernel_ms.append(ms)
        plain_ms.append(ms_32)

    # -- 3: the solve through the CLI entry point, counting kernel launches
    imex_cuda.iage_year_launches = 0
    kernel, x, fcn, info = incore_spinup.main([
        str(NZ), str(NY), str(N_STEPS), "--device", "cuda",
        "--newton-rel-tol", str(SOLVE_TOL),
    ])
    torch.cuda.synchronize()
    launches = imex_cuda.iage_year_launches
    rel = info["fcn_norm"] / info["x_norm"]
    krylov = [int(k) for k in info["krylov_iterations"]]
    # one F per Newton step's Armijo trial and fixed-point update, the
    # initial F, and one JVP per Krylov iteration: a lower bound
    min_launches = 1 + sum(k + 2 for k in krylov)
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: the solve did not dispatch to the kernel")
    if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
        raise SystemExit("chip_smoke: non-finite values in the solution")
    if not (rel < SOLVE_TOL).all():
        raise SystemExit(f"chip_smoke: residual {rel.max():.3e} >= {SOLVE_TOL}")
    if launches < min_launches:
        raise SystemExit(
            f"chip_smoke: {launches} kernel launches, expected >= {min_launches}"
        )
    check = IageKernel(depth, ypos, incore_spinup.MODELINFO, device=device,
                       dtype=torch.float64, n_steps=N_STEPS)
    x64 = x.double()
    rel64 = (check.norm(check.comp_fcn(x64)) / check.norm(x64)).max().item()
    phase(3, "solve", newton_iterations=info["iterations"],
          krylov_iterations=krylov, seconds=info["seconds"],
          max_rel_resid=float(rel.max()), f64_plain_rel_resid=rel64,
          kernel_launches=launches, max_ideal_age_years=float(x.max()))
    if not rel64 < 1e-4:
        raise SystemExit(f"chip_smoke: f64 residual at the solution {rel64:.3e}")

    print(json.dumps({"kernels": [{
        "name": "iage_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:267",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": statistics.median(kernel_ms),
        "plain_ms": statistics.median(plain_ms),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
