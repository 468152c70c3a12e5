#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's paths at full width (40 x 50 depth x
ypos) through the hand-written CUDA year kernels: the py_driver_2d iage
in-core spin-up (8760 IMEX steps a year, kernel iage_year) and the
py_driver_2d phosphorus in-core spin-up (kernel phosphorus_year).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, one line of numbers each; any failure raises and exits non-zero:
  0 device: the card's name and power limit, TF32 off;
  1 build: both kernels from newton_krylov_ooc_tpu_torch/csrc/, one nvcc
    each, started together, with the compiler's register, spill and
    shared-memory report;
  2 iage_year against its plain PyTorch version at full size, with the
    aging source on (F) and zeroed (the JVP route), and both timed;
  3 the iage Newton-Krylov solve through the port's CLI entry point,
    checked for convergence, for launches of the kernel, and against a
    float64 plain evaluation of F at the solution;
  4 phosphorus_year against its plain PyTorch version at 40 x 50 x 8760,
    from the initial iterate and from a constant 0.5, timed, with the
    one-year drift of total phosphorus;
  5 the phosphorus Newton-Krylov solve (PhosphorusKernel +
    NewtonKrylovInCore, 730 steps a year, float32, F on the kernel and
    JVPs by forward mode), checked for convergence, positivity, launches,
    and against a float64 plain evaluation of F at the solution.
Then one JSON line describing each kernel and, last, one JSON line naming
the device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from newton_krylov_ooc_tpu_torch.cli import incore_spinup
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import phosphorus, physics
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import compute, imex_cuda

NZ, NY, N_STEPS = 40, 50, 8760
F32_TOL = 5e-5   # kernel vs f32 plain, relative to max|y|: f32 rounding
F64_TOL = 1e-4   # kernel vs f64 plain: Kahan keeps f32 near f64
SOLVE_TOL = 1e-5
REPS = 5
# the JAX in-core phosphorus test's settings (tests/test_imex_incore.py):
# 730 steps keep the forward-mode JVPs, plain PyTorch on the card, short
PHOS_STEPS = 730
PHOS_SOLVE_TOL = 1e-4
PHOS_MAX_NEWTON = 4


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


def kernel_timing(year, y0):
    """(result, median ms) of REPS synchronised runs after one warm-up"""
    timed(year, y0)
    runs = [timed(year, y0) for _ in range(REPS)]
    return runs[-1][0], statistics.median(run[1] for run in runs)


def total_p(depth, ypos, y):
    """total phosphorus: the grid-weighted (dz dy) sum over cells and
    tracers, in float64"""
    weight = torch.as_tensor(np.outer(depth.delta, ypos.delta),
                             dtype=torch.float64, device=y.device)
    return float((weight * y.double()).sum())


def timed_hook(fn, spent):
    """fn, adding each synchronised call's seconds and count to spent"""
    def hook(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - start
        spent[1] += 1
        return out
    return hook


def phosphorus_kernel_phase(depth, ypos, device):
    """phase 4: phosphorus_year against its plain version at full size;
    returns (max abs error, kernel ms, plain f32 ms) over the inputs"""
    probe = PhosphorusKernel(depth, ypos, incore_spinup.MODELINFO,
                             device=device, n_steps=PHOS_STEPS)
    span = (0.0, physics.SEC_PER_YEAR)
    plain_args = {
        dtype: (physics.make_grid(depth, ypos, incore_spinup.MODELINFO,
                                  device=device, dtype=dtype),
                probe.params,
                phosphorus.light_lim_2d(depth, ypos, device=device,
                                        dtype=dtype),
                span, N_STEPS)
        for dtype in (torch.float32, torch.float64)
    }
    year_k = imex_cuda.build_phosphorus_year(*plain_args[torch.float32],
                                             device=device)
    inputs = {
        "init_iterate": probe.init_iterate(),
        "const_0.5": torch.full((3, NZ, NY), 0.5, dtype=torch.float32,
                                device=device),
    }
    worst_abs, kernel_ms, plain_ms = 0.0, [], []
    for label, y0 in inputs.items():
        y_k, ms = kernel_timing(year_k, y0)
        y_32, ms_32 = timed(
            imex_cuda.build_phosphorus_year_plain(*plain_args[torch.float32]),
            y0)
        numbers = {}
        scale = float(y_32.abs().max())
        p0 = total_p(depth, ypos, y0)
        if label == "init_iterate":
            y_64, ms_64 = timed(
                imex_cuda.build_phosphorus_year_plain(
                    *plain_args[torch.float64]), y0.double())
            scale = float(y_64.abs().max())
            numbers = {
                "rel_err_f64": rel_err(y_k, y_64, scale),
                "plain_f64_ms_per_year": ms_64,
                "p_drift_plain_f64": abs(total_p(depth, ypos, y_64) - p0) / p0,
            }
        err_32 = rel_err(y_k, y_32, scale)
        phase(4, f"phosphorus_year vs plain ({label})", rel_err_f32=err_32,
              **numbers, kernel_ms_per_year=ms, plain_f32_ms_per_year=ms_32,
              p_drift_kernel=abs(total_p(depth, ypos, y_k) - p0) / p0,
              max_abs_y=scale)
        if not (torch.isfinite(y_k).all() and err_32 <= F32_TOL
                and numbers.get("rel_err_f64", 0.0) <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: phosphorus_year disagrees with the plain year "
                f"({label}): {err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{numbers.get('rel_err_f64')} vs f64 (bound {F64_TOL})"
            )
        worst_abs = max(worst_abs, float((y_k - y_32).abs().max()))
        kernel_ms.append(ms)
        plain_ms.append(ms_32)
    return worst_abs, statistics.median(kernel_ms), statistics.median(plain_ms)


def phosphorus_solve_phase(depth, ypos, device):
    """phase 5: the phosphorus spin-up as the JAX package drives it
    (PhosphorusKernel + NewtonKrylovInCore); returns the kernel's launches"""
    kernel = PhosphorusKernel(depth, ypos, incore_spinup.MODELINFO,
                              device=device, dtype=torch.float32,
                              n_steps=PHOS_STEPS)
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: PhosphorusKernel did not dispatch to "
                         "the kernel")
    spent_f, spent_jvp = [0.0, 0], [0.0, 0]
    kernel.comp_fcn = timed_hook(kernel.comp_fcn, spent_f)
    kernel.jvp = timed_hook(kernel.jvp, spent_jvp)
    solver = NewtonKrylovInCore(kernel, newton_rel_tol=PHOS_SOLVE_TOL,
                                newton_max_iter=8)
    x0 = kernel.init_iterate()

    imex_cuda.iage_year_launches = 0
    imex_cuda.phosphorus_year_launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    x, fcn, info = solver.solve(x0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = imex_cuda.phosphorus_year_launches

    rel = info["fcn_norm"] / info["x_norm"]
    p0 = total_p(depth, ypos, x0)
    check = PhosphorusKernel(depth, ypos, incore_spinup.MODELINFO,
                             device=device, dtype=torch.float64,
                             n_steps=PHOS_STEPS)
    x64 = x.double()
    rel64 = (check.norm(check.comp_fcn(x64)) / check.norm(x64)).max().item()
    phase(5, "phosphorus solve", newton_iterations=info["iterations"],
          krylov_iterations=[int(k) for k in info["krylov_iterations"]],
          seconds=seconds, f_seconds=spent_f[0], f_evals=spent_f[1],
          jvp_seconds=spent_jvp[0], jvp_evals=spent_jvp[1],
          max_rel_resid=float(rel.max()), f64_plain_rel_resid=rel64,
          kernel_launches=launches, min_po4=float(x[0].min()),
          p_drift=abs(total_p(depth, ypos, x) - p0) / p0)
    if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
        raise SystemExit("chip_smoke: non-finite values in the phosphorus "
                         "solution")
    if not ((rel < PHOS_SOLVE_TOL).all()
            and info["iterations"] <= PHOS_MAX_NEWTON):
        raise SystemExit(
            f"chip_smoke: phosphorus residual {rel.max():.3e} after "
            f"{info['iterations']} Newton steps (bounds {PHOS_SOLVE_TOL}, "
            f"{PHOS_MAX_NEWTON})"
        )
    if not float(x[0].min()) > 0.0:
        raise SystemExit("chip_smoke: po4 not positive at the solution")
    if launches < spent_f[1]:
        raise SystemExit(
            f"chip_smoke: {launches} phosphorus_year launches for "
            f"{spent_f[1]} F evaluations"
        )
    if not rel64 < PHOS_SOLVE_TOL:
        raise SystemExit(f"chip_smoke: f64 phosphorus residual at the "
                         f"solution {rel64:.3e}")
    return launches


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

    # -- 1: build every kernel from the checkout's sources, all at once
    start = time.perf_counter()
    built = imex_cuda.build_libraries()
    phase(1, "build", seconds=f"{time.perf_counter() - start:.2f}",
          kernels=len(built))
    for name, (lib_path, build_s) in built.items():
        print(f"  {name}: {lib_path.name} nvcc {build_s:.2f} s", flush=True)
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if any(key in line for key in ("registers", "spill", "smem")):
                print(f"    ptxas: {line.strip()}", flush=True)

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
        y_k, ms = kernel_timing(year_k, y0)
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
    imex_cuda.phosphorus_year_launches = 0
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

    # -- 4, 5: the phosphorus kernel, then the phosphorus spin-up
    phos_abs, phos_ms, phos_plain_ms = phosphorus_kernel_phase(depth, ypos,
                                                               device)
    phos_launches = phosphorus_solve_phase(depth, ypos, device)

    print(json.dumps({"kernels": [{
        "name": "iage_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:267",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": statistics.median(kernel_ms),
        "plain_ms": statistics.median(plain_ms),
    }, {
        "name": "phosphorus_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/phosphorus_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:495",
        "launches": phos_launches,
        "max_abs_err": phos_abs,
        "ms": phos_ms,
        "plain_ms": phos_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
