#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's paths at full width through the
hand-written CUDA year kernels: the py_driver_2d iage in-core spin-up (40 x
50 depth x ypos, 8760 IMEX steps a year, kernel iage_year), the
py_driver_2d phosphorus in-core spin-up (kernel phosphorus_year) and the 3D
irf_offline in-core spin-up at POP gx3 extents (60 x 116 x 100, 2000 steps
a year, kernel transport3d_year).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, one line of numbers each; any failure raises and exits non-zero:
  0 device: the card's name and power limit, TF32 off;
  1 build: every kernel from newton_krylov_ooc_tpu_torch/csrc/, one nvcc
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
    and against a float64 plain evaluation of F at the solution;
  6 transport3d_year against its plain PyTorch year at gx3 (the JAX
    bench's two-module family, T = 2), for a steady circulation (against the
    plain float32 and float64 years, timed), a 12-month seasonal one and the
    gas-exchange-coupled ABIO_DIC/DIC14 pair;
  7 the gx3 spin-up (ShardedTransport3dKernel + NewtonKrylovInCore with the
    JAX bench's settings, float32, F and JVPs on the kernel), checked for
    convergence, for launches, and against a float64 plain evaluation of F
    at the solution, with the seconds in F, JVPs and the preconditioner.
Then one JSON line describing each kernel -- with the least time the card
could take for its year (bound_ms, from the H100's published peaks) -- and,
last, one JSON line naming the device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from newton_krylov_ooc_tpu_torch.cli import incore_spinup, irf3d_spinup
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import phosphorus, physics
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import compute, imex_cuda, transport3d_cuda
from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (
    ShardedTransport3dKernel,
    family_year_inputs,
)

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
# the JAX bench's gx3 3D spin-up (cli/irf3d_spinup.py)
GX3 = irf3d_spinup.GX3
GX3_MIN_STEPS = irf3d_spinup.GX3_MIN_STEPS
GX3_SPECS = irf3d_spinup.GX3_SPECS
GX3_SOLVER = irf3d_spinup.GX3_SOLVER

# the least time the card could take: one H100 SXM's published peaks
# (memory rate, dense float32 rate), against the bytes each year must move (each
# input read once, each output written once) and the float32 operations
# it does, counted once per cell from the kernels' code
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# kv_edge of csrc/imex_common.cuh: the mixed-layer ramp, two
# antiderivatives, expf and the Peclet limiter, once per edge and step
KV_EDGE_OPS = 35
# csrc/iage_year.cu per cell, channel and step: the fused-flux tendency
# twice (18 each), the stage state (2), the Heun Kahan add (6), the CN
# Thomas solve with its Kahan add (28)
IAGE_CELL_OPS = 72
# csrc/phosphorus_year.cu per cell and step, all three tracers: tend3 twice
# (71 each: three tendencies, uptake, remineralisation, sinking), stage
# states (6), three Heun Kahan adds (18), three CN solves without the
# diagonal (25 each)
PHOS_CELL_OPS = 241
# csrc/transport3d_year.cu per cell, tracer and step, each face once: two
# upwind3 tendencies (81 and 83: a face value and flux of 24 in each
# direction, the wet mask, the stage state, the divergence, recip_vol and
# src), the Heun Kahan add (6), the CN Thomas solve with its Kahan add (28)
T3D_CELL_OPS = 198
CN_CELL_OPS = 28


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


def bound(n_bytes, n_ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its float32 rate"""
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_F32_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def grid2d_floats(nz, ny):
    """the 2D kernels' constant grid fields (csrc/imex_common.cuh)"""
    return (2 * nz * (ny - 1) + (nz - 1) * ny + 2 * ny + 2 * nz
            + 2 * (nz - 1))


def iage_bound(t_dim, nz, ny, n_steps):
    n_bytes = 4 * (3 * t_dim * nz * ny + grid2d_floats(nz, ny))
    n_ops = n_steps * (t_dim * nz * ny * IAGE_CELL_OPS
                       + (nz - 1) * ny * KV_EDGE_OPS)
    return bound(n_bytes, n_ops)


def phosphorus_bound(nz, ny, n_steps):
    n_bytes = 4 * (7 * nz * ny + grid2d_floats(nz, ny))
    n_ops = n_steps * (nz * ny * PHOS_CELL_OPS + (nz - 1) * ny * KV_EDGE_OPS)
    return bound(n_bytes, n_ops)


def transport3d_bound(coef, kv, t_dim, n_steps):
    """bound of one steady or seasonal uncoupled year: every present
    coefficient field (all months), kv, dz_r, diag, src and y0 read once,
    the year's end written once"""
    nz, nlat, nlon = coef["wet"].shape
    n = nz * nlat * nlon
    fields = sum(coef[key].numel() for key in
                 ("wet", "recip_vol", "t_e", "t_n", "t_t", "cond_e", "cond_n")
                 if coef.get(key) is not None)
    n_bytes = 4 * (fields + kv.numel() + nz + 4 * t_dim * n)
    n_ops = t_dim * n * (n_steps * T3D_CELL_OPS + CN_CELL_OPS)
    return bound(n_bytes, n_ops)


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
    transport3d_cuda.transport3d_year_launches = 0
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


def _to(coef, device, dtype):
    return {key: None if arr is None else arr.to(device, dtype)
            for key, arr in coef.items()}


def transport3d_kernel_phase(device):
    """phase 6: transport3d_year against its plain year at gx3, for a
    steady, a seasonal and a coupled year; returns (max abs error, kernel
    ms, plain f32 ms, bound ms, bounded by) of the timed steady year"""
    nz, nlat, nlon = GX3
    steady = synthetic.gen_circulation(nz, nlat, nlon)
    seasonal = synthetic.gen_circulation(nz, nlat, nlon, n_seasons=12)
    span = (0.0, transport3d_cuda.SEC_PER_YEAR)
    rng = np.random.default_rng(3)
    cases = (("steady", steady, GX3_SPECS), ("seasonal", seasonal, GX3_SPECS),
             ("coupled", steady, irf3d_spinup.ABIO_SPECS))
    worst_abs, timing = 0.0, None
    for label, circ, specs in cases:
        n_steps = max(GX3_MIN_STEPS, synthetic.stable_steps_per_year(circ))
        coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, specs)
        args = (kv, dz_r, diag, src, span, n_steps)
        t_dim = diag.shape[0]
        wet = torch.as_tensor(circ["mask"] > 0, dtype=torch.float32,
                              device=device)
        y0 = wet * torch.as_tensor(rng.uniform(0.0, 1.0, (t_dim,) + GX3),
                                   dtype=torch.float32, device=device)
        year_k = transport3d_cuda.build_transport3d_year(
            coef, *args, couple, device=device)
        if label == "steady":
            y_k, ms = kernel_timing(year_k, y0)
        else:
            y_k, ms = timed(year_k, y0)
        y_32, ms_32 = timed(transport3d_cuda.build_transport3d_year_plain(
            _to(coef, device, torch.float32), *args, couple), y0)
        scale = float(y_32.abs().max())
        numbers = {}
        if label == "steady":
            y_64, ms_64 = timed(transport3d_cuda.build_transport3d_year_plain(
                _to(coef, device, torch.float64), *args, couple), y0.double())
            scale = float(y_64.abs().max())
            numbers = {"rel_err_f64": rel_err(y_k, y_64, scale),
                       "plain_f64_ms_per_year": ms_64}
        err_32 = rel_err(y_k, y_32, scale)
        phase(6, f"transport3d_year vs plain ({label}, {nz}x{nlat}x{nlon}, "
                 f"T={t_dim}, {n_steps} steps)",
              rel_err_f32=err_32, **numbers, kernel_ms_per_year=ms,
              plain_f32_ms_per_year=ms_32,
              cuda_launches_per_year=transport3d_cuda.cuda_launches_per_year(
                  n_steps),
              max_abs_y=scale)
        if not (torch.isfinite(y_k).all() and err_32 <= F32_TOL
                and numbers.get("rel_err_f64", 0.0) <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: transport3d_year disagrees with the plain year "
                f"({label}): {err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{numbers.get('rel_err_f64')} vs f64 (bound {F64_TOL})"
            )
        if float((y_k * (1.0 - wet)).abs().max()) != 0.0:
            raise SystemExit(f"chip_smoke: transport3d_year wets land ({label})")
        worst_abs = max(worst_abs, float((y_k - y_32).abs().max()))
        if label == "steady":
            timing = (ms, ms_32, *transport3d_bound(coef, kv, t_dim, n_steps))
    return (worst_abs, *timing)


def transport3d_solve_phase(device):
    """phase 7: the gx3 spin-up as the JAX bench drives it
    (ShardedTransport3dKernel + NewtonKrylovInCore); returns the kernel's
    launches"""
    circ = synthetic.gen_circulation(*GX3)
    n_steps = max(GX3_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    kernel = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                      dtype=torch.float32)
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: ShardedTransport3dKernel did not "
                         "dispatch to the kernel")
    spent_f, spent_jvp, spent_pc = [0.0, 0], [0.0, 0], [0.0, 0]
    kernel.comp_fcn = timed_hook(kernel.comp_fcn, spent_f)
    kernel.jvp = timed_hook(kernel.jvp, spent_jvp)
    kernel.precond_setup = timed_hook(kernel.precond_setup, spent_pc)
    kernel.precond_apply = timed_hook(kernel.precond_apply, spent_pc)
    solver = NewtonKrylovInCore(kernel, **GX3_SOLVER)
    x0 = kernel.init_iterate()

    imex_cuda.iage_year_launches = 0
    imex_cuda.phosphorus_year_launches = 0
    transport3d_cuda.transport3d_year_launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    x, fcn, info = solver.solve(x0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = transport3d_cuda.transport3d_year_launches

    rel = info["fcn_norm"] / info["x_norm"]
    check = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                     dtype=torch.float64)
    x64 = x.double()
    rel64 = (check.norm(check.comp_fcn(x64)) / check.norm(x64)).max().item()
    phase(7, f"gx3 solve ({n_steps} steps)",
          newton_iterations=info["iterations"],
          krylov_iterations=[int(k) for k in info["krylov_iterations"]],
          seconds=seconds, f_seconds=spent_f[0], f_evals=spent_f[1],
          jvp_seconds=spent_jvp[0], jvp_evals=spent_jvp[1],
          precond_seconds=spent_pc[0], precond_calls=spent_pc[1],
          max_rel_resid=float(rel.max()), f64_plain_rel_resid=rel64,
          kernel_launches=launches)
    if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
        raise SystemExit("chip_smoke: non-finite values in the gx3 solution")
    if not (rel < GX3_SOLVER["newton_rel_tol"]).all():
        raise SystemExit(f"chip_smoke: gx3 residual {rel.max():.3e} >= "
                         f"{GX3_SOLVER['newton_rel_tol']}")
    if launches < spent_f[1] + spent_jvp[1]:
        raise SystemExit(
            f"chip_smoke: {launches} transport3d_year launches for "
            f"{spent_f[1]} F evaluations and {spent_jvp[1]} JVPs"
        )
    if not rel64 < 1e-4:
        raise SystemExit(f"chip_smoke: f64 gx3 residual at the solution "
                         f"{rel64:.3e}")
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
    transport3d_cuda.transport3d_year_launches = 0
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

    # -- 6, 7: the 3D transport kernel, then the gx3 spin-up
    t3d_abs, t3d_ms, t3d_plain_ms, t3d_bound, t3d_by = (
        transport3d_kernel_phase(device))
    t3d_launches = transport3d_solve_phase(device)

    # no single PyTorch call computes an IMEX year: library_ms is null
    iage_bound_ms, iage_by = iage_bound(2, NZ, NY, N_STEPS)
    phos_bound_ms, phos_by = phosphorus_bound(NZ, NY, N_STEPS)
    print(json.dumps({"kernels": [{
        "name": "iage_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:267",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": statistics.median(kernel_ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": iage_bound_ms,
        "bound_by": iage_by,
        "library_ms": None,
    }, {
        "name": "phosphorus_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/phosphorus_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:495",
        "launches": phos_launches,
        "max_abs_err": phos_abs,
        "ms": phos_ms,
        "plain_ms": phos_plain_ms,
        "bound_ms": phos_bound_ms,
        "bound_by": phos_by,
        "library_ms": None,
    }, {
        "name": "transport3d_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/transport3d_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/transport3d_pallas.py:176",
        "launches": t3d_launches,
        "max_abs_err": t3d_abs,
        "ms": t3d_ms,
        "plain_ms": t3d_plain_ms,
        "bound_ms": t3d_bound,
        "bound_by": t3d_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
