#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's paths at full width through the
hand-written CUDA year kernels: the py_driver_2d iage in-core spin-up (40 x
50 depth x ypos, 8760 IMEX steps a year, kernel iage_year), the
py_driver_2d phosphorus in-core spin-up (kernel phosphorus_year) and the 3D
irf_offline in-core spin-up at POP gx3 extents (60 x 116 x 100, 2000 steps
a year, kernel transport3d_year), the streaming 3D year at POP gx1 extents
(60 x 384 x 320, 2000 steps a year, kernel transport3d_stream), and the
sharded py_driver_2d module-family spin-up on a (module, space) mesh
(kernel iage_block, the interior of the blocked sharded year), the
blocked latitude-sharded 3D year (kernel transport3d_block) at gx1's
horizontal extent and at full gx1 depth, and the first layout of the iage
year (kernel iage_year_v1, iage_year's PCR variant), and the dense year
operator of the iage year, probed through iage_year under its channel map;
the file-backed Newton-Krylov path of the test_problem model
(setup_solver and nk_driver, float64 on the card, no kernel of its own),
held against the committed ci baselines; and py_driver_2d's file-backed
path (setup_solver and nk_driver, the float64 Radau year in banded mode,
kernel banded_lu, which replaces a lax.scan, not a Pallas kernel), held
against its committed ci baselines and against the dense route.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 0 1 8   # some phases, no JSON lines

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, one line of numbers each; any failure raises and exits non-zero:
  0 device: the card's name and power limit, TF32 off;
  1 build: every kernel from newton_krylov_ooc_tpu_torch/csrc/, one nvcc
    each, started together, with the compiler's register, spill and
    shared-memory report;
  2 iage_year against its plain PyTorch version at full size, with the
    aging source on (F) and zeroed (the JVP route): each full year timed,
    and each held against the plain f32 and f64 years over the first tenth
    of the year (876 steps; the F route's tenth, kernel and plain f32, are
    its JSON entry's times); iage_table, the table of the year's CN solves
    that iage_year and iage_year_v1 stream, against its plain version over
    the tenth (its JSON entry's times) and its full year's build timed;
  3 the iage Newton-Krylov solve through the port's CLI entry point
    (host-driven), then on the CLI's kernel host-driven, with the fused
    GMRES and with the fused Newton solve, each checked for convergence and
    for launches of the kernel and of the table kernel (one table for every
    solve's F and JVP years), the CLI's solution against a float64 plain
    evaluation of F, and each fused solve against the host one: the same
    Newton count, Krylov counts within one at each step, iterates within
    1e-4 (phases 7, 10 and 12 hold theirs so too);
  4 phosphorus_year against its plain PyTorch version at 40 x 50 x 8760,
    from the initial iterate, from seeded uniform noise and from a constant
    0.5, timed, with the kernel's one-year drift of total phosphorus: each
    held against the plain f32 year (the initial iterate's also the f64
    year) over the first tenth, overall and for each tracer, the initial
    iterate's tenth timed for its JSON entry; the year's table (B1's table
    kernel at one channel and a zero diagonal) with its bytes and build ms;
  5 the phosphorus Newton-Krylov solve (PhosphorusKernel +
    NewtonKrylovInCore, 146 steps a year, float32, F on the kernel and
    JVPs by forward mode), checked for convergence, positivity, launches
    (one table for the solve's F years), and against a float64 plain
    evaluation of F at the solution;
  6 transport3d_year against its plain PyTorch year at gx3 (the JAX
    bench's two-module family, T = 2), for a steady circulation (against the
    plain float32 and float64 years, timed), a 12-month seasonal one and the
    gas-exchange-coupled ABIO_DIC/DIC14 pair, with the kernel's launches
    (one a year), grid syncs a year and tile layout;
  7 the gx3 spin-up (ShardedTransport3dKernel + NewtonKrylovInCore with the
    JAX bench's settings, float32, F and JVPs on the kernel), host-driven
    and with the fused GMRES, checked for convergence, for launches, and
    (the host solution) against a float64 plain evaluation of F, with the
    seconds in F, JVPs and the preconditioner;
  8 transport3d_stream at gx1, uncut, for the JAX bench's gx1 inputs: the
    steady upwind3 year (T = 1, recip_vol factored), timed at 2000 steps
    beside transport3d_year on the same inputs, both held against the plain
    float32 and float64 years at 400 steps (its JSON entry's times); the
    stencil year in float32 and in bfloat16 coefficients, the bench's
    four-module factored family and a 12-month seasonal year, each against
    its plain year at 400 steps and timed at 2000; the coupled
    ABIO_DIC/DIC14 pair against its plain year at 400 steps.  Its timed runs
    are the path whose launches the kernel's JSON entry counts.  Phases 8,
    11 and 13 each print the kernel times PERF.md gives for the design
    before the fused step first, and this run's beside them last; phases
    6, 7, 9, 10 and 12 those before B3's and B4's persistent launches;
    phases 2, 3 and 14 those before B1's and B1v1's table and two barriers
    a step, phase 4 those of B2's before its own;
  9 iage_block in the JAX bench's million-cell blocked year (256 x 2000,
    one module of two tracers, 12,615 steps, blocks of 8 steps, a (1, 1)
    mesh): the full year timed; over its first tenth against the plain f32
    blocked year and the plain f64 per-step year, and timed beside the
    plain f32 tenth (its JSON entry's times); the full year on a (1, 4)
    mesh of the one card (all four shards in the kernel's one launch for
    the year's interior) against the (1, 1) year; the source-free tenth
    from seeded noise (a stand-in for a Krylov direction), the kernel and
    the plain f32 blocked year each within 5e-5 of the f64 per-step year
    (both solve their columns in float64);
 10 the sharded spin-up through cli/sharded_spinup.py's entry function at
    the example's defaults (4 modules, 24 x 48, 2920 steps, float32 on
    iage_block, the fused GMRES) on a (1, 1) mesh and on 4 shards of the
    one card, checked for convergence, for launches (one a year: every
    shard of the card in one launch), against a float64 per-step
    evaluation of F at each solution, and against each other, with the
    host's halo copies a year, the vertical-product preconditioner's
    banded_lu launches (nonzero) and the Newton and Krylov counts (as
    before the preconditioner went through banded_lu); then host-driven
    and fused again on the CLI's kernel (both warm);
 11 transport3d_sweep at gx1, uncut, on phase 8's steady upwind3 inputs:
    the 2000-step year on a 1-shard mesh timed beside transport3d_stream
    (the overhead in percent; the two agree within 1e-6), on 4 shards of
    the card at 1 and 2 steps a sweep (one timed run after a warm-up, each
    within 5e-5 of 1 shard); at
    400 steps on 4 shards, against the same year through the plain sweep
    and against phase 8's plain f32 and f64 years (its JSON entry's
    times), then the stencil f32 and the 12-month seasonal coupled
    ABIO_DIC/DIC14 years on 4 shards against their plain-sweep years.
    Its timed 2000-step years are the path whose launches the kernel's
    JSON entry counts;
 12 the sharded 3D spin-up through cli/irf3d_spinup.py's entry function at
    the example's defaults (10 x 24 x 20, 4 months, the family and the
    coupled pair) with 1, 4 and 2x2 shards on the card (one shard runs
    transport3d_year; more run the per-step sharded year, plain PyTorch
    as in the JAX package; the fused GMRES), checked for convergence,
    against a float64 plain evaluation of F at each solution, and against
    each other; then host-driven on the CLI's kernels;
 13 transport3d_block in the blocked sharded 3D year: (a) the JAX slow
    test's coupled dic/dic14 pair at gx1's horizontal extent (3 x 384 x
    320, 368 steps, blocks of 4) on 1 and 8 shards of the card, timed
    (the 1-shard year and its plain f32 blocked year are its JSON entry's
    times), each within 2e-5 of the plain f64 year, 8 shards within 1e-6
    of 1, land zero, and within 1e-4 of the same year through
    transport3d_sweep, the shards of the card in one cooperative launch a
    block; (b) phase 8's steady upwind3 gx1 year at full depth on 1 shard
    at k = 1 and on 4 shards of the card at k = 2, timed over 2000 steps
    (median of 3 after a warm-up) beside transport3d_stream and
    transport3d_sweep, and held
    at 400 steps against phase 8's plain f32 year within 5e-5.  Its timed
    years are the path whose launches the kernel's JSON entry counts;
 14 iage_year_v1 (B1's PCR variant) at phase 2's size, on its F and JVP
    years, timed beside iage_year, each within 5e-5 of the plain f32 year
    and 1e-4 of the f64 year over the first tenth (the F route's tenth its
    JSON entry's times); the timed full years are its path;
 15 the dense year operator through cli/year_operator_spinup.py at the
    example's defaults (40 x 50, 8760 steps, chunks of 125 columns): the
    probe through iage_year, 250 channels a launch on the kernel's one
    T = 2 table (its bytes and the probe's seconds printed), the direct
    solve and the spectrum; gated on one table launch, the operator's F
    and JVP against iage_year's within 1e-5, F(X*) through iage_year
    within 1e-5 of max|X*|, and one probe launch (the first chunk's 250
    unit columns, 125 channels to each slot) over the first tenth no
    farther from the plain f64 year than the plain f32 year is (a unit
    column decays to a few hundredths of itself, so relative to the
    output's max both lie beyond phase 2's 5e-5 from f64; its distance
    from the plain f32 year printed);
 16 the file-backed test_problem path in float64 on the card, in a fresh
    workdir: (a) ci_short's setup (setup_solver --fp_cnt 1 --depth_nlevs
    20 --persist, iage and phosphorus) with depth_axis.nc and
    gen_init_iterate/'s four files against baselines/ci_short at
    baseline_cmp's defaults; (b) ci_long_iage: its setup, then the
    generated nk_driver.sh (--persist) to convergence, krylov_00/'s files,
    increment_00.nc and iterate_01.nc against baselines/ci_long_iage at
    scripts/ci_long_iage.sh's tolerances and Newton_state.json byte for byte
    after ci_common.sh's workdir rewrite; printed: seconds, step attempts,
    tendency evaluations and LUs a model year, ms an attempt, the Newton
    and Krylov counts, the phase's seconds.  Radau is no TPU kernel: the
    phase adds no JSON entry;
 17 py_driver_2d's file-backed path in float64 on the card, the Radau year
    in banded mode (every stage LU and solve through banded_lu): (a)
    scripts/ci_py_driver_2d_iage.sh's 30 x 30 setup (--fp_cnt 1), its five
    files against baselines/ci_py_driver_2d_iage at the script's
    tolerances; (b) scripts/ci_py_driver_2d_iage_column_regions.sh (20 x 3,
    lateral transport off, a region a column): setup, nk_driver.sh
    (--persist) to convergence, every file the script compares at its
    tolerances, Newton_state.json byte for byte after the workdir rewrite;
    (c) an iage year at input/py_driver_2d/model_params.cfg's 40 x 50, and
    its first 30 days against the dense-mode Radau5 on the card (n = 4000)
    within 1e-7 of max|y|; (d) phosphorus at 30 x 30: 30 days against the
    dense mode (n = 2700), then apply_precond_jacobian (eigen iterations
    and shifted solves through banded_lu) with its null-vector guard
    passing, precond_null_space.nc written and total P conserved within
    1e-10; every Radau year gated on banded_lu launches; printed: seconds,
    attempts, tendency evaluations, LUs and banded_lu launches a year, ms
    an attempt, the 30 x 30 and 40 x 50 years' attempts and LUs beside
    those of the design before one barrier a pivot; then banded_lu
    against its plain twin at the path's shapes (iage 30 x 30 and 40 x 50,
    phosphorus 30 x 30) in float64 and complex128 within 1e-12, with
    factor and solve us beside that design's, the plain twin's ms, the
    dense torch.linalg LU of the same matrices (library_ms), the bound and
    the factor's plan (threads, shared bytes, cluster size, where its
    window lives), and the pair launches (both stage systems in one factor
    launch and one solve launch) against the twins within 1e-12, with
    their us.
Then one JSON line describing each kernel -- its time and its plain
version's over the same work (the first tenth of a 2D year, a 400-step gx1
year, on 4 shards for transport3d_sweep, B4's full gx3 year, the 1-shard
coupled year for transport3d_block, a refactored stage's complex factor
and one solve at 2 x 900 x 61 for banded_lu), with the least time the card could take for
that work (bound_ms, from the H100's published peaks) -- and, last, one
JSON line naming the device.
"""

import argparse
import copy
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from newton_krylov_ooc_tpu_torch.cli import (
    baseline_cmp,
    incore_spinup,
    irf3d_spinup,
    sharded_spinup,
    year_operator_spinup,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic
from newton_krylov_ooc_tpu_torch.config import model_config as port_model_config
from newton_krylov_ooc_tpu_torch.config import share as port_share
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import (
    iage as pd2d_iage,
    model_state as pd2d_state,
    phosphorus,
    physics,
    setup_solver as pd2d_setup,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.models.test_problem import (
    model_state as test_problem_state,
)
from newton_krylov_ooc_tpu_torch.models.test_problem import (
    setup_solver as test_problem_setup,
)
from newton_krylov_ooc_tpu_torch.ops import (
    banded,
    banded_cuda,
    compute,
    imex_block_cuda,
    imex_cuda,
    transport3d_block_cuda,
    transport3d_cuda,
    transport3d_stream_cuda,
    transport3d_sweep_cuda,
)
from newton_krylov_ooc_tpu_torch.ops.radau import Radau5
from newton_krylov_ooc_tpu_torch.ops.transport3d import assemble_rate_fields
from newton_krylov_ooc_tpu_torch.parallel import sharded_year
from newton_krylov_ooc_tpu_torch.parallel.mesh import make_mesh
from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (
    ShardedTransport3dKernel,
    build_sharded_transport3d_year_blocked,
    build_sharded_transport3d_year_stream,
    family_year_inputs,
)
from newton_krylov_ooc_tpu_torch.parallel.sharded_year import (
    ShardedIageKernel,
    ShardedYearData,
    build_sharded_year,
    build_sharded_year_blocked,
    build_sharded_year_blocked_plain,
)

NZ, NY, N_STEPS = 40, 50, 8760
# the 2D kernels run their full year, timed; they are held against their
# plain f32 and f64 years over the first tenth of the year with the same dt
# (tenth()), which keeps the run's plain PyTorch years short: a plain f32
# year takes 47-63 s at 40 x 50 and 47 s at 256 x 2000
CHECK_STEPS = N_STEPS // 10
F32_TOL = 5e-5   # kernel vs f32 plain, relative to max|y|: f32 rounding
F64_TOL = 1e-4   # kernel vs f64 plain: Kahan keeps f32 near f64
SOLVE_TOL = 1e-5
REPS = 5
# the JAX in-core phosphorus test's tolerance (tests/test_imex_incore.py) at
# a fifth of its 730 steps a year: the forward-mode JVPs are plain PyTorch
# on the card, host-bound, and at 730 steps took 228-292 s on one H100,
# most of this script's time; at 365 they took 105-139 s, and on a slower
# host the whole script ran past its 1,200 s
PHOS_STEPS = 146
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
# csrc/iage_year.cu's table kernel per cell, channel and solve: the CN
# coefficients (8) and the Thomas factors m, w, cp (6)
TABLE_CELL_OPS = 14
# each table field vs its plain f32 version, of the field's max: float32
# rounding of the factor recursion in another order (the plain f32 table
# is within 5e-6 of float64 at 40 x 50 x 8760)
TABLE_TOL = 5e-5
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
# the JAX bench's gx1 sections (bench.py:838-983, 1205-1352): POP gx1v7
# extents, at least 2000 steps a year; the plain years that check the
# stencil, family, seasonal and coupled years run 400 steps (stable: the
# synthetic circulation needs 365)
GX1 = (60, 384, 320)
GX1_MIN_STEPS = 2000
GX1_CHECK_STEPS = 400
GX1_REPS = 2  # timed gx1 years after the warm-up (the script's time limit)
BF16_TOL = 5e-4           # B5 in bf16 coefficients vs its own plain year
STENCIL_VS_UPWIND = 5e-4  # the JAX tests' bounds: stencil year vs upwind3
BF16_VS_UPWIND = 2e-2
# the bench's four-module gx1 family (bench.py:1226-1233)
GX1_FAMILY_SPECS = [
    {"name": "t0"},
    {"name": "t1", "sink_rate_per_year": 1.0 / 50.0},
    {"name": "t2", "source_per_year": 1.0e-3, "sink_rate_per_year": 0.02},
    {"name": "t3", "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0},
]
# the JAX bench's sharded million-cell year (bench.py:1404-1444)
BIG = (256, 2000)
BIG_BLOCK_STEPS = 8
BIG_REPS = 3
# the sharded spin-up at the JAX example's defaults, as cli/sharded_spinup.py
# runs them; 4 shards on the one card take blocks of 4 steps (nyl = 12)
SHARDED_MESHES = (("(1, 1)", ["1", "1"]),
                  ("(1, 4) on one card", ["1", "4", "--shards-per-device",
                                          "4", "--block-steps", "4"]))
MESH_TOL = 1e-3  # the two meshes' f32 solutions, relative to max|x|
# phases 3, 7, 10 and 12: the fused solve against the host-driven one.  The
# same Newton count, Krylov counts within one of the host path's at each
# Newton step (in float32 Givens rotations and lstsq may part by an ulp at
# the stop threshold; the exact equality is pinned in float64 on the CPU),
# iterates within FUSED_TOL of max|x|
FUSED_TOL = 1e-4
# phase 15: the year-operator example's defaults (40 x 50, 8760 steps,
# chunks of 125 columns); its gates, relative: the operator's F and JVP
# against B1's, F(X*) through B1 (the JAX test's bound)
YEAR_OP = ("40", "50", "8760", "125")
YEAR_OP_TOL = 1e-5
# phase 16: the ci scripts' setups and comparisons (scripts/ci_short.sh,
# scripts/ci_long_iage.sh), the baseline directory of each, and its files
# with (rtol, atol); None is baseline_cmp's defaults
CI_SETUP = ["--fp_cnt", "1", "--depth_nlevs", "20", "--persist"]
CI_SHORT_FILES = [("depth_axis.nc", None)] + [
    (os.path.join("gen_init_iterate", name), None)
    for name in ("fcn_00.nc", "hist_00.nc", "init_iterate.nc",
                 "init_iterate_00.nc")]
CI_LONG_IAGE_FILES = [
    *[(os.path.join("krylov_00", name), None)
      for name in ("precond_00.nc", "precond_fcn_00.nc", "basis_00.nc",
                   "perturb_fcn_w_raw_00.nc")],
    *[(os.path.join("krylov_00", name), (2.0e-4, baseline_cmp.DEFAULT_ATOL))
      for name in ("w_raw_00.nc", "w_00.nc", "krylov_res_00.nc")],
    *[(name, (2.0e-4, baseline_cmp.DEFAULT_ATOL))
      for name in ("increment_00.nc", "iterate_01.nc")],
]
CI_DRIVER_TIMEOUT_S = 600
RADAU_LINE = re.compile(
    r"radau year: module=(\S+) device=(\S+) attempts=(\d+) nfev=(\d+) "
    r"nlu=(\d+) seconds=([0-9.]+)")
# phase 17: py_driver_2d's file-backed path.  scripts/ci_py_driver_2d_iage.sh
# and scripts/ci_py_driver_2d_iage_column_regions.sh: their overrides of
# input/py_driver_2d's cfgs, and their files with (rtol, atol), None being
# baseline_cmp's defaults
PD2D_INPUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "input",
                          "py_driver_2d")
PD2D_IAGE = {"depth_nlevs": 30, "ypos_nlevs": 30}
PD2D_COLUMNS = {"depth_nlevs": 20, "ypos_nlevs": 3, "max_abs_vvel": 0.0,
                "horiz_mix_coeff": 0.0}
PD2D_SETUP_FILES = [("grid_vars.nc", None)] + [
    (os.path.join("gen_init_iterate", name), (1.0e-3, 1.0e-6))
    for name in ("fcn_0000.nc", "hist_0000.nc", "init_iterate.nc",
                 "init_iterate_0000.nc")]
_RTOL, _ATOL = baseline_cmp.DEFAULT_RTOL, baseline_cmp.DEFAULT_ATOL
PD2D_SOLVE_FILES = [
    (os.path.join("krylov_00", "precond_00.nc"), None),
    (os.path.join("krylov_00", "precond_fcn_00.nc"), (2.0e-3, _ATOL)),
    (os.path.join("krylov_00", "basis_00.nc"), (_RTOL, 5.0e-5)),
    (os.path.join("krylov_00", "perturb_fcn_w_raw_00.nc"), (_RTOL, 5.0e-6)),
    (os.path.join("krylov_00", "krylov_res_00.nc"), (1.9e-2, _ATOL)),
    ("increment_00.nc", (1.9e-2, _ATOL)),
    ("iterate_01.nc", (1.9e-2, _ATOL)),
]
PD2D_RADAU_LINE = re.compile(
    r"radau year: module=(\S+) device=(\S+) attempts=(\d+) nfev=(\d+) "
    r"nlu=(\d+) seconds=([0-9.]+) lu_launches=(\d+)")
PD2D_MONTH = 30 * 86400.0
# the banded year against the dense one on the card over 30 days, relative
# to max|y|: the CPU tests' bound (tests/test_torch_radau.py, JAX's
# tests/test_phosphorus_bands.py)
PD2D_DENSE_TOL = 1e-7
# the preconditioner's solution conserves total P: its grid-weighted total
# against the weighted total of its magnitude
PD2D_CONSERVE_TOL = 1e-10
# phase 10's counts (Newton, Krylov a step) from before its vertical-product
# preconditioner went through the banded kernel (PERF.md), which it keeps
PHASE10_COUNTS = (4, [30, 30, 30, 30])
# the banded kernel's shapes on the path (blocks, rows, half-width): the
# ci 30 x 30 iage stage systems, the 40 x 50 iage year's, phosphorus at 30 x
# 30; the JSON entry's is the first, in complex128 (a refactored stage's
# complex factor and one solve)
BANDED_SHAPES = {"iage 30x30": (2, 900, 30), "iage 40x50": (2, 2000, 40),
                 "phosphorus 30x30": (1, 2700, 90)}
BANDED_TOL = {torch.float64: 1e-12, torch.complex128: 1e-12}
# the factor and solve microseconds of the design before one barrier a
# pivot (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W), by shape and
# dtype, printed beside this run's
BANDED_EARLIER_US = {
    ("iage 30x30", torch.float64): (623.85, 250.26),
    ("iage 30x30", torch.complex128): (679.22, 355.34),
    ("iage 40x50", torch.float64): (1719.32, 536.29),
    ("iage 40x50", torch.complex128): (2100.03, 719.02),
    ("phosphorus 30x30", torch.float64): (6513.69, 1130.47),
    ("phosphorus 30x30", torch.complex128): (8365.87, 1652.27),
}
# the Radau years' attempts and LUs on that design (PERF.md)
PD2D_EARLIER_COUNTS = {"ci 30x30": (1739, 1521), "iage 40x50": (2219, 2031)}
# H100 SXM's peak float64 rate, in its tensor cores (NVIDIA's data sheet;
# 34e12 outside them, where the kernel's arithmetic runs: the bound takes
# the least time the card could take): a complex multiply-add is 8
# operations, a real one 2, a division 1 (real) or 10 (complex, scaled)
PEAK_F64_PER_S = 67e12

# phase 11: B6 on 1 shard repeats B5's arithmetic; 4 shards of the card
SWEEP_VS_B5_TOL = 1e-6
GX1_SHARDS = 4
# phase 12: the 3D spin-up at the JAX example's defaults on three meshes
IRF3D_MESHES = (("1 shard", ["1"]),
                ("4 shards", ["4", "--shards-per-device", "4"]),
                ("2x2 shards", ["2x2", "--shards-per-device", "4"]))
IRF3D_MESH_TOL = 1e-4  # the meshes' f32 solutions, relative to max|x|
# phase 8's plain 400-step gx1 years, which phases 11 and 13 hold B6 and B7
# against
PLAIN_GX1 = {}
# phase 13 (a): the JAX slow test's gx1-extent coupled family
# (tests/test_sharded_transport3d.py:536-617): 3 levels of gx1's 384 x 320,
# land at two columns, the dic/dic14 pair, 368 steps, blocks of 4, on 1
# and 8 shards; its bounds
BLOCK3D_GRID = (3, 384, 320)
BLOCK3D_LAND = ((slice(None), 100, 37), (slice(1, None), 251, 200))
BLOCK3D_STEPS = 368
BLOCK3D_K = 4
BLOCK3D_SHARDS = 8
BLOCK3D_SPECS = [[
    {"name": "dic", "sink_rate_per_year": 0.02,
     "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0,
     "surf_flux_d": {"dic14": 1.5e-4}},
    {"name": "dic14", "source_per_year": 1.0e-3},
]]
BLOCK3D_F64_TOL = 2e-5    # each mesh against the plain f64 year
BLOCK3D_SHARD_TOL = 1e-6  # 8 shards against 1
BLOCK3D_VS_B6 = 1e-4      # against the year through B6 (__graft_entry__.py)
# phase 13 (b): gx1 at full depth, 1 shard at k = 1, 4 shards at k = 2
GX1_BLOCK_MESHES = ((1, 1), (GX1_SHARDS, 2))
# phase 9's source-free tenth from seeded noise against the f64 per-step
# year at 256 levels (ROADMAP C), relative to max|y|
ROUGH_TOL = 5e-5
# the kernels' ms, and the solves' seconds, of the designs before this
# tree's (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# this run's: phases 8, 11 and 13 before the fused step, phases 6, 7, 9, 10
# and 12 before B3's and B4's persistent launches, phase 14 before B1v1's
# table, phase 4 before B2's, phase 2 before B1's channel map and phase 3's
# host solve before the fused solves (ranges over earlier runs where
# PERF.md gives them)
EARLIER_MS = {
    2: {"F_year": "16.89-16.97", "JVP_year": "16.89-16.97",
        "F_tenth": "1.74-1.81"},
    3: {"host solve_seconds": "0.771-0.775"},
    14: {"F_year": 156.85, "JVP_year": 152.04, "F_tenth": 15.47},
    4: {"init_iterate_year": 146.41, "init_iterate_tenth": 15.13},
    6: {"steady_year": 416.28},
    7: {"solve_seconds": "5.94-5.95"},
    8: {"upwind3_year": 1570.17, "upwind3_400_steps": 315.02,
        "stencil_f32_year": 1246.70, "stencil_bf16_year": 991.28,
        "family_T4_year": 6428.90, "seasonal_year": 1867.09},
    9: {"year": 1991.22, "tenth": 208.60, "year_4_shards": 3737.53},
    10: {"(1, 1) solve_seconds": "8.1-13.6",
         "(1, 4) on one card solve_seconds": "38.9-61.5",
         "(1, 1) launches": 47085, "(1, 4) on one card launches": 376680},
    11: {"1shard_year": 1616.95, "4shards_k1_year": 5241.78,
         "4shards_k2_year": 5152.44, "4shards_400_steps": 1039.65},
    12: {f"{mesh} {name} seconds": ("0.93-0.99" if mesh == "1 shard"
                                    else "22.7-25.6")
         for mesh in ("1 shard", "4 shards", "2x2 shards")
         for name in ("family", "abio")},
    13: {"coupled_1shard_year": 142.20, "coupled_8shards_year": 377.96,
         "gx1_1shard_k1_year": 22002.58, "gx1_4shards_k2_year": 25851.77},
}
EARLIER_DESIGN = {8: "the fused step", 11: "the fused step",
                  13: "the fused step", 2: "the channel map",
                  3: "the fused solves", 14: "the table", 4: "the table"}


def phase(num, title, **numbers):
    body = " ".join(f"{key}={val}" for key, val in numbers.items())
    print(f"phase {num} {title}: {body}", flush=True)


def earlier_times(num):
    """phase num's line of the earlier design's times, ahead of this run's"""
    design = EARLIER_DESIGN.get(num, "the persistent launches")
    phase(num, f"times before {design} (PERF.md, NVIDIA H100 80GB HBM3, "
               "700.00 W)", **EARLIER_MS[num])


def against_earlier(num, new):
    """phase num's line of this run's times beside the earlier ones"""
    design = EARLIER_DESIGN.get(num, "the persistent launches")
    phase(num, f"times, this run vs before {design}",
          **{key: f"{new[key]} vs {EARLIER_MS[num][key]}" for key in new})


def timed(fn, *args):
    """(result, milliseconds) of one synchronised call"""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def rel_err(a, b, scale):
    return float((a.double() - b.double()).abs().max()) / scale


def tenth(args):
    """a year builder's arguments (..., t_span, n_steps) cut to the first
    tenth of the year, with the same dt"""
    t_span, n_steps = args[-2:]
    steps = n_steps // 10
    t_end = t_span[0] + (t_span[1] - t_span[0]) * steps / n_steps
    return (*args[:-2], (t_span[0], t_end), steps)


def reset_counts():
    """every kernel's launch count to 0"""
    imex_cuda.iage_year_launches = 0
    imex_cuda.phosphorus_year_launches = 0
    transport3d_cuda.transport3d_year_launches = 0
    transport3d_stream_cuda.transport3d_stream_launches = 0
    imex_block_cuda.iage_block_launches = 0
    transport3d_sweep_cuda.transport3d_sweep_launches = 0
    transport3d_block_cuda.transport3d_block_launches = 0
    imex_cuda.iage_year_v1_launches = 0
    imex_cuda.iage_table_launches = 0
    banded_cuda.set_launch_counts(0, 0)
    sharded_year.halo_copies = 0


def kernel_timing(year, y0):
    """(result, median ms) of REPS synchronised runs after one warm-up"""
    return kernel_timing_reps(year, y0, REPS)


def kernel_timing_reps(year, y0, reps):
    """(result, median ms) of `reps` synchronised runs after one warm-up"""
    timed(year, y0)
    runs = [timed(year, y0) for _ in range(reps)]
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


def table_bound(t_dim, nz, ny, n_steps):
    """bound of one table of n_steps + 1 CN solves: the packed constants
    read once, the table written once"""
    layout = imex_cuda.table_layout(t_dim, nz, ny, n_steps)
    n_bytes = layout["bytes"] + 4 * (grid2d_floats(nz, ny) + t_dim * nz * ny)
    n_ops = layout["solves"] * ((nz - 1) * ny * KV_EDGE_OPS
                                + t_dim * nz * ny * TABLE_CELL_OPS)
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


def tracer_errs(a, b):
    """each tracer's largest difference, of that tracer's max|b|"""
    return [rel_err(a[tr], b[tr], float(b[tr].abs().max()))
            for tr in range(a.shape[0])]


def phosphorus_kernel_phase(depth, ypos, device):
    """phase 4: phosphorus_year against its plain version at full size, the
    year timed, the comparisons over its first tenth; returns (max abs
    error, kernel ms, plain f32 ms) over the initial iterate's tenth"""
    earlier_times(4)
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
    args32 = plain_args[torch.float32]
    tables = [imex_cuda.build_phosphorus_table(args32[0], span, N_STEPS,
                                               device=device)
              for _ in range(2)]
    phase(4, "phosphorus table (B1's table kernel, one channel, zero "
             "diagonal)", year_table_bytes=tables[-1].nbytes,
          year_build_ms=tables[-1].build_ms())
    year_k = imex_cuda.build_phosphorus_year(*args32, device=device,
                                             table=tables[-1])
    rng = np.random.default_rng(0)
    inputs = {
        "init_iterate": probe.init_iterate(),
        "noise": torch.as_tensor(rng.uniform(0.0, 2.0, (3, NZ, NY)),
                                 dtype=torch.float32, device=device),
        "const_0.5": torch.full((3, NZ, NY), 0.5, dtype=torch.float32,
                                device=device),
    }
    short_k = imex_cuda.build_phosphorus_year(*tenth(args32), device=device)
    worst_abs, tenth_ms, year_ms = 0.0, {}, {}
    for label, y0 in inputs.items():
        y_k, ms = kernel_timing(year_k, y0)
        p0 = total_p(depth, ypos, y0)
        # the first tenth against the plain f32 year, both timed; the
        # initial iterate's also against the plain f64 year
        y_s, ms_s = kernel_timing(short_k, y0)
        ref, ms_32 = timed(imex_cuda.build_phosphorus_year_plain(
            *tenth(args32)), y0)
        numbers = {}
        if label == "init_iterate":
            y_64, ms_64 = timed(imex_cuda.build_phosphorus_year_plain(
                *tenth(plain_args[torch.float64])), y0.double())
            numbers = {
                "rel_err_f64_tenth": rel_err(y_s, y_64,
                                             float(y_64.abs().max())),
                "rel_err_f64_tenth_by_tracer": tracer_errs(y_s, y_64),
                "plain_f64_ms_per_tenth": ms_64,
                "p_drift_plain_f64_tenth":
                    abs(total_p(depth, ypos, y_64) - p0) / p0,
            }
        scale = float(ref.abs().max())
        err_32 = rel_err(y_s, ref, scale)
        phase(4, f"phosphorus_year vs plain ({label})",
              rel_err_f32_tenth=err_32,
              rel_err_f32_tenth_by_tracer=tracer_errs(y_s, ref),
              compared_steps=CHECK_STEPS, **numbers, kernel_ms_per_year=ms,
              kernel_ms_tenth=ms_s, plain_f32_ms_tenth=ms_32,
              p_drift_kernel=abs(total_p(depth, ypos, y_k) - p0) / p0,
              max_abs_y=scale)
        if not (torch.isfinite(y_k).all() and err_32 <= F32_TOL
                and numbers.get("rel_err_f64_tenth", 0.0) <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: phosphorus_year disagrees with the plain year "
                f"({label}): {err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{numbers.get('rel_err_f64_tenth')} vs f64 (bound {F64_TOL})"
            )
        worst_abs = max(worst_abs, float((y_s - ref).abs().max()))
        tenth_ms[label] = (ms_s, ms_32)
        year_ms[label] = ms
    against_earlier(4, {"init_iterate_year": year_ms["init_iterate"],
                        "init_iterate_tenth": tenth_ms["init_iterate"][0]})
    # the JSON line's times are the initial iterate's, over the tenth
    return (worst_abs, *tenth_ms["init_iterate"])


def phosphorus_solve_phase(depth, ypos, device):
    """phase 5: the phosphorus spin-up as the JAX package drives it
    (PhosphorusKernel + NewtonKrylovInCore); returns the kernel's launches"""
    reset_counts()
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

    torch.cuda.synchronize()
    start = time.perf_counter()
    x, fcn, info = solver.solve(x0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = imex_cuda.phosphorus_year_launches
    table_launches = imex_cuda.iage_table_launches

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
          kernel_launches=launches, table_launches=table_launches,
          table_build_ms=kernel.table.build_ms(),
          table_bytes=kernel.table.nbytes, min_po4=float(x[0].min()),
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
    if table_launches != 1:
        raise SystemExit(f"chip_smoke: {table_launches} table launches in the "
                         "phosphorus solve, expected one for its F years")
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
    earlier_times(6)
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
              grid_syncs_per_year=transport3d_cuda.grid_syncs_per_year(
                  n_steps),
              tile=f"{year_k.plan.ty}x{year_k.plan.tx}",
              resident=year_k.plan.resident, blocks=year_k.plan.grid,
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
    against_earlier(6, {"steady_year": timing[0]})
    return (worst_abs, *timing)


def transport3d_solve_phase(device):
    """phase 7: the gx3 spin-up as the JAX bench drives it
    (ShardedTransport3dKernel + NewtonKrylovInCore), host-driven and with
    the fused GMRES; returns the host solve's kernel launches"""
    circ = synthetic.gen_circulation(*GX3)
    n_steps = max(GX3_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    kernel = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                      dtype=torch.float32)
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: ShardedTransport3dKernel did not "
                         "dispatch to the kernel")
    spent = {name: [0.0, 0] for name in ("f", "jvp", "pc")}
    kernel.comp_fcn = timed_hook(kernel.comp_fcn, spent["f"])
    kernel.jvp = timed_hook(kernel.jvp, spent["jvp"])
    kernel.precond_setup = timed_hook(kernel.precond_setup, spent["pc"])
    kernel.precond_apply = timed_hook(kernel.precond_apply, spent["pc"])
    check = ShardedTransport3dKernel(circ, GX3_SPECS, n_steps, device=device,
                                     dtype=torch.float64)

    earlier_times(7)
    solves, host_launches = {}, 0
    for route, jit_gmres in (("host", False), ("jit_gmres", True)):
        for times in spent.values():
            times[:] = [0.0, 0]
        reset_counts()
        x, fcn, info = solve_timed(kernel, jit_gmres=jit_gmres, **GX3_SOLVER)
        launches = transport3d_cuda.transport3d_year_launches
        rel = info["fcn_norm"] / info["x_norm"]
        # F at the host solution by the float64 year (the fused one is
        # held to the host one)
        rel64 = 0.0
        if route == "host":
            x64 = x.double()
            rel64 = (check.norm(check.comp_fcn(x64))
                     / check.norm(x64)).max().item()
        phase(7, f"gx3 solve ({n_steps} steps, {route})",
              newton_iterations=info["iterations"],
              krylov_iterations=[int(k) for k in info["krylov_iterations"]],
              seconds=info["seconds"], f_seconds=spent["f"][0],
              f_evals=spent["f"][1], jvp_seconds=spent["jvp"][0],
              jvp_evals=spent["jvp"][1], precond_seconds=spent["pc"][0],
              precond_calls=spent["pc"][1], max_rel_resid=float(rel.max()),
              f64_plain_rel_resid=rel64, kernel_launches=launches)
        if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
            raise SystemExit(f"chip_smoke: non-finite values in the gx3 "
                             f"solution ({route})")
        if not (rel < GX3_SOLVER["newton_rel_tol"]).all():
            raise SystemExit(f"chip_smoke: gx3 residual {rel.max():.3e} >= "
                             f"{GX3_SOLVER['newton_rel_tol']} ({route})")
        if launches < spent["f"][1] + spent["jvp"][1]:
            raise SystemExit(
                f"chip_smoke: {launches} transport3d_year launches for "
                f"{spent['f'][1]} F evaluations and {spent['jvp'][1]} JVPs "
                f"({route})")
        if not rel64 < 1e-4:
            raise SystemExit(f"chip_smoke: f64 gx3 residual at the solution "
                             f"{rel64:.3e} ({route})")
        solves[route] = (x, info)
        if route == "host":
            host_launches = launches
    compare_solves(7, "gx3", solves["host"], solves["jit_gmres"])
    against_earlier(7, {"solve_seconds": solves["host"][1]["seconds"]})
    return host_launches


def stream_bound(year, t_dim, n_cells, n_steps):
    """bound of one stream year: every operand the kernel reads (all months
    of a seasonal one) and y0 read once, the year's end written once; the
    year's operations counted once per cell (est_flops_per_step) and the
    extra CN half step"""
    n_bytes = sum(arr.numel() * arr.element_size()
                  for arr in year.operands.values() if arr is not None)
    n_bytes += 2 * 4 * t_dim * n_cells
    n_ops = year.est_flops_per_step * n_steps + t_dim * n_cells * CN_CELL_OPS
    return bound(n_bytes, n_ops)


def stream_path_run(year, y0, reps):
    """(result, median ms, launches) of `reps` synchronised runs after one
    warm-up: the stream kernel's path, its launch count reset just before
    and read just after"""
    reset_counts()
    timed(year, y0)
    runs = [timed(year, y0) for _ in range(reps)]
    launches = transport3d_stream_cuda.transport3d_stream_launches
    if launches != reps + 1:
        raise SystemExit(f"chip_smoke: {launches} transport3d_stream launches "
                         f"for {reps + 1} years")
    return runs[-1][0], statistics.median(run[1] for run in runs), launches


def stream_check(label, y_k, y_ref, scale, tol, wet, **numbers):
    """phase 8's line for one case; raises unless y_k is finite, within
    tol * scale of y_ref, and exactly zero on land; returns max|y_k - y_ref|"""
    err = rel_err(y_k, y_ref, scale)
    phase(8, label, rel_err=err, tol=tol, **numbers, max_abs_y=scale)
    if not (torch.isfinite(y_k).all() and err <= tol):
        raise SystemExit(f"chip_smoke: transport3d_stream disagrees ({label}): "
                         f"{err:.3e} (bound {tol})")
    if float((y_k * (1.0 - wet)).abs().max()) != 0.0:
        raise SystemExit(f"chip_smoke: transport3d_stream wets land ({label})")
    return float((y_k - y_ref).abs().max())


def stream_kernel_phase(device):
    """phase 8: transport3d_stream against its plain years at gx1, uncut;
    returns (launches on its path, max abs error, steady kernel ms, plain
    f32 ms, bound ms, bounded by), the times over the 400-step year"""
    f32, f64 = torch.float32, torch.float64
    stream = transport3d_stream_cuda
    nz, nlat, nlon = GX1
    n_cells = nz * nlat * nlon
    span = (0.0, transport3d_cuda.SEC_PER_YEAR)
    rng = np.random.default_rng(0)
    noise = rng.uniform(0.0, 1.0, (1,) + GX1)
    launches, worst_abs = 0, 0.0
    earlier_times(8)
    new_ms = {}

    # -- the steady upwind3 year, T = 1, recip_vol factored (bench.py:859-866)
    circ = synthetic.gen_circulation(*GX1)
    n_steps = max(GX1_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    wet = torch.as_tensor(circ["mask"] > 0, dtype=f32, device=device)
    y0 = wet * torch.as_tensor(noise, dtype=f32, device=device)
    factors = {"recip_area": 1.0 / circ["TAREA"], "recip_dz": 1.0 / circ["dz"]}
    shed = dict(factors, t_dim=1)
    year = stream.build_transport3d_year_stream(
        coef, kv, dz_r, None, None, span, n_steps, **shed, device=device)
    y_up, ms, count = stream_path_run(year, y0, REPS)
    launches += count
    if not (torch.isfinite(y_up).all()
            and float((y_up * (1.0 - wet)).abs().max()) == 0.0):
        raise SystemExit("chip_smoke: the upwind3 year is not finite or wets "
                         "land")
    zeros = np.zeros((1, nz, nlat * nlon))
    year_b4 = transport3d_cuda.build_transport3d_year(
        coef, kv, dz_r, zeros, zeros, span, n_steps, device=device)
    y_b4, ms_b4 = kernel_timing_reps(year_b4, y0, GX1_REPS)
    b4_vs_b5 = rel_err(y_b4, y_up, float(y_up.abs().max()))
    # B5 and B4 against the plain f32 and f64 years at 400 steps, as the
    # other cases below (plain years of 2000 steps take 27 s and 43 s)
    year_c = stream.build_transport3d_year_stream(
        coef, kv, dz_r, None, None, span, GX1_CHECK_STEPS, **shed,
        device=device)
    y_c, ms_c = kernel_timing_reps(year_c, y0, GX1_REPS)
    plain = {dtype: stream.build_transport3d_year_stream_plain(
        _to(coef, device, dtype), kv, dz_r, None, None, span, GX1_CHECK_STEPS,
        t_dim=1) for dtype in (f32, f64)}
    y_32, ms_32 = timed(plain[f32], y0)
    y_64, ms_64 = timed(plain[f64], y0.double())
    scale = float(y_64.abs().max())
    b4_err = rel_err(transport3d_cuda.build_transport3d_year(
        coef, kv, dz_r, zeros, zeros, span, GX1_CHECK_STEPS, device=device)(y0),
        y_32, scale)
    if not (b4_err <= F32_TOL and b4_vs_b5 <= F32_TOL):
        raise SystemExit(f"chip_smoke: transport3d_year at gx1 disagrees with "
                         f"the plain year ({b4_err:.3e}) or with B5 "
                         f"({b4_vs_b5:.3e})")
    bound_ms, bound_by = stream_bound(year, 1, n_cells, n_steps)
    bound_c, bound_c_by = stream_bound(year_c, 1, n_cells, GX1_CHECK_STEPS)
    steps = f"{nz}x{nlat}x{nlon}, {n_steps} steps"
    worst_abs = max(worst_abs, stream_check(
        f"transport3d_stream vs plain f32 (steady upwind3, {steps}, T=1; "
        f"compared at {GX1_CHECK_STEPS} steps)",
        y_c, y_32, scale, F32_TOL, wet, rel_err_f64=rel_err(y_c, y_64, scale),
        kernel_ms_per_year=ms, kernel_ms_per_step=ms / n_steps,
        kernel_ms_400_steps=ms_c, plain_f32_ms_400_steps=ms_32,
        plain_f64_ms_400_steps=ms_64,
        b4_ms_per_year=ms_b4, b4_ms_per_step=ms_b4 / n_steps,
        b4_rel_err_f32=b4_err, b4_rel_err_vs_b5=b4_vs_b5,
        cuda_launches_per_year=stream.cuda_launches_per_year(n_steps),
        b4_cuda_launches_per_year=transport3d_cuda.cuda_launches_per_year(
            n_steps),
        hbm_bytes_per_step=year.hbm_bytes_per_step,
        est_flops_per_step=year.est_flops_per_step, bound_ms=bound_ms,
        bound_by=bound_by, bound_ms_400_steps=bound_c))
    if not rel_err(y_c, y_64, scale) <= F64_TOL:
        raise SystemExit("chip_smoke: transport3d_stream disagrees with the "
                         "plain f64 year")
    # the JSON line's times are of the same work, the 400-step year
    timing = (ms_c, ms_32, bound_c, bound_c_by)
    new_ms.update(upwind3_year=ms, upwind3_400_steps=ms_c)
    PLAIN_GX1.update(f32=y_32, f64=y_64)
    del plain, year_b4, year_c

    # -- the stencil years (bench.py:945-980), the four-module family
    # (bench.py:1226-1236) and the coupled pair: 400 steps against the plain
    # year, then timed at n_steps
    def rates(specs):
        return assemble_rate_fields(specs, (circ["mask"] > 0).reshape(nz, -1),
                                    float(circ["dz"][0]),
                                    transport3d_cuda.SEC_PER_YEAR)

    fam_diag, fam_src, _ = rates(GX1_FAMILY_SPECS)
    abio_diag, abio_src, abio_couple = rates(irf3d_spinup.ABIO_SPECS[0])
    cases = (
        ("stencil f32", 1, None, None, None,
         dict(shed, stencil=True), F32_TOL, STENCIL_VS_UPWIND),
        ("stencil bf16", 1, None, None, None,
         dict(shed, stencil=True, coef_bf16=True), BF16_TOL, BF16_VS_UPWIND),
        ("family T=4", 4, fam_diag, fam_src, None, factors, F32_TOL, F32_TOL),
        ("coupled ABIO pair", 2, abio_diag, abio_src, abio_couple, factors,
         F32_TOL, None),
    )
    earlier_key = {"stencil f32": "stencil_f32_year",
               "stencil bf16": "stencil_bf16_year",
               "family T=4": "family_T4_year"}
    for label, t_dim, diag, src, couple, kwargs, tol, up_tol in cases:
        y0_t = y0.expand((t_dim,) + GX1).contiguous()
        args = (kv, dz_r, diag, src, span)
        year_c = stream.build_transport3d_year_stream(
            coef, *args, GX1_CHECK_STEPS, couple, **kwargs, device=device)
        y_c, ms_c = timed(year_c, y0_t)
        plain_c = stream.build_transport3d_year_stream_plain(
            _to(coef, device, f64), *args, GX1_CHECK_STEPS, couple, **kwargs,
            dtype=f32)
        y_p, ms_p = timed(plain_c, y0_t)
        numbers = {"kernel_ms_400_steps": ms_c, "plain_f32_ms_400_steps": ms_p}
        if up_tol is not None:
            year_t = stream.build_transport3d_year_stream(
                coef, *args, n_steps, couple, **kwargs, device=device)
            y_t, ms_t, count = stream_path_run(year_t, y0_t, GX1_REPS)
            launches += count
            # the rate-free module (or the one tracer) against upwind3
            up_err = rel_err(y_t[0], y_up[0], float(y_up.abs().max()))
            if not up_err <= up_tol:
                raise SystemExit(f"chip_smoke: {label} at {n_steps} steps is "
                                 f"{up_err:.3e} from upwind3 (bound {up_tol})")
            new_ms[earlier_key[label]] = ms_t
            numbers.update(
                kernel_ms_per_year=ms_t, kernel_ms_per_step=ms_t / n_steps,
                ms_per_step_per_module=ms_t / n_steps / t_dim,
                rel_err_vs_upwind3=up_err, upwind3_tol=up_tol,
                hbm_bytes_per_step=year_t.hbm_bytes_per_step,
                est_flops_per_step=year_t.est_flops_per_step,
                bound_ms=stream_bound(year_t, t_dim, n_cells, n_steps)[0])
            del year_t, y_t
        worst_abs = max(worst_abs, stream_check(
            f"transport3d_stream vs plain f32 ({label}, {nz}x{nlat}x{nlon}, "
            f"{GX1_CHECK_STEPS} steps, T={t_dim})",
            y_c, y_p, float(y_p.abs().max()), tol, wet, **numbers))
        del year_c, plain_c, y_c, y_p

    # -- the 12-month seasonal year (bench.py:1305-1331), under its own mask
    circ_s = synthetic.gen_circulation(*GX1, n_seasons=12)
    coef_s, kv_s, dz_r_s, _, _, _ = family_year_inputs(circ_s, [[{"name": "T"}]])
    wet_s = torch.as_tensor(circ_s["mask"] > 0, dtype=f32, device=device)
    y0_s = wet_s * torch.as_tensor(noise, dtype=f32, device=device)
    shed_s = {"recip_area": 1.0 / circ_s["TAREA"],
              "recip_dz": 1.0 / circ_s["dz"], "t_dim": 1}
    n_steps_s = max(GX1_MIN_STEPS, synthetic.stable_steps_per_year(circ_s))
    args = (kv_s, dz_r_s, None, None, span)
    year_c = stream.build_transport3d_year_stream(
        coef_s, *args, GX1_CHECK_STEPS, **shed_s, device=device)
    y_c, ms_c = timed(year_c, y0_s)
    y_p, ms_p = timed(stream.build_transport3d_year_stream_plain(
        _to(coef_s, device, f32), *args, GX1_CHECK_STEPS, **shed_s), y0_s)
    year_t = stream.build_transport3d_year_stream(
        coef_s, *args, n_steps_s, **shed_s, device=device)
    _, ms_t, count = stream_path_run(year_t, y0_s, GX1_REPS)
    launches += count
    worst_abs = max(worst_abs, stream_check(
        f"transport3d_stream vs plain f32 (seasonal 12 months, {nz}x{nlat}x"
        f"{nlon}, {GX1_CHECK_STEPS} steps, T=1)",
        y_c, y_p, float(y_p.abs().max()), F32_TOL, wet_s,
        kernel_ms_400_steps=ms_c, plain_f32_ms_400_steps=ms_p,
        kernel_ms_per_year=ms_t, kernel_ms_per_step=ms_t / n_steps_s,
        hbm_bytes_per_step=year_t.hbm_bytes_per_step,
        est_flops_per_step=year_t.est_flops_per_step,
        bound_ms=stream_bound(year_t, 1, n_cells, n_steps_s)[0]))
    new_ms["seasonal_year"] = ms_t
    against_earlier(8, new_ms)
    phase(8, "transport3d_stream path", launches=launches)
    return (launches, worst_abs, *timing)


def plain_gx1(coef, kv, dz_r, y0):
    """phase 8's plain f32 and f64 400-step gx1 years, computed here only
    when phase 8 did not run"""
    if not PLAIN_GX1:
        for key, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            year = transport3d_stream_cuda.build_transport3d_year_stream_plain(
                _to(coef, y0.device, dtype), kv, dz_r, None, None,
                (0.0, transport3d_cuda.SEC_PER_YEAR), GX1_CHECK_STEPS,
                t_dim=1)
            PLAIN_GX1[key] = year(y0.to(dtype))
    return PLAIN_GX1["f32"], PLAIN_GX1["f64"]


def sweep_kernel_phase(device):
    """phase 11: transport3d_sweep at gx1 on phase 8's steady upwind3
    inputs; returns (launches on its path, max abs error, 4-shard kernel
    ms, plain-sweep ms, bound ms, bounded by), the times over the 400-step
    year"""
    f32, f64 = torch.float32, torch.float64
    stream = transport3d_stream_cuda
    nz, nlat, nlon = GX1
    n_cells = nz * nlat * nlon
    span = (0.0, transport3d_cuda.SEC_PER_YEAR)
    noise = np.random.default_rng(0).uniform(0.0, 1.0, (1,) + GX1)
    circ = synthetic.gen_circulation(*GX1)
    n_steps = max(GX1_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    wet = torch.as_tensor(circ["mask"] > 0, dtype=f32, device=device)
    y0 = wet * torch.as_tensor(noise, dtype=f32, device=device)
    shed = {"recip_area": 1.0 / circ["TAREA"], "recip_dz": 1.0 / circ["dz"],
            "t_dim": 1}
    args = (coef, kv, dz_r, None, None, span)
    one = make_mesh(1, 1, devices=[device])
    four = make_mesh(1, GX1_SHARDS, devices=[device] * GX1_SHARDS)

    def sharded(mesh, steps, k=1, **kwargs):
        return build_sharded_transport3d_year_stream(
            mesh, *args, steps, steps_per_sweep=k, **dict(shed, **kwargs))

    earlier_times(11)

    # -- the path: the 2000-step year on one shard in turns with B5, then on
    # four shards of the card at 1 and 2 steps a sweep
    year5 = stream.build_transport3d_year_stream(*args, n_steps, **shed,
                                                 device=device)
    year1 = sharded(one, n_steps)
    year4 = {k: sharded(four, n_steps, k) for k in (1, 2)}
    reset_counts()
    timed(year5, y0)
    timed(year1, y0)
    ms5, ms1 = [], []
    for _ in range(GX1_REPS):
        y_5, ms = timed(year5, y0)
        ms5.append(ms)
        y_1, ms = timed(year1, y0)
        ms1.append(ms)
    ms4, err4 = {}, {}
    scale = float(y_5.abs().max())
    for k, year in year4.items():
        timed(year, y0)
        y_4, ms4[k] = timed(year, y0)
        err4[k] = rel_err(y_4, y_1, scale)
    launches = transport3d_sweep_cuda.transport3d_sweep_launches
    expected = ((1 + GX1_REPS) * year1.n_sweeps + 2 * GX1_SHARDS
                * sum(year.n_sweeps for year in year4.values()))
    ms5, ms1 = statistics.median(ms5), statistics.median(ms1)
    err1 = rel_err(y_1, y_5, scale)
    tile_y, tile_x = transport3d_sweep_cuda.step_tile()
    bound_y, bound_y_by = stream_bound(year5, 1, n_cells, n_steps)
    phase(11, f"transport3d_sweep path ({nz}x{nlat}x{nlon}, {n_steps} steps, "
              f"T=1, upwind3, recip_vol factored)",
          b6_1shard_ms_per_year=ms1, b5_ms_per_year=ms5,
          irf3d_gx1_stream_sharded1_overhead_pct=100.0 * (ms1 / ms5 - 1.0),
          rel_err_1shard_vs_b5=err1, bit_identical=bool(torch.equal(y_1, y_5)),
          b6_4shards_k1_ms_per_year=ms4[1], b6_4shards_k2_ms_per_year=ms4[2],
          rel_err_4shards_k1=err4[1], rel_err_4shards_k2=err4[2],
          halo_rows={k: year.halo for k, year in year4.items()},
          sweeps_per_year={k: year.n_sweeps for k, year in year4.items()},
          halo_copies_per_year={k: year.halo_copies
                                for k, year in year4.items()},
          halo_mbytes_per_year={k: year.halo_bytes / 1e6
                                for k, year in year4.items()},
          step_blocks_per_shard={1: -(-(nlat + 2 * year1.halo) // tile_y)
                                 * -(-nlon // tile_x),
                                 4: -(-(nlat // GX1_SHARDS + 2
                                        * year4[1].halo) // tile_y)
                                 * -(-nlon // tile_x)},
          bound_ms_per_year=bound_y, bound_by=bound_y_by, launches=launches)
    if launches != expected:
        raise SystemExit(f"chip_smoke: {launches} transport3d_sweep launches "
                         f"for {expected} shard sweeps")
    if not (torch.isfinite(y_1).all() and err1 <= SWEEP_VS_B5_TOL
            and max(err4.values()) <= F32_TOL):
        raise SystemExit(f"chip_smoke: transport3d_sweep disagrees: 1 shard "
                         f"{err1:.3e} from B5 (bound {SWEEP_VS_B5_TOL}), 4 "
                         f"shards {err4} from 1 (bound {F32_TOL})")
    del year5, year1, year4, y_5, y_4

    # -- 400 steps on four shards against the plain sweeps and phase 8's
    # plain f32 and f64 years
    plain_gx1(coef, kv, dz_r, y0)
    year_c = sharded(four, GX1_CHECK_STEPS)
    y_c, ms_c = kernel_timing_reps(year_c, y0, GX1_REPS)
    y_p, ms_p = timed(sharded(four, GX1_CHECK_STEPS, plain=True), y0)
    y_32, y_64 = PLAIN_GX1["f32"], PLAIN_GX1["f64"]
    scale = float(y_64.abs().max())
    errs = {"plain_sweep": rel_err(y_c, y_p, float(y_p.abs().max())),
            "plain_f32": rel_err(y_c, y_32, scale),
            "plain_f64": rel_err(y_c, y_64, scale)}
    bound_c, bound_c_by = stream_bound(stream.build_transport3d_year_stream(
        *args, GX1_CHECK_STEPS, **shed, device=device), 1, n_cells,
        GX1_CHECK_STEPS)
    worst_abs = float((y_c - y_p).abs().max())
    phase(11, f"transport3d_sweep vs plain ({GX1_SHARDS} shards, "
              f"{GX1_CHECK_STEPS} steps, upwind3)",
          rel_err_plain_sweep=errs["plain_sweep"],
          rel_err_plain_f32=errs["plain_f32"],
          rel_err_plain_f64=errs["plain_f64"], kernel_ms_400_steps=ms_c,
          plain_sweep_ms_400_steps=ms_p, bound_ms_400_steps=bound_c,
          max_abs_y=scale)
    if not (torch.isfinite(y_c).all() and errs["plain_sweep"] <= F32_TOL
            and errs["plain_f32"] <= F32_TOL and errs["plain_f64"] <= F64_TOL):
        raise SystemExit(f"chip_smoke: transport3d_sweep at 400 steps "
                         f"disagrees: {errs}")
    if float((y_c * (1.0 - wet)).abs().max()) != 0.0:
        raise SystemExit("chip_smoke: transport3d_sweep wets land")
    timing = (ms_c, ms_p, bound_c, bound_c_by)
    against_earlier(11, {"1shard_year": ms1, "4shards_k1_year": ms4[1],
                     "4shards_k2_year": ms4[2], "4shards_400_steps": ms_c})
    del year_c, y_c, y_p, y_32, y_64

    # -- the stencil f32 year, and the 12-month seasonal coupled pair, on
    # four shards at 400 steps against their plain-sweep years
    circ_s = synthetic.gen_circulation(*GX1, n_seasons=12)
    wet_s = torch.as_tensor(circ_s["mask"] > 0, dtype=f32, device=device)
    abio = family_year_inputs(circ_s, irf3d_spinup.ABIO_SPECS)
    coef_s, kv_s, dz_r_s, diag_s, src_s, couple_s = abio
    cases = (
        ("stencil f32", wet, y0, (coef, kv, dz_r, None, None),
         dict(shed, stencil=True)),
        ("seasonal 12 months, coupled ABIO pair", wet_s,
         (wet_s * torch.as_tensor(noise, dtype=f32, device=device))
         .expand((2,) + GX1).contiguous(),
         (coef_s, kv_s, dz_r_s, diag_s, src_s),
         {"couple": couple_s, "recip_area": 1.0 / circ_s["TAREA"],
          "recip_dz": 1.0 / circ_s["dz"]}),
    )
    for label, wet_c, y0_c, inputs, kwargs in cases:
        def build(**extra):
            return build_sharded_transport3d_year_stream(
                four, *inputs, span, GX1_CHECK_STEPS, **kwargs, **extra)

        y_k, ms_k = timed(build(), y0_c)
        y_p, ms_p = timed(build(plain=True), y0_c)
        err = rel_err(y_k, y_p, float(y_p.abs().max()))
        phase(11, f"transport3d_sweep vs plain ({label}, {GX1_SHARDS} "
                  f"shards, {GX1_CHECK_STEPS} steps, T={y0_c.shape[0]})",
              rel_err=err, tol=F32_TOL, kernel_ms_400_steps=ms_k,
              plain_sweep_ms_400_steps=ms_p, max_abs_y=float(y_p.abs().max()))
        if not (torch.isfinite(y_k).all() and err <= F32_TOL):
            raise SystemExit(f"chip_smoke: transport3d_sweep disagrees "
                             f"({label}): {err:.3e} (bound {F32_TOL})")
        if float((y_k * (1.0 - wet_c)).abs().max()) != 0.0:
            raise SystemExit(f"chip_smoke: transport3d_sweep wets land "
                             f"({label})")
        worst_abs = max(worst_abs, float((y_k - y_p).abs().max()))
        del y_k, y_p
    return (launches, worst_abs, *timing)


def irf3d_sharded_solve_phase(device):
    """phase 12: the 3D spin-up through cli/irf3d_spinup.py (the fused
    GMRES) on three meshes of the one card, then host-driven on the CLI's
    kernels; returns transport3d_year's launches (the 1-shard solves)"""
    defaults = irf3d_spinup.parse_args([])
    grid = [str(defaults.nz), str(defaults.nlat), str(defaults.nlon)]
    circ = synthetic.gen_circulation(defaults.nz, defaults.nlat, defaults.nlon,
                                     n_seasons=defaults.months or None)
    tol = irf3d_spinup.SOLVER["newton_rel_tol"]
    checks, solutions, launches, new = {}, {}, 0, {}
    earlier_times(12)
    for label, shard_args in IRF3D_MESHES:
        reset_counts()
        results = irf3d_spinup.main(
            grid + [shard_args[0], str(defaults.months), "--device", "cuda",
                    *shard_args[1:]])
        torch.cuda.synchronize()
        count = transport3d_cuda.transport3d_year_launches
        launches += count
        for (kernel, x, fcn, info), (name, specs) in zip(
                results, (("family", irf3d_spinup.FAMILY_SPECS),
                          ("abio", irf3d_spinup.ABIO_SPECS))):
            rel = info["fcn_norm"] / info["x_norm"]
            if name not in checks:
                checks[name] = ShardedTransport3dKernel(
                    circ, specs, kernel.n_steps, device=device,
                    dtype=torch.float64)
            check = checks[name]
            x64 = x.double()
            rel64 = (check.norm(check.comp_fcn(x64))
                     / check.norm(x64)).max().item()
            solutions.setdefault(name, {})[label] = x
            new[f"{label} {name} seconds"] = info["seconds"]
            phase(12, f"irf3d spin-up {label} ({name})",
                  newton_iterations=info["iterations"],
                  krylov_iterations=[int(k) for k in info["krylov_iterations"]],
                  seconds=info["seconds"], max_rel_resid=float(rel.max()),
                  f64_plain_rel_resid=rel64, transport3d_year_launches=count,
                  on_kernel=kernel.use_kernel)
            if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
                raise SystemExit(f"chip_smoke: non-finite values in the 3D "
                                 f"solution ({label}, {name})")
            if not ((rel < tol).all() and rel64 < 1e-4):
                raise SystemExit(
                    f"chip_smoke: 3D residual {float(rel.max()):.3e} (bound "
                    f"{tol}), f64 {rel64:.3e} (bound 1e-4) ({label}, {name})")
            # the host-driven GMRES on the same kernel
            x_h, _, info_h = solve_timed(kernel, **irf3d_spinup.SOLVER)
            rel_h = info_h["fcn_norm"] / info_h["x_norm"]
            phase(12, f"irf3d spin-up {label} ({name}, host GMRES)",
                  newton_iterations=info_h["iterations"],
                  krylov_iterations=[int(k) for k in
                                     info_h["krylov_iterations"]],
                  seconds=info_h["seconds"], max_rel_resid=float(rel_h.max()))
            if not (rel_h < tol).all():
                raise SystemExit(f"chip_smoke: host-GMRES 3D residual "
                                 f"{float(rel_h.max()):.3e} ({label}, {name})")
            compare_solves(12, f"irf3d {label} ({name})", (x_h, info_h),
                           (x, info))
        if (count > 0) != (label == IRF3D_MESHES[0][0]):
            raise SystemExit(f"chip_smoke: {count} transport3d_year launches "
                             f"in the {label} solves")
    diffs = {}
    for name, by_mesh in solutions.items():
        ref = by_mesh[IRF3D_MESHES[0][0]]
        for label, x in by_mesh.items():
            diffs[f"{name} {label}"] = rel_err(x, ref, float(ref.abs().max()))
    phase(12, "irf3d spin-up meshes", rel_diff=diffs, tol=IRF3D_MESH_TOL)
    against_earlier(12, new)
    if not max(diffs.values()) <= IRF3D_MESH_TOL:
        raise SystemExit(f"chip_smoke: the 3D meshes' solutions differ: "
                         f"{diffs} (bound {IRF3D_MESH_TOL})")
    return launches


def table_phase(grid32, diag, span, device):
    """phase 2's table kernel: the tenth's table against its plain f32
    version, both timed, and the full year's build; returns (max abs error,
    kernel ms, plain f32 ms) over the tenth"""
    nz, ny = NZ, NY
    short_span, short_steps = tenth((span, N_STEPS))
    builds = [imex_cuda.build_iage_table(grid32, diag, short_span,
                                         short_steps, device=device)
              for _ in range(REPS + 1)]
    ms = statistics.median(table.build_ms() for table in builds[1:])
    times, h = imex_cuda.solve_times(short_span, short_steps)
    plain, plain_ms = timed(imex_cuda.iage_table_plain, grid32, diag, times, h)
    ours = imex_cuda.unpack_table(builds[-1].tensor, 2, nz, ny, short_steps)
    errs = {name: rel_err(a, b, float(b.abs().max()))
            for name, a, b in zip(("kv", "m", "w", "cp"), ours, plain)}
    worst_abs = max(float((a - b).abs().max()) for a, b in zip(ours, plain))
    year = [imex_cuda.build_iage_table(grid32, diag, span, N_STEPS,
                                       device=device) for _ in range(2)]
    phase(2, "iage_table vs plain", rel_err_tenth=errs, tol=TABLE_TOL,
          kernel_ms_tenth=ms, plain_f32_ms_tenth=plain_ms,
          year_build_ms=year[-1].build_ms(), year_table_bytes=year[-1].nbytes)
    if not max(errs.values()) <= TABLE_TOL:
        raise SystemExit(f"chip_smoke: the table disagrees with its plain "
                         f"version: {errs} (bound {TABLE_TOL})")
    return worst_abs, ms, plain_ms


def iage_kernel_phase(depth, ypos, device):
    """phase 2: iage_year against its plain version at full size, the year
    timed, the comparisons over its first tenth, and the table kernel;
    returns ((max abs error, kernel ms, plain f32 ms) over the F route's
    tenth, the same of the table)"""
    earlier_times(2)
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
    worst_abs, tenth_ms, year_ms = 0.0, {}, {}
    for route, (source, y0_np) in inputs.items():
        args = {dtype: (grids[dtype], diag, source, span, N_STEPS)
                for dtype in (torch.float32, torch.float64)}
        year_k = imex_cuda.build_iage_year(*args[torch.float32], device=device)
        y0 = torch.as_tensor(y0_np, dtype=torch.float32, device=device)
        _, ms = kernel_timing(year_k, y0)
        # the first tenth against the plain f32 and f64 years, all timed
        y_s, ms_s = kernel_timing(imex_cuda.build_iage_year(
            *tenth(args[torch.float32]), device=device), y0)
        ref, ms_32 = timed(imex_cuda.build_iage_year_plain(
            *tenth(args[torch.float32])), y0)
        y_64, _ = timed(imex_cuda.build_iage_year_plain(
            *tenth(args[torch.float64])), y0.double())
        err_64 = rel_err(y_s, y_64, float(y_64.abs().max()))
        scale = float(ref.abs().max())
        err_32 = rel_err(y_s, ref, scale)
        phase(2, f"kernel vs plain ({route})", rel_err_f32_tenth=err_32,
              rel_err_f64_tenth=err_64, compared_steps=CHECK_STEPS,
              kernel_ms_per_year=ms, kernel_ms_tenth=ms_s,
              plain_f32_ms_tenth=ms_32, max_abs_y=scale)
        if not (err_32 <= F32_TOL and err_64 <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: kernel disagrees with the plain year ({route}): "
                f"{err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{err_64:.3e} vs f64 (bound {F64_TOL})"
            )
        worst_abs = max(worst_abs, float((y_s - ref).abs().max()))
        tenth_ms[route] = (ms_s, ms_32)
        year_ms[route] = ms
    table = table_phase(grids[torch.float32], diag, span, device)
    against_earlier(2, {"F_year": year_ms["F"], "JVP_year": year_ms["JVP"],
                        "F_tenth": tenth_ms["F"][0]})
    # the JSON line's times are the F route's, over the tenth
    return (worst_abs, *tenth_ms["F"]), table


def solve_timed(kernel, **settings):
    """(x, fcn, info) of NewtonKrylovInCore(kernel, **settings) from the
    kernel's initial iterate; info["seconds"] its synchronised wall time"""
    solver = NewtonKrylovInCore(kernel, **settings)
    torch.cuda.synchronize()
    start = time.perf_counter()
    x, fcn, info = solver.solve(kernel.init_iterate())
    torch.cuda.synchronize()
    info["seconds"] = time.perf_counter() - start
    return x, fcn, info


def compare_solves(num, label, host, fused):
    """phase num's line comparing a fused solve with the host-driven one,
    each (x, info); raises unless the Newton counts are equal, the Krylov
    counts within one at each step and the iterates within FUSED_TOL"""
    (x_h, info_h), (x_f, info_f) = host, fused
    kry_h = [int(k) for k in info_h["krylov_iterations"]]
    kry_f = [int(k) for k in info_f["krylov_iterations"]]
    diff = rel_err(x_f, x_h, float(x_h.abs().max()))
    phase(num, f"{label}: fused vs host", newton=(info_f["iterations"],
                                                  info_h["iterations"]),
          krylov=(kry_f, kry_h), rel_diff=diff, tol=FUSED_TOL,
          seconds=(info_f["seconds"], info_h["seconds"]))
    if info_f["iterations"] != info_h["iterations"]:
        raise SystemExit(f"chip_smoke: {label}: {info_f['iterations']} fused "
                         f"Newton iterations, {info_h['iterations']} host")
    if any(abs(a - b) > 1 for a, b in zip(kry_f, kry_h)):
        raise SystemExit(f"chip_smoke: {label}: fused Krylov counts {kry_f} "
                         f"against the host path's {kry_h}")
    if not diff <= FUSED_TOL:
        raise SystemExit(f"chip_smoke: {label}: the fused solution is {diff:.3e}"
                         f" from the host path's (bound {FUSED_TOL})")


def iage_solve_phase(depth, ypos, device):
    """phase 3: the iage solve through the CLI entry point (host-driven, as
    the JAX example's), then on the CLI's kernel host-driven again, with the
    fused GMRES and with the fused Newton solve; returns the CLI solve's
    launches of the year kernel and of the table kernel"""
    earlier_times(3)
    reset_counts()
    kernel, x, fcn, info = incore_spinup.main([
        str(NZ), str(NY), str(N_STEPS), "--device", "cuda",
        "--newton-rel-tol", str(SOLVE_TOL),
    ])
    torch.cuda.synchronize()
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: the solve did not dispatch to the kernel")
    solves, counts = {}, {}
    settings = dict(newton_rel_tol=SOLVE_TOL, **incore_spinup.SOLVER)
    for route, flags in (("CLI", None), ("host", {}),
                         ("jit_gmres", {"jit_gmres": True}),
                         ("jit_newton", {"jit_newton": True})):
        if flags is not None:
            reset_counts()
            x, fcn, info = solve_timed(kernel, **settings, **flags)
        launches = imex_cuda.iage_year_launches
        table_launches = imex_cuda.iage_table_launches
        rel = info["fcn_norm"] / info["x_norm"]
        krylov = [int(k) for k in info["krylov_iterations"]]
        # one F per Newton step's Armijo trial and fixed-point update, the
        # initial F, and one JVP per Krylov iteration: a lower bound
        min_launches = 1 + sum(k + 2 for k in krylov)
        if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
            raise SystemExit(f"chip_smoke: non-finite values in the {route} "
                             "solution")
        if not (rel < SOLVE_TOL).all():
            raise SystemExit(f"chip_smoke: {route} residual {rel.max():.3e} "
                             f">= {SOLVE_TOL}")
        if launches < min_launches:
            raise SystemExit(f"chip_smoke: {launches} kernel launches in the "
                             f"{route} solve, expected >= {min_launches}")
        # the CLI's kernel builds one table for its F and JVP years; the
        # later solves on that kernel build none
        if table_launches != (1 if route == "CLI" else 0):
            raise SystemExit(f"chip_smoke: {table_launches} table launches in "
                             f"the {route} solve")
        phase(3, f"solve ({route})", newton_iterations=info["iterations"],
              krylov_iterations=krylov, seconds=info["seconds"],
              max_rel_resid=float(rel.max()), kernel_launches=launches,
              table_launches=table_launches,
              max_ideal_age_years=float(x.max()))
        solves[route] = (x, info)
        counts[route] = (launches, table_launches)
    phase(3, "table", build_ms=kernel.table.build_ms(),
          bytes=kernel.table.nbytes)
    for route in ("jit_gmres", "jit_newton"):
        compare_solves(3, f"iage {route}", solves["host"], solves[route])
    check = IageKernel(depth, ypos, incore_spinup.MODELINFO, device=device,
                       dtype=torch.float64, n_steps=N_STEPS)
    x64 = solves["CLI"][0].double()
    rel64 = (check.norm(check.comp_fcn(x64)) / check.norm(x64)).max().item()
    phase(3, "CLI solution by the f64 plain year", f64_plain_rel_resid=rel64)
    if not rel64 < 1e-4:
        raise SystemExit(f"chip_smoke: f64 residual at the solution {rel64:.3e}")
    against_earlier(3, {"host solve_seconds": solves["CLI"][1]["seconds"]})
    return counts["CLI"]


def stable_step_count(ypos, base_steps):
    """steps a year that keep the explicit (Heun) lateral half inside its
    stability bounds, dt <= 0.8 min(dy^2 / (2K), dy / v): the JAX bench's
    rule (bench.py:67-73)"""
    dy = float(np.min(ypos.delta))
    dt_max = 0.8 * min(dy * dy / (2.0 * 1000.0), dy / 0.1)
    return max(int(base_steps), int(np.ceil(physics.SEC_PER_YEAR / dt_max)))


def iage_block_phase(device):
    """phase 9: iage_block in the bench's million-cell blocked year; returns
    (max abs error, kernel ms, plain f32 ms, bound ms, bounded by) over the
    first tenth of the year"""
    nz, ny = BIG
    depth, ypos = incore_spinup.build_axes(nz, ny)
    n_steps = stable_step_count(ypos, N_STEPS)
    rate = surf_restore_rate(depth)
    diag = np.zeros((1, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    aging = np.full((1, 2), 1.0 / physics.SEC_PER_YEAR, np.float32)
    args = (depth, ypos, incore_spinup.MODELINFO, diag, aging,
            (0.0, physics.SEC_PER_YEAR), n_steps)
    one = make_mesh(1, 1, devices=[device])
    four = make_mesh(1, 4, devices=[device] * 4)
    y0 = torch.full((1, 2, nz, ny), 0.5, dtype=torch.float32, device=device)
    blocked = {"block_steps": BIG_BLOCK_STEPS}
    earlier_times(9)

    reset_counts()
    y_k, ms = kernel_timing_reps(build_sharded_year_blocked(one, *args,
                                                            **blocked),
                                 y0, BIG_REPS)
    launches_per_year = imex_block_cuda.iage_block_launches / (BIG_REPS + 1)
    # the first tenth against the plain f32 blocked and f64 per-step years
    short = tenth(args)
    y_kt, ms_kt = kernel_timing_reps(
        build_sharded_year_blocked(one, *short, **blocked), y0, BIG_REPS)
    y_pt, ms_pt = timed(build_sharded_year_blocked_plain(one, *short,
                                                          **blocked), y0)
    year64 = build_sharded_year(
        one, ShardedYearData(depth, ypos, incore_spinup.MODELINFO, 1),
        diag, aging.reshape(1, 2, 1, 1), *short[-2:])
    y_64, ms_64 = timed(year64, y0.double())
    scale = float(y_64.abs().max())
    err_32 = rel_err(y_kt, y_pt, scale)
    err_64 = rel_err(y_kt, y_64, scale)
    # four shards on the one card, 2000 / 4 = 500 columns each
    y_4, ms_4 = timed(build_sharded_year_blocked(four, *args, **blocked), y0)
    err_4 = rel_err(y_4, y_k, float(y_k.abs().max()))
    # the source-free tenth from seeded noise, a stand-in for a Krylov
    # direction, at 256 levels against the f64 per-step year (ROADMAP C:
    # float32 column solves missed it by 14x (Thomas) and 1250x (PCR))
    rough_args = (*short[:4], np.zeros_like(aging), *short[5:])
    y_r = torch.as_tensor(np.random.default_rng(61).standard_normal(
        (1, 2, nz, ny)), dtype=torch.float32, device=device)
    y_rk = build_sharded_year_blocked(one, *rough_args, **blocked)(y_r)
    y_rp = build_sharded_year_blocked_plain(one, *rough_args, **blocked)(y_r)
    y_r64 = build_sharded_year(
        one, ShardedYearData(depth, ypos, incore_spinup.MODELINFO, 1), diag,
        np.zeros((1, 2, 1, 1)), *short[-2:])(y_r.double())
    scale_r = float(y_r64.abs().max())
    rough = {"rel_err_rough_f32_tenth": rel_err(y_rk, y_rp, scale_r),
             "rel_err_rough_f64_tenth": rel_err(y_rk, y_r64, scale_r),
             "rel_err_rough_plain_f32_vs_f64": rel_err(y_rp, y_r64, scale_r)}
    nx = ny + 4 * BIG_BLOCK_STEPS  # the (1, 1) window: 2 k halo columns a side
    bound_ms, bound_by = iage_bound(2, nz, nx, n_steps)
    bound_t, bound_t_by = iage_bound(2, nz, nx, short[-1])
    phase(9, f"iage_block vs plain ({nz}x{ny}, {n_steps} steps, blocks of "
             f"{BIG_BLOCK_STEPS}; tenth {short[-1]} steps)",
          rel_err_f32_tenth=err_32, rel_err_f64_tenth=err_64,
          rel_err_4_shards=err_4, kernel_ms_per_year=ms,
          kernel_ms_per_step=ms / n_steps, kernel_ms_4_shards=ms_4,
          kernel_ms_tenth=ms_kt, plain_f32_ms_tenth=ms_pt,
          plain_f64_ms_tenth=ms_64, launches_per_year=launches_per_year,
          bound_ms_per_year=bound_ms, bound_ms_tenth=bound_t,
          bound_by=bound_by, max_abs_y=scale, **rough,
          rough_tol=ROUGH_TOL, max_abs_y_rough=scale_r)
    against_earlier(9, {"year": ms, "tenth": ms_kt, "year_4_shards": ms_4})
    finite = all(bool(torch.isfinite(arr).all())
                 for arr in (y_k, y_kt, y_4, y_rk))
    rough_64 = max(rough["rel_err_rough_f64_tenth"],
                   rough["rel_err_rough_plain_f32_vs_f64"])
    if not (finite and err_32 <= F32_TOL and err_64 <= F64_TOL
            and err_4 <= F32_TOL and rough_64 <= ROUGH_TOL):
        raise SystemExit(
            f"chip_smoke: iage_block disagrees (finite {finite}): {err_32:.3e} "
            f"vs f32 over the tenth (bound {F32_TOL}), {err_64:.3e} vs f64 "
            f"(bound {F64_TOL}), 4 shards {err_4:.3e} from 1 (bound "
            f"{F32_TOL}), from noise {rough} (bound {ROUGH_TOL} from f64)"
        )
    # the JSON line's times are of the same work, the tenth
    return (float((y_kt - y_pt).abs().max()), ms_kt, ms_pt, bound_t,
            bound_t_by)


def sharded_solve_phase(device):
    """phase 10: the sharded spin-up through cli/sharded_spinup.py (the
    fused GMRES) on two meshes, then host-driven on the CLI's kernel;
    returns iage_block's launches over the CLI's solves"""
    solutions, launches, new = [], 0, {}
    tol = sharded_spinup.SOLVER["newton_rel_tol"]
    earlier_times(10)
    for label, argv in SHARDED_MESHES:
        reset_counts()
        kernel, x, fcn, info = sharded_spinup.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        count = imex_block_cuda.iage_block_launches
        copies = sharded_year.halo_copies
        launches += count
        new.update({f"{label} solve_seconds": info["seconds"],
                    f"{label} launches": count})
        rel = info["fcn_norm"] / info["x_norm"]
        years = info["f_evals"] + info["jvp_evals"]
        # F at the solution by the float64 per-step year
        check = ShardedIageKernel(
            make_mesh(1, 1, devices=[device]), kernel.depth, kernel.ypos,
            kernel.modelinfo, kernel.module_rates, n_steps=kernel.n_steps)
        x64 = x.double()
        rel64 = (check.norm(check.comp_fcn(x64)) / check.norm(x64)).max().item()
        phase(10, f"sharded spin-up {label}",
              newton_iterations=info["iterations"],
              krylov_iterations=[int(k) for k in info["krylov_iterations"]],
              seconds=info["seconds"], f_seconds=info["f_seconds"],
              f_evals=info["f_evals"], jvp_seconds=info["jvp_seconds"],
              jvp_evals=info["jvp_evals"], max_rel_resid=float(rel.max()),
              f64_plain_rel_resid=rel64, kernel_launches=count,
              launches_per_year=count / max(years, 1),
              host_halo_copies_per_year=copies / max(years, 1))
        if not (torch.isfinite(x).all() and torch.isfinite(fcn).all()):
            raise SystemExit(f"chip_smoke: non-finite values in the sharded "
                             f"solution {label}")
        if not ((rel < tol).all() and rel64 < tol):
            raise SystemExit(f"chip_smoke: sharded residual {rel.max():.3e}, "
                             f"f64 {rel64:.3e} {label} (bound {tol})")
        if count < years or count == 0:
            raise SystemExit(f"chip_smoke: {count} iage_block launches for "
                             f"{years} years {label}")
        # the vertical-product preconditioner's factor and solves went
        # through the banded kernel, and the counts stayed
        lu_launches = banded_cuda.launch_counts()
        counts = (info["iterations"],
                  [int(k) for k in info["krylov_iterations"]])
        phase(10, f"sharded spin-up {label} banded LU",
              factor_launches=lu_launches[0], solve_launches=lu_launches[1],
              counts=counts, counts_before=PHASE10_COUNTS)
        if min(lu_launches) == 0 or counts != PHASE10_COUNTS:
            raise SystemExit(f"chip_smoke: banded launches {lu_launches}, "
                             f"counts {counts} {label} (before: "
                             f"{PHASE10_COUNTS})")
        # the host-driven GMRES on the same kernel
        reset_counts()
        x_h, fcn_h, info_h = solve_timed(kernel, **sharded_spinup.SOLVER)
        count_h = imex_block_cuda.iage_block_launches
        rel_h = info_h["fcn_norm"] / info_h["x_norm"]
        phase(10, f"sharded spin-up {label} (host GMRES)",
              newton_iterations=info_h["iterations"],
              krylov_iterations=[int(k) for k in info_h["krylov_iterations"]],
              seconds=info_h["seconds"], max_rel_resid=float(rel_h.max()),
              kernel_launches=count_h)
        if not ((rel_h < tol).all() and count_h > 0):
            raise SystemExit(f"chip_smoke: host-GMRES sharded residual "
                             f"{rel_h.max():.3e}, {count_h} launches {label}")
        # the CLI's solve was the process's first on this kernel: time the
        # fused GMRES again, warm, beside the (warm) host one
        x_w, _, info_w = solve_timed(kernel, jit_gmres=True,
                                     **sharded_spinup.SOLVER)
        compare_solves(10, f"sharded {label}", (x_h, info_h), (x, info))
        compare_solves(10, f"sharded {label}, warm", (x_h, info_h),
                       (x_w, info_w))
        solutions.append(x)
    diff = rel_err(solutions[1], solutions[0],
                   float(solutions[0].abs().max()))
    phase(10, "sharded spin-up meshes", rel_diff=diff, tol=MESH_TOL,
          launches=launches)
    against_earlier(10, new)
    if not diff < MESH_TOL:
        raise SystemExit(f"chip_smoke: the meshes' solutions differ by "
                         f"{diff:.3e} (bound {MESH_TOL})")
    return launches


def block3d_schedule(year, n_shards):
    """how a blocked year's B7 launches lay the shards' tiles on the card:
    persistent blocks, the most tiles one takes a step, a shard's tiles"""
    (blks,) = year.blocks.values()
    sched = next(blk for blk in blks if blk is not None).schedule(n_shards)
    return {"grid": list(sched.grids),
            "tiles_per_block": list(sched.tiles_per_block),
            "tiles_per_shard": sched.tiles_y * sched.tiles_x}


def block3d_kernel_phase(device):
    """phase 13: transport3d_block in the blocked sharded 3D year; returns
    (launches on its path, max abs error, 1-shard kernel ms, plain f32
    blocked ms, bound ms, bounded by), the times of the coupled year"""
    f32, f64 = torch.float32, torch.float64
    span = (0.0, transport3d_cuda.SEC_PER_YEAR)
    blk = transport3d_block_cuda

    def mesh(n):
        return make_mesh(1, n, devices=[device] * n)

    earlier_times(13)
    new_ms = {}

    # -- (a) the coupled pair at gx1's horizontal extent
    nz, nlat, nlon = BLOCK3D_GRID
    mask = np.ones(BLOCK3D_GRID, np.int32)
    for cell in BLOCK3D_LAND:
        mask[cell] = 0
    circ = synthetic.gen_circulation(nz, nlat, nlon, mask=mask)
    if synthetic.stable_steps_per_year(circ) > BLOCK3D_STEPS:
        raise SystemExit("chip_smoke: 368 steps are past the explicit bound")
    coef, kv, dz_r, diag, src, couple = family_year_inputs(circ,
                                                          BLOCK3D_SPECS)
    wet = torch.as_tensor(mask > 0, dtype=f32, device=device)
    y0 = wet * torch.as_tensor(np.random.default_rng(31).uniform(
        0.0, 1.0, (2,) + BLOCK3D_GRID), dtype=f32, device=device)
    args = (coef, kv, dz_r, diag, src, span, BLOCK3D_STEPS)
    years = {n: build_sharded_transport3d_year_blocked(
        mesh(n), *args, block_steps=BLOCK3D_K, couple=couple)
        for n in (1, BLOCK3D_SHARDS)}
    reset_counts()
    outs, ms = {}, {}
    for n, year in years.items():
        outs[n], ms[n] = kernel_timing_reps(year, y0, GX1_REPS)
    launches = blk.transport3d_block_launches
    expected = (GX1_REPS + 1) * sum(year.launches for year in years.values())
    y_32, ms_32 = timed(build_sharded_transport3d_year_blocked(
        mesh(1), *args, block_steps=BLOCK3D_K, couple=couple, plain=True), y0)
    y_64, ms_64 = timed(transport3d_cuda.build_transport3d_year_plain(
        _to(coef, device, f64), kv, dz_r, diag, src, span, BLOCK3D_STEPS,
        couple), y0.double())
    y_6, ms_6 = timed(build_sharded_transport3d_year_stream(
        mesh(1), *args, couple=couple), y0)
    scale = float(y_64.abs().max())
    errs = {f"rel_err_f64_{n}shard": rel_err(outs[n], y_64, scale)
            for n in outs}
    errs.update(
        rel_err_plain_f32=rel_err(outs[1], y_32, scale),
        rel_err_8_vs_1=rel_err(outs[BLOCK3D_SHARDS], outs[1], scale),
        rel_err_vs_b6=rel_err(outs[1], y_6, scale))
    bound_ms, bound_by = transport3d_bound(coef, kv, 2, BLOCK3D_STEPS)
    year8 = years[BLOCK3D_SHARDS]
    phase(13, f"transport3d_block (a) coupled pair ({nz}x{nlat}x{nlon}, "
              f"{BLOCK3D_STEPS} steps, T=2, blocks of {BLOCK3D_K})",
          **errs, kernel_ms_per_year_1shard=ms[1],
          kernel_ms_per_year_8shards=ms[BLOCK3D_SHARDS],
          plain_f32_blocked_ms_per_year=ms_32, plain_f64_ms_per_year=ms_64,
          b6_ms_per_year=ms_6, launches=launches, expected_launches=expected,
          schedule_1shard=block3d_schedule(years[1], 1),
          schedule_8shards=block3d_schedule(year8, BLOCK3D_SHARDS),
          smem_bytes={n: year.smem_bytes for n, year in years.items()},
          blocks_per_year=year8.n_blocks,
          halo_copies_per_year_8shards=year8.halo_copies,
          halo_mbytes_per_year_8shards=year8.halo_bytes / 1e6,
          bound_ms_per_year=bound_ms, bound_by=bound_by, max_abs_y=scale)
    for n, y in outs.items():
        if not torch.isfinite(y).all():
            raise SystemExit(f"chip_smoke: transport3d_block ({n} shards) is "
                             f"not finite")
        if float((y * (1.0 - wet)).abs().max()) != 0.0:
            raise SystemExit(f"chip_smoke: transport3d_block wets land ({n} "
                             f"shards)")
    if not (max(errs[f"rel_err_f64_{n}shard"] for n in outs)
            <= BLOCK3D_F64_TOL and errs["rel_err_plain_f32"] <= F32_TOL
            and errs["rel_err_8_vs_1"] <= BLOCK3D_SHARD_TOL
            and errs["rel_err_vs_b6"] <= BLOCK3D_VS_B6):
        raise SystemExit(f"chip_smoke: transport3d_block disagrees: {errs}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {launches} transport3d_block launches "
                         f"for {expected} expected")
    worst_abs = float((outs[1] - y_32).abs().max())
    timing = (ms[1], ms_32, bound_ms, bound_by)
    new_ms.update(coupled_1shard_year=ms[1],
                  coupled_8shards_year=ms[BLOCK3D_SHARDS])
    del years, outs, y_32, y_64, y_6

    # -- (b) phase 8's steady upwind3 year at full gx1 depth, T = 1
    nz, nlat, nlon = GX1
    circ = synthetic.gen_circulation(*GX1)
    n_steps = max(GX1_MIN_STEPS, synthetic.stable_steps_per_year(circ))
    coef, kv, dz_r, _, _, _ = family_year_inputs(circ, [[{"name": "T"}]])
    wet = torch.as_tensor(circ["mask"] > 0, dtype=f32, device=device)
    y0 = wet * torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 1.0, (1,) + GX1), dtype=f32, device=device)
    zeros = np.zeros((1, nz, nlat * nlon))
    shed = {"recip_area": 1.0 / circ["TAREA"], "recip_dz": 1.0 / circ["dz"],
            "t_dim": 1}

    def blocked(n, k, steps):
        return build_sharded_transport3d_year_blocked(
            mesh(n), coef, kv, dz_r, zeros, zeros, span, steps,
            block_steps=k)

    years = {nk: blocked(*nk, n_steps) for nk in GX1_BLOCK_MESHES}
    year5 = transport3d_stream_cuda.build_transport3d_year_stream(
        coef, kv, dz_r, None, None, span, n_steps, **shed, device=device)
    year6 = build_sharded_transport3d_year_stream(
        mesh(GX1_SHARDS), coef, kv, dz_r, None, None, span, n_steps,
        steps_per_sweep=2, **shed)
    reset_counts()
    ms_b7, outs = {}, {}
    for nk, year in years.items():
        outs[nk], ms_b7[nk] = kernel_timing_reps(year, y0, GX1_REPS)
    count = blk.transport3d_block_launches
    launches += count
    _, ms5 = kernel_timing_reps(year5, y0, 1)
    y_6, ms6 = timed(year6, y0)
    scale = float(outs[(1, 1)].abs().max())
    err_b5 = rel_err(outs[(1, 1)], year5(y0), scale)
    y_32, y_64 = plain_gx1(coef, kv, dz_r, y0)
    scale_c = float(y_64.abs().max())
    errs = {}
    for nk in GX1_BLOCK_MESHES:
        y_c = blocked(*nk, GX1_CHECK_STEPS)(y0)
        errs[f"rel_err_f32_400_steps_{nk[0]}shard_k{nk[1]}"] = rel_err(
            y_c, y_32, scale_c)
        worst_abs = max(worst_abs, float((y_c - y_32).abs().max()))
        if float((y_c * (1.0 - wet)).abs().max()) != 0.0:
            raise SystemExit("chip_smoke: transport3d_block wets land at gx1")
    bound_g, bound_g_by = transport3d_bound(coef, kv, 1, n_steps)
    phase(13, f"transport3d_block (b) gx1 ({nz}x{nlat}x{nlon}, {n_steps} "
              f"steps, T=1, upwind3)",
          **{f"kernel_ms_per_year_{n}shard_k{k}": ms_b7[(n, k)]
             for n, k in GX1_BLOCK_MESHES},
          b5_ms_per_year=ms5, b6_ms_per_year_4shards_k2=ms6,
          rel_err_1shard_vs_b5=err_b5, **errs, tol=F32_TOL, launches=count,
          schedule={f"{n}shard_k{k}": block3d_schedule(years[(n, k)], n)
                    for n, k in GX1_BLOCK_MESHES},
          smem_bytes={f"{n}shard_k{k}": years[(n, k)].smem_bytes
                      for n, k in GX1_BLOCK_MESHES},
          halo_copies_per_year={f"{n}shard_k{k}": years[(n, k)].halo_copies
                                for n, k in GX1_BLOCK_MESHES},
          bound_ms_per_year=bound_g, bound_by=bound_g_by, max_abs_y=scale)
    if not (all(torch.isfinite(y).all() for y in outs.values())
            and max(errs.values()) <= F32_TOL and err_b5 <= F32_TOL):
        raise SystemExit(f"chip_smoke: transport3d_block at gx1 disagrees: "
                         f"{errs}, {err_b5:.3e} from B5")
    expected = (GX1_REPS + 1) * sum(year.launches for year in years.values())
    if count != expected:
        raise SystemExit(f"chip_smoke: {count} transport3d_block launches at "
                         f"gx1 for {expected} expected")
    new_ms.update(gx1_1shard_k1_year=ms_b7[(1, 1)],
                  gx1_4shards_k2_year=ms_b7[(GX1_SHARDS, 2)])
    against_earlier(13, new_ms)
    PLAIN_GX1.clear()
    phase(13, "transport3d_block path", launches=launches)
    return (launches, worst_abs, *timing)


def iage_v1_phase(depth, ypos, device):
    """phase 14: iage_year_v1 at phase 2's size, F and JVP, timed beside
    iage_year; returns (launches on its path, max abs error, kernel ms,
    plain f32 ms) over the F route's tenth"""
    earlier_times(14)
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
    args = {route: {dtype: (grids[dtype], diag, source, span, N_STEPS)
                    for dtype in (torch.float32, torch.float64)}
            for route, (source, _) in inputs.items()}
    y0s = {route: torch.as_tensor(y0, dtype=torch.float32, device=device)
           for route, (_, y0) in inputs.items()}
    # the path: each route's full year on B1v1, in turns with B1
    ms_v1, ms_b1 = {}, {}
    reset_counts()
    for route, y0 in y0s.items():
        a32 = args[route][torch.float32]
        _, ms_v1[route] = kernel_timing(
            imex_cuda.build_iage_year_v1(*a32, device=device), y0)
        _, ms_b1[route] = kernel_timing(
            imex_cuda.build_iage_year(*a32, device=device), y0)
    launches = imex_cuda.iage_year_v1_launches
    if launches != 2 * (REPS + 1):
        raise SystemExit(f"chip_smoke: {launches} iage_year_v1 launches for "
                         f"{2 * (REPS + 1)} years")
    worst_abs, tenth_ms = 0.0, {}
    for route, y0 in y0s.items():
        a32, a64 = args[route][torch.float32], args[route][torch.float64]
        y_s, ms_s = kernel_timing(imex_cuda.build_iage_year_v1(
            *tenth(a32), device=device), y0)
        y_b1 = imex_cuda.build_iage_year(*tenth(a32), device=device)(y0)
        ref, ms_32 = timed(imex_cuda.build_iage_year_plain(*tenth(a32)), y0)
        y_64, _ = timed(imex_cuda.build_iage_year_plain(*tenth(a64)),
                        y0.double())
        scale = float(ref.abs().max())
        err_32 = rel_err(y_s, ref, scale)
        err_64 = rel_err(y_s, y_64, float(y_64.abs().max()))
        phase(14, f"iage_year_v1 vs plain ({route})",
              rel_err_f32_tenth=err_32, rel_err_f64_tenth=err_64,
              rel_err_vs_b1_tenth=rel_err(y_s, y_b1, scale),
              compared_steps=CHECK_STEPS, kernel_ms_per_year=ms_v1[route],
              b1_ms_per_year=ms_b1[route], kernel_ms_tenth=ms_s,
              plain_f32_ms_tenth=ms_32, launches=launches, max_abs_y=scale)
        if not (torch.isfinite(y_s).all() and err_32 <= F32_TOL
                and err_64 <= F64_TOL):
            raise SystemExit(
                f"chip_smoke: iage_year_v1 disagrees with the plain year "
                f"({route}): {err_32:.3e} vs f32 (bound {F32_TOL}), "
                f"{err_64:.3e} vs f64 (bound {F64_TOL})")
        worst_abs = max(worst_abs, float((y_s - ref).abs().max()))
        tenth_ms[route] = (ms_s, ms_32)
    against_earlier(14, {"F_year": ms_v1["F"], "JVP_year": ms_v1["JVP"],
                         "F_tenth": tenth_ms["F"][0]})
    return (launches, worst_abs, *tenth_ms["F"])


def year_operator_phase(device):
    """phase 15: the dense year operator through
    cli/year_operator_spinup.py at the example's defaults: the probe
    through B1 under the channel map (2 x 125 channels a launch on the
    kernel's one T = 2 table), the direct solve and the spectrum; the
    operator's F and JVP against B1's, and F(X*) through B1"""
    reset_counts()
    kernel, op, x_star, info = year_operator_spinup.main(
        [*YEAR_OP, "--device", "cuda"])
    torch.cuda.synchronize()
    years = imex_cuda.iage_year_launches
    tables = imex_cuda.iage_table_launches
    if not kernel.use_kernel:
        raise SystemExit("chip_smoke: the probe did not dispatch to the kernel")
    n = kernel.nz * kernel.ny
    chunks = -(-n // int(YEAR_OP[3]))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.0, 2.0, (2, kernel.nz, kernel.ny)),
                        dtype=torch.float32, device=device)
    v = torch.as_tensor(rng.standard_normal((2, kernel.nz, kernel.ny)),
                        dtype=torch.float32, device=device)
    errs = {}
    for name, ours, ref in (("fcn", op.fcn(x), kernel.comp_fcn(x)),
                            ("jvp", op.jvp(v), kernel.jvp(x, None, v))):
        errs[name] = rel_err(ours, ref, float(ref.abs().max()))
    resid = info["resid"] / float(x_star.abs().max())
    map_32, map_64, floor_64, map_scale, map_ms, map_plain_ms = \
        probe_chunk_check(kernel, device)
    phase(15, "year operator (40x50x8760, chunks of 125, through B1)",
          probe_seconds=info["probe_seconds"],
          table_bytes=info["table_bytes"], probe_launches=chunks,
          iage_year_launches=years, table_launches=tables,
          solve_seconds=info["solve_seconds"],
          spectrum_seconds=info["spectrum_seconds"], rel_err=errs,
          f_at_x_star_rel=resid, tol=YEAR_OP_TOL,
          probe_chunk_vs_f32_tenth=map_32, probe_chunk_vs_f64_tenth=map_64,
          plain_f32_vs_f64_tenth=floor_64, probe_chunk_max_abs_y=map_scale,
          probe_chunk_ms_tenth=map_ms,
          plain_f32_ms_tenth=map_plain_ms,
          leading_eigvals=[float(abs(e)) for e in info["eigvals"][:, 0]])
    if not (torch.isfinite(op.b_mats).all() and torch.isfinite(x_star).all()):
        raise SystemExit("chip_smoke: non-finite values in the year operator")
    if tables != 1:
        raise SystemExit(f"chip_smoke: {tables} table launches for the probe, "
                         "expected the kernel's one")
    # the probe's chunks, the constant response and F(X*)
    if years != chunks + 2:
        raise SystemExit(f"chip_smoke: {years} iage_year launches, expected "
                         f"{chunks + 2}")
    if not (max(errs.values()) < YEAR_OP_TOL and resid < YEAR_OP_TOL):
        raise SystemExit(f"chip_smoke: the year operator: {errs}, F(X*) "
                         f"{resid:.3e} (bound {YEAR_OP_TOL})")
    # a unit column decays to a few hundredths of itself in a tenth of the
    # year, so, relative to the output's max, float32 rounding alone puts
    # the plain f32 year farther from f64 than phase 2's 5e-5: B1 under
    # the map must lie no farther from f64 than it
    if not map_64 <= floor_64:
        raise SystemExit(f"chip_smoke: B1 under the probe's map is "
                         f"{map_64:.3e} from the plain f64 year, farther than "
                         f"the plain f32 year's {floor_64:.3e}")
    return years


def probe_chunk_check(kernel, device):
    """B1 on one probe launch's channels (the first chunk's unit columns of
    both tracers, channels mapped 125 to each of the two slots) against the
    plain f32 and f64 years over the first tenth, on the tenth's T = 2
    table as the probe shares the year's; returns (B1 from f32 relative to
    its max|y|, B1 from f64 and f32 from f64 relative to f64's, f64's
    max|y|, kernel ms, plain f32 ms)"""
    chunk, nz, ny = int(YEAR_OP[3]), kernel.nz, kernel.ny
    diag = torch.as_tensor(kernel._vert_diag, dtype=torch.float64)
    channel_diag = diag.repeat_interleave(chunk, dim=0)
    args = tenth((kernel.grid, channel_diag, np.zeros((2 * chunk, 1, 1)),
                  (0.0, kernel.year), kernel.n_steps))
    table = imex_cuda.build_iage_table(kernel.grid, diag, *args[-2:],
                                       device=device)
    slot_map = table.check(
        imex_cuda._table_key(kernel.grid, channel_diag), (2 * chunk, nz, ny),
        args[-1], *imex_cuda._time_step(*args[-2:]), device)
    if table.shape[0] != 2 or slot_map.tolist() != [0] * chunk + [1] * chunk:
        raise SystemExit(f"chip_smoke: the probe's map is not 125 channels "
                         f"to each of two slots: {slot_map.tolist()}")
    y0 = torch.zeros((2, chunk, nz * ny), dtype=torch.float32, device=device)
    cols = torch.arange(chunk, device=device)
    y0[:, cols, cols] = 1.0
    y0 = y0.reshape(2 * chunk, nz, ny)
    y_k, ms_k = timed(imex_cuda.build_iage_year(*args, device=device,
                                                table=table), y0)
    ref, ms_p = timed(imex_cuda.build_iage_year_plain(*args), y0)
    grid64 = physics.make_grid(kernel.depth, kernel.ypos,
                               incore_spinup.MODELINFO, device=device,
                               dtype=torch.float64)
    y_64, _ = timed(imex_cuda.build_iage_year_plain(grid64, *args[1:]),
                    y0.double())
    if not torch.isfinite(y_k).all():
        raise SystemExit("chip_smoke: non-finite values from B1 under the "
                         "probe's map")
    scale_64 = float(y_64.abs().max())
    return (rel_err(y_k, ref, float(ref.abs().max())),
            rel_err(y_k, y_64, scale_64), rel_err(ref, y_64, scale_64),
            scale_64, ms_k, ms_p)


def ci_compare(name, workdir, files):
    """each of files (relative path, tolerances) against baselines/name"""
    base_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baselines", name)
    bad = []
    for rel, tols in files:
        rtol, atol = tols or (baseline_cmp.DEFAULT_RTOL, baseline_cmp.DEFAULT_ATOL)
        if not baseline_cmp.compare(os.path.join(workdir, rel),
                                    os.path.join(base_dir, os.path.basename(rel)),
                                    rtol, atol):
            bad.append(rel)
    if bad:
        raise SystemExit(f"chip_smoke: {name}: {bad} differ from the baselines")
    return len(files)


def ci_setup(workdir, device, extra=()):
    """the port's test_problem setup_solver in this process, as
    scripts/setup_solver.sh runs it"""
    test_problem_state.ModelState.depth = None
    test_problem_setup.main(test_problem_setup.parse_args(
        [*CI_SETUP, "--workdir", workdir, "--device", device, *extra]))


def radau_years(workdir):
    """the Radau year lines of the workdir's solver log"""
    with open(os.path.join(workdir, "newton_krylov.log")) as fptr:
        return [dict(zip(("module", "device", "attempts", "nfev", "nlu",
                          "seconds"), match.groups()))
                for match in RADAU_LINE.finditer(fptr.read())]


def file_backed_phase(device):
    """phase 16: ci_short's setup and ci_long_iage's solve through the
    port's test_problem setup_solver and nk_driver.sh, F in float64 on
    `device` (the card here), against the committed baselines"""
    start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ci_")
    try:
        short = os.path.join(work, "ci_short_workdir")
        ci_setup(short, device)
        short_files = ci_compare("ci_short", short, CI_SHORT_FILES)
        short_s = time.perf_counter() - start

        long = os.path.join(work, "ci_long_iage_workdir")
        ci_setup(long, device, ["--tracer_module_names", "iage"])
        driver = subprocess.run([os.path.join(long, "nk_driver.sh")],
                                capture_output=True, text=True,
                                timeout=CI_DRIVER_TIMEOUT_S)
        if driver.returncode != 0:
            print(driver.stdout[-4000:], driver.stderr[-4000:], flush=True)
            raise SystemExit(f"chip_smoke: nk_driver.sh exited "
                             f"{driver.returncode}")
        long_files = ci_compare("ci_long_iage", long, CI_LONG_IAGE_FILES)
        with open(os.path.join(long, "Newton_state.json")) as fptr:
            log = fptr.read().replace(long, "HOME/ci_long_iage_workdir")
        base_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baselines", "ci_long_iage")
        with open(os.path.join(base_dir, "Newton_state.json")) as fptr:
            if log != fptr.read():
                raise SystemExit("chip_smoke: ci_long_iage's Newton_state.json "
                                 "differs from the baseline")
        newton = json.loads(log)["iteration"]
        krylov = []
        for name in sorted(os.listdir(long)):
            if name.startswith("krylov_"):
                with open(os.path.join(long, name, "Krylov_state.json")) as fptr:
                    krylov.append(json.load(fptr)["iteration"])
        years = radau_years(short) + radau_years(long)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if {year["device"] for year in years} != {str(compute.resolve_device(device))}:
        raise SystemExit(f"chip_smoke: Radau years ran on "
                         f"{sorted({year['device'] for year in years})}")
    stats = {}
    for module in sorted({year["module"] for year in years}):
        mine = [year for year in years if year["module"] == module]
        attempts = sum(int(year["attempts"]) for year in mine)
        seconds = sum(float(year["seconds"]) for year in mine)
        stats[module] = {
            "years": len(mine),
            "s_a_year": round(seconds / len(mine), 3),
            "attempts_a_year": round(attempts / len(mine), 1),
            "nfev_a_year": round(sum(int(y["nfev"]) for y in mine) / len(mine), 1),
            "nlu_a_year": round(sum(int(y["nlu"]) for y in mine) / len(mine), 1),
            "ms_an_attempt": round(1e3 * seconds / attempts, 4),
        }
    phase(16, "file-backed test_problem (float64, Radau on the card)",
          ci_short_files=short_files, ci_short_s=round(short_s, 1),
          ci_long_iage_files=long_files, newton_state="identical",
          newton_iterations=newton, krylov_iterations=krylov,
          radau=json.dumps(stats, sort_keys=True),
          seconds=round(time.perf_counter() - start, 1))
    return stats


# -- phase 17: py_driver_2d's file-backed path --------------------------------


class _Lines(logging.Handler):
    """the messages logged while it is attached"""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def pd2d_cfg_fnames(workdir, override):
    """input/py_driver_2d's two cfgs and the workdir's override.cfg"""
    os.makedirs(workdir, exist_ok=True)
    fname = os.path.join(workdir, "override.cfg")
    with open(fname, "w") as fptr:
        fptr.write("\n".join(["[modelinfo]"] + [f"{key} = {val}" for key, val
                                               in override.items()]) + "\n")
    return ",".join([os.path.join(PD2D_INPUT, "newton_krylov.cfg"),
                     os.path.join(PD2D_INPUT, "model_params.cfg"), fname])


def pd2d_ci_setup(workdir, override, device, extra=()):
    """the port's py_driver_2d setup_solver in this process, as
    scripts/setup_solver.sh runs it for the ci scripts"""
    pd2d_state.ModelState.reset_class_state()
    pd2d_setup.main(pd2d_setup.parse_args(
        ["--fp_cnt", "1", "--model_name", "py_driver_2d",
         "--tracer_module_names", "iage",
         "--cfg_fnames", pd2d_cfg_fnames(workdir, override),
         "--workdir", workdir, "--device", device, *extra]))


def pd2d_model(workdir, override, modules, device):
    """the ModelState class configured on workdir (grid file written), as
    the solver configures it"""
    pd2d_state.ModelState.reset_class_state()
    parser, rest = port_share.common_args(
        "chip_smoke", "py_driver_2d",
        ["--cfg_fnames", pd2d_cfg_fnames(workdir, override), "--workdir",
         workdir, "--tracer_module_names", modules, "--persist", "--device",
         device])
    args = parser.parse_args(rest)
    config = port_share.read_cfg_files(args)
    pd2d_setup.gen_grid_vars_file(args, config["modelinfo"])
    pd2d_state.ModelState.model_config_obj = port_model_config.ModelConfig(
        config["modelinfo"])
    return pd2d_state.ModelState


def pd2d_years(lines):
    """the Radau year lines among log lines"""
    keys = ("module", "device", "attempts", "nfev", "nlu", "seconds",
            "lu_launches")
    return [dict(zip(keys, match.groups())) for line in lines
            for match in PD2D_RADAU_LINE.finditer(line)]


def pd2d_log_years(workdir):
    with open(os.path.join(workdir, "newton_krylov.log")) as fptr:
        return pd2d_years(fptr.read().splitlines())


def year_stats(years):
    """seconds, attempts, nfev, LUs and banded launches a year, ms an
    attempt"""
    count = len(years)
    attempts = sum(int(y["attempts"]) for y in years)
    seconds = sum(float(y["seconds"]) for y in years)
    return {
        "years": count,
        "s_a_year": round(seconds / count, 4),
        "attempts_a_year": round(attempts / count, 1),
        "nfev_a_year": round(sum(int(y["nfev"]) for y in years) / count, 1),
        "nlu_a_year": round(sum(int(y["nlu"]) for y in years) / count, 1),
        "lu_launches_a_year": round(
            sum(int(y["lu_launches"]) for y in years) / count, 1),
        "ms_an_attempt": round(1e3 * seconds / attempts, 4),
    }


def captured(fn):
    """(fn(), the model state's log lines meanwhile)"""
    capture = _Lines()
    logger = logging.getLogger(pd2d_state.__name__)
    logger.setLevel(logging.INFO)
    logger.addHandler(capture)
    try:
        return fn(), capture.lines
    finally:
        logger.removeHandler(capture)


def month_against_dense(state_cls, module_cls, device, label, hist=None):
    """F over 30 days of gen_init_iterate through the model's comp_fcn (the
    banded year on the card; its history to `hist`) against the dense-mode
    Radau5 of the same tendency and tolerances on the card; returns (the
    banded month's year line, the month's state, F)"""

    class Month(state_cls):
        time_range = (0.0, PD2D_MONTH)

    state = Month("gen_init_iterate")
    y0 = state.tracer_modules[0].get_tracer_vals_all().reshape(-1)
    fcn, lines = captured(lambda: state.comp_fcn(None, None, hist))
    banded_y = fcn.tracer_modules[0].get_tracer_vals_all().reshape(-1) + y0
    (year,) = pd2d_years(lines)
    tracer_module = state.tracer_modules[0]
    grid = state._grid(torch.float64, device)
    static = tracer_module.tend_static_args()
    solver = Radau5(
        module_cls.build_tend(grid, static, None), len(y0), (0.0, PD2D_MONTH),
        [0.0, PD2D_MONTH], device=device, rtol=2.0e-7, atol=2.0e-7,
        max_step=0.01 * PD2D_MONTH,
        jac=module_cls.build_jac(grid, static, None))
    (dense_ys, info), dense_ms = timed(
        solver.integrate, torch.as_tensor(y0, dtype=torch.float64, device=device))
    if not info["success"]:
        raise SystemExit(f"chip_smoke: the dense {label} month failed")
    dense_y = dense_ys[-1].cpu().numpy()
    diff = float(np.abs(banded_y - dense_y).max() / np.abs(dense_y).max())
    phase(17, f"{label}: 30 days banded vs dense on the card", rel_diff=diff,
          tol=PD2D_DENSE_TOL, banded_s=float(year["seconds"]),
          banded_attempts=int(year["attempts"]), banded_nlu=int(year["nlu"]),
          dense_s=round(dense_ms / 1e3, 3), dense_attempts=info["n_attempts"],
          dense_nlu=info["nlu"], lu_launches=int(year["lu_launches"]))
    if not diff < PD2D_DENSE_TOL:
        raise SystemExit(f"chip_smoke: {label}: banded and dense months differ "
                         f"by {diff:.3e} (bound {PD2D_DENSE_TOL})")
    return year, state, fcn


def banded_ops(n_blocks, m, bw, cplx):
    """float64 operations of one factorisation and one solve, counted from
    the algorithm (csrc/banded_lu.cu's note): the pivots' multiply-adds and
    divisions, the solves' multiply-adds and divisions"""
    fma, div = (8, 10) if cplx else (2, 1)
    upd = sum(min(bw, m - 1 - p) ** 2 for p in range(m - 1))
    mult = sum(min(bw, m - 1 - p) for p in range(m - 1))
    return n_blocks * (fma * (upd + 2 * mult) + div * (mult + m))


def banded_bound(n_blocks, m, bw, dtype):
    """(least ms, "bytes" or "operations") of one factorisation and one
    solve: the bands read, the factors written, the right-hand side read,
    the solution written (the factors the solve reads again are the
    work's intermediate)"""
    elem = torch.empty((), dtype=dtype).element_size()
    width = 2 * bw + 1
    n_bytes = elem * n_blocks * (2 * m * width + 2 * m)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * banded_ops(n_blocks, m, bw, dtype.is_complex) / PEAK_F64_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def dominant_bands(rng, n_blocks, m, bw, dtype, device):
    """diagonally dominant (n_blocks, m, 2bw+1) row bands, zero outside the
    matrix"""
    vals = rng.uniform(-1.0, 1.0, (n_blocks, m, 2 * bw + 1))
    if dtype.is_complex:
        vals = vals + 1j * rng.uniform(-1.0, 1.0, vals.shape)
    rows = np.arange(m)[:, None] + np.arange(2 * bw + 1)[None, :] - bw
    vals[:, (rows < 0) | (rows >= m)] = 0.0
    vals[:, :, bw] = np.abs(vals).sum(axis=-1) + 1.0
    return torch.as_tensor(vals, dtype=dtype, device=device)


def banded_kernel_timings(device):
    """the banded kernel against its plain twin at the path's shapes in
    float64 and complex128: errors, factor and solve ms, the plain twin's
    ms, the dense torch.linalg.lu_factor + lu_solve of the same matrices
    (library_ms, which the port never calls) and the bound; returns the
    JSON entry's numbers (iage 30x30, complex128)"""
    rng = np.random.default_rng(17)
    entry = None
    for label, (n_blocks, m, bw) in BANDED_SHAPES.items():
        for dtype in (torch.float64, torch.complex128):
            bands = dominant_bands(rng, n_blocks, m, bw, dtype, device)
            rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, (n_blocks, m)),
                                  dtype=dtype, device=device)
            lu = banded.banded_lu_factor_blocks(bands)
            x = banded.banded_lu_solve_blocks(lu, rhs)
            (lu_p, x_p), plain_ms = timed(lambda: (
                lambda f: (f, banded.banded_lu_solve_plain(f, rhs)))(
                    banded.banded_lu_factor_plain(bands)))
            err = max(float((lu - lu_p).abs().max() / lu_p.abs().max()),
                      float((x - x_p).abs().max() / x_p.abs().max()))
            abs_err = max(float((lu - lu_p).abs().max()),
                          float((x - x_p).abs().max()))
            _, factor_ms = kernel_timing_reps(
                lambda _: banded.banded_lu_factor_blocks(bands), None, 10)
            _, solve_ms = kernel_timing_reps(
                lambda _: banded.banded_lu_solve_blocks(lu, rhs), None, 20)
            dense = torch.zeros((n_blocks, m, m), dtype=dtype, device=device)
            for d in range(2 * bw + 1):
                off = d - bw
                idx = torch.arange(max(0, -off), min(m, m - off), device=device)
                dense[:, idx, idx + off] = bands[:, idx, d]

            def library():
                lu_d, piv = torch.linalg.lu_factor(dense)
                return torch.linalg.lu_solve(lu_d, piv, rhs[..., None])

            _, library_ms = kernel_timing_reps(lambda _: library(), None, 3)
            bound_ms, bound_by = banded_bound(n_blocks, m, bw, dtype)
            threads, where, smem, _scratch = banded_cuda.factor_plan(
                dtype, bw, device)
            before = BANDED_EARLIER_US[(label, dtype)]
            phase(17, f"banded_lu {label} {str(dtype)[6:]} ({n_blocks} x {m} "
                      f"x {2 * bw + 1})", rel_err=err, tol=BANDED_TOL[dtype],
                  factor_us=round(1e3 * factor_ms, 2),
                  solve_us=round(1e3 * solve_ms, 2),
                  earlier_factor_us=before[0], earlier_solve_us=before[1],
                  plain_factor_and_solve_ms=round(plain_ms, 2),
                  library_ms=round(library_ms, 4), bound_us=round(1e3 * bound_ms, 3),
                  bound_by=bound_by, plan_threads=threads,
                  plan_shared_bytes=smem, plan_cluster=1,
                  plan_window=("device" if where == "device"
                               else f"on-chip ({where})"))
            if not err < BANDED_TOL[dtype]:
                raise SystemExit(f"chip_smoke: banded_lu {label} {dtype} differs "
                                 f"from its plain twin by {err:.3e}")
            if entry is None and dtype.is_complex:
                entry = (abs_err, factor_ms + solve_ms, plain_ms, bound_ms,
                         bound_by, library_ms)
            del dense
        banded_pair_timings(label, rng, n_blocks, m, bw, device)
    return entry


def banded_pair_timings(label, rng, n_blocks, m, bw, device):
    """the pair launches at a path shape (both Radau stage systems, float64
    and complex128, in one launch) against their plain twins, timed"""
    bands = [dominant_bands(rng, n_blocks, m, bw, dtype, device)
             for dtype in (torch.float64, torch.complex128)]
    rhs_r = torch.as_tensor(rng.uniform(-1.0, 1.0, (n_blocks, m)),
                            dtype=torch.float64, device=device)
    rhs_c = rhs_r.to(torch.complex128) * (1.0 - 0.5j)
    lu_r, lu_c = banded.banded_lu_factor_pair(*bands)
    x_r, x_c = banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c)
    err = 0.0
    for band, lu, rhs, x in ((bands[0], lu_r, rhs_r, x_r),
                             (bands[1], lu_c, rhs_c, x_c)):
        lu_p = banded.banded_lu_factor_plain(band)
        x_p = banded.banded_lu_solve_plain(lu_p, rhs)
        err = max(err, float((lu - lu_p).abs().max() / lu_p.abs().max()),
                  float((x - x_p).abs().max() / x_p.abs().max()))
    _, factor_ms = kernel_timing_reps(
        lambda _: banded.banded_lu_factor_pair(*bands), None, 10)
    _, solve_ms = kernel_timing_reps(
        lambda _: banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c), None, 20)
    phase(17, f"banded_lu pair {label} float64 + complex128 ({n_blocks} x {m} "
              f"x {2 * bw + 1})", rel_err=err, tol=BANDED_TOL[torch.float64],
          factor_pair_us=round(1e3 * factor_ms, 2),
          solve_pair_us=round(1e3 * solve_ms, 2))
    if not err < BANDED_TOL[torch.float64]:
        raise SystemExit(f"chip_smoke: banded_lu's pair launches at {label} "
                         f"differ from their plain twins by {err:.3e}")


def py_driver_2d_phase(device):
    """phase 17: py_driver_2d's file-backed path in float64 on the card:
    ci_py_driver_2d_iage's setup and ci_py_driver_2d_iage_column_regions'
    solve against baselines/, the 40 x 50 iage year and its first 30 days
    against the dense route, phosphorus at 30 x 30 (30 days against the
    dense route, then its preconditioner); returns the banded kernel's
    launches over the path and the JSON entry's numbers"""
    start = time.perf_counter()
    device = compute.resolve_device(device)
    reset_counts()
    work = tempfile.mkdtemp(prefix="chip_smoke_pd2d_")
    try:
        # (a) scripts/ci_py_driver_2d_iage.sh
        iage_dir = os.path.join(work, "ci_py_driver_2d_iage_workdir")
        pd2d_ci_setup(iage_dir, PD2D_IAGE, str(device))
        files_a = ci_compare("ci_py_driver_2d_iage", iage_dir, PD2D_SETUP_FILES)
        years = {"ci 30x30": pd2d_log_years(iage_dir)}

        # (b) scripts/ci_py_driver_2d_iage_column_regions.sh
        name = "ci_py_driver_2d_iage_column_regions"
        col_dir = os.path.join(work, f"{name}_workdir")
        pd2d_ci_setup(col_dir, PD2D_COLUMNS, str(device), ["--persist"])
        files_b = ci_compare(name, col_dir, PD2D_SETUP_FILES)
        driver = subprocess.run([os.path.join(col_dir, "nk_driver.sh")],
                                capture_output=True, text=True,
                                timeout=CI_DRIVER_TIMEOUT_S)
        if driver.returncode != 0:
            print(driver.stdout[-4000:], driver.stderr[-4000:], flush=True)
            raise SystemExit(f"chip_smoke: {name}'s nk_driver.sh exited "
                             f"{driver.returncode}")
        files_b += ci_compare(name, col_dir, PD2D_SOLVE_FILES)
        with open(os.path.join(col_dir, "Newton_state.json")) as fptr:
            log = fptr.read().replace(col_dir, f"HOME/{name}_workdir")
        base_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baselines", name)
        with open(os.path.join(base_dir, "Newton_state.json")) as fptr:
            if log != fptr.read():
                raise SystemExit(f"chip_smoke: {name}'s Newton_state.json "
                                 "differs from the baseline")
        newton = json.loads(log)["iteration"]
        krylov = []
        for sub in sorted(os.listdir(col_dir)):
            if sub.startswith("krylov_"):
                with open(os.path.join(col_dir, sub, "Krylov_state.json")) as fptr:
                    krylov.append(json.load(fptr)["iteration"])
        years["ci 20x3 solve"] = pd2d_log_years(col_dir)
        phase(17, "ci_py_driver_2d_iage and its column regions",
              ci_iage_files=files_a, column_files=files_b,
              newton_state="identical", newton_iterations=newton,
              krylov_iterations=krylov)

        # (c) the iage year at model_params.cfg's 40 x 50, then its first
        # 30 days against the dense route (n = 4000)
        state_cls = pd2d_model(os.path.join(work, "iage_40x50"), {}, "iage",
                               str(device))
        state = state_cls("gen_init_iterate")
        if (len(state.depth), len(state.ypos)) != (40, 50):
            raise SystemExit("chip_smoke: model_params.cfg's grid is not "
                             "40 x 50")
        years["iage 40x50"] = pd2d_years(
            captured(lambda: state.comp_fcn(None, None))[1])
        year_m, _, _ = month_against_dense(state_cls, pd2d_iage.iage, device,
                                           "iage 40x50")
        years["iage 40x50 month"] = [year_m]

        # (d) phosphorus at 30 x 30: 30 days against the dense route, then
        # the eigen-regularised preconditioner through the kernel
        phos_dir = os.path.join(work, "phosphorus_30x30")
        state_cls = pd2d_model(phos_dir, PD2D_IAGE, "phosphorus", str(device))
        hist = os.path.join(phos_dir, "hist.nc")
        year_p, state, fcn = month_against_dense(
            state_cls, phosphorus.phosphorus, device, "phosphorus 30x30", hist)
        years["phosphorus 30x30 month"] = [year_p]
        precond = os.path.join(phos_dir, "precond.nc")
        state.gen_precond_jacobian(hist, precond, solver_state=None)
        before = banded_cuda.launch_counts()
        (res, precond_ms) = timed(lambda: fcn.apply_precond_jacobian(
            precond, os.path.join(phos_dir, "precond_res.nc"), solver_state=None))
        eigen_launches = [a - b for a, b in zip(banded_cuda.launch_counts(), before)]
        solution = (res.tracer_modules[0].get_tracer_vals_all()
                    + fcn.tracer_modules[0].get_tracer_vals_all())
        weight = np.outer(state.depth.delta, state.ypos.delta)
        total = float((weight * solution).sum())
        scale = float((weight * np.abs(solution)).sum())
        null_file = os.path.exists(os.path.join(phos_dir, "precond_null_space.nc"))
        phase(17, "phosphorus 30x30 preconditioner", seconds=round(precond_ms / 1e3, 3),
              factor_launches=eigen_launches[0], solve_launches=eigen_launches[1],
              total_p_rel=abs(total) / scale, tol=PD2D_CONSERVE_TOL,
              null_space_file=null_file)
        if not (null_file and abs(total) <= PD2D_CONSERVE_TOL * scale
                and min(eigen_launches) > 0
                and np.isfinite(solution).all()):
            raise SystemExit("chip_smoke: the phosphorus preconditioner failed "
                             "its checks")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    devices = {y["device"] for ys in years.values() for y in ys}
    if devices != {str(compute.resolve_device(device))}:
        raise SystemExit(f"chip_smoke: py_driver_2d years ran on {sorted(devices)}")
    for label, ys in years.items():
        if not ys or min(int(y["lu_launches"]) for y in ys) == 0:
            raise SystemExit(f"chip_smoke: a {label} Radau year ran without "
                             "banded-kernel launches")
        earlier = {}
        if label in PD2D_EARLIER_COUNTS:
            earlier = dict(zip(("earlier_attempts_a_year", "earlier_nlu_a_year"),
                               PD2D_EARLIER_COUNTS[label]))
        phase(17, f"radau years {label}", **year_stats(ys), **earlier)
    launches = sum(banded_cuda.launch_counts())
    entry = banded_kernel_timings(device)
    phase(17, "py_driver_2d file-backed (float64, banded Radau on the card)",
          banded_lu_launches=launches, seconds=round(time.perf_counter() - start, 1))
    return launches, entry


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="drive the port's paths through its CUDA kernels on one card")
    parser.add_argument("--phases", type=int, nargs="+", choices=range(18),
                        default=list(range(18)),
                        help="phases to run (0 and 1 always run); the JSON "
                             "lines need them all")
    phases = set(parser.parse_args(argv).phases) | {0, 1}
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
            if any(key in line for key in ("Function properties",
                                           "registers", "spill", "smem")):
                print(f"    ptxas: {line.strip()}", flush=True)

    depth, ypos = incore_spinup.build_axes(NZ, NY)
    runs = {
        # 2, 3: the iage kernel, then the iage spin-up
        2: lambda: iage_kernel_phase(depth, ypos, device),
        3: lambda: iage_solve_phase(depth, ypos, device),
        # 4, 5: the phosphorus kernel, then the phosphorus spin-up
        4: lambda: phosphorus_kernel_phase(depth, ypos, device),
        5: lambda: phosphorus_solve_phase(depth, ypos, device),
        # 6, 7: the 3D transport kernel, then the gx3 spin-up
        6: lambda: transport3d_kernel_phase(device),
        7: lambda: transport3d_solve_phase(device),
        # 8: the streaming 3D year at gx1
        8: lambda: stream_kernel_phase(device),
        # 9, 10: the step block kernel, then the sharded spin-up
        9: lambda: iage_block_phase(device),
        10: lambda: sharded_solve_phase(device),
        # 11, 12: the sweep kernel at gx1, then the sharded 3D spin-up
        11: lambda: sweep_kernel_phase(device),
        12: lambda: irf3d_sharded_solve_phase(device),
        # 13: the block kernel in the blocked sharded 3D year
        13: lambda: block3d_kernel_phase(device),
        # 14: the iage year's PCR variant
        14: lambda: iage_v1_phase(depth, ypos, device),
        # 15: the dense year operator probed through the iage kernel
        15: lambda: year_operator_phase(device),
        # 16: the file-backed test_problem path (no kernel of its own)
        16: lambda: file_backed_phase("cuda"),
        # 17: py_driver_2d's file-backed path through the banded LU kernel
        17: lambda: py_driver_2d_phase("cuda"),
    }
    results, seconds = {}, {}
    for num, run in runs.items():
        if num in phases:
            start = time.perf_counter()
            results[num] = run()
            seconds[num] = round(time.perf_counter() - start, 1)
    print(f"chip_smoke seconds by phase: {json.dumps(seconds)}", flush=True)
    if phases != set(range(18)):
        print(f"chip_smoke: phases {sorted(phases)} passed; the JSON lines "
              "need every phase", flush=True)
        return 0

    (worst_abs, iage_ms, iage_plain_ms), table = results[2]
    table_abs, table_ms, table_plain_ms = table
    launches, table_launches = results[3]
    phos_abs, phos_ms, phos_plain_ms = results[4]
    phos_launches = results[5]
    t3d_abs, t3d_ms, t3d_plain_ms, t3d_bound, t3d_by = results[6]
    t3d_launches = results[7]
    (stream_launches, stream_abs, stream_ms, stream_plain_ms, stream_bound_ms,
     stream_by) = results[8]
    block_abs, block_ms, block_plain_ms, block_bound_ms, block_by = results[9]
    block_launches = results[10]
    (sweep_launches, sweep_abs, sweep_ms, sweep_plain_ms, sweep_bound_ms,
     sweep_by) = results[11]
    (b7_launches, b7_abs, b7_ms, b7_plain_ms, b7_bound_ms,
     b7_by) = results[13]
    v1_launches, v1_abs, v1_ms, v1_plain_ms = results[14]
    lu_launches, (lu_abs, lu_ms, lu_plain_ms, lu_bound_ms, lu_by,
                  lu_library_ms) = results[17]

    # no single PyTorch call computes an IMEX year or its table: library_ms
    # is null
    # B1's and B2's times are over the first tenth of the year
    iage_bound_ms, iage_by = iage_bound(2, NZ, NY, CHECK_STEPS)
    table_bound_ms, table_by = table_bound(2, NZ, NY, CHECK_STEPS)
    phos_bound_ms, phos_by = phosphorus_bound(NZ, NY, CHECK_STEPS)
    print(json.dumps({"kernels": [{
        "name": "iage_year",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:267",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": iage_ms,
        "plain_ms": iage_plain_ms,
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
    }, {
        "name": "transport3d_stream",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/transport3d_stream.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py:805",
        "launches": stream_launches,
        "max_abs_err": stream_abs,
        "ms": stream_ms,
        "plain_ms": stream_plain_ms,
        "bound_ms": stream_bound_ms,
        "bound_by": stream_by,
        "library_ms": None,
    }, {
        "name": "iage_block",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_block.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:687",
        "launches": block_launches,
        "max_abs_err": block_abs,
        "ms": block_ms,
        "plain_ms": block_plain_ms,
        "bound_ms": block_bound_ms,
        "bound_by": block_by,
        "library_ms": None,
    }, {
        "name": "transport3d_sweep",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/transport3d_sweep.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py:393",
        "launches": sweep_launches,
        "max_abs_err": sweep_abs,
        "ms": sweep_ms,
        "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": sweep_by,
        "library_ms": None,
    }, {
        "name": "transport3d_block",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/transport3d_block.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/transport3d_block_pallas.py:71",
        "launches": b7_launches,
        "max_abs_err": b7_abs,
        "ms": b7_ms,
        "plain_ms": b7_plain_ms,
        "bound_ms": b7_bound_ms,
        "bound_by": b7_by,
        "library_ms": None,
    }, {
        "name": "iage_year_v1",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:96",
        "launches": v1_launches,
        "max_abs_err": v1_abs,
        "ms": v1_ms,
        "plain_ms": v1_plain_ms,
        "bound_ms": iage_bound_ms,
        "bound_by": iage_by,
        "library_ms": None,
    }, {
        "name": "iage_table",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/iage_year.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/imex_pallas.py:267",
        "launches": table_launches,
        "max_abs_err": table_abs,
        "ms": table_ms,
        "plain_ms": table_plain_ms,
        "bound_ms": table_bound_ms,
        "bound_by": table_by,
        "library_ms": None,
    }, {
        # a lax.scan on the path, not a Pallas call; its unit of work is a
        # refactored Radau stage: the complex factor and one solve at
        # ci_py_driver_2d_iage's 2 x 900 x 61
        "name": "banded_lu",
        "route": "cuda",
        "source": "newton_krylov_ooc_tpu_torch/csrc/banded_lu.cu",
        "replaces": "newton_krylov_ooc_tpu/ops/banded.py:42",
        "launches": lu_launches,
        "max_abs_err": lu_abs,
        "ms": lu_ms,
        "plain_ms": lu_plain_ms,
        "bound_ms": lu_bound_ms,
        "bound_by": lu_by,
        "library_ms": lu_library_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
