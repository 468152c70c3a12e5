"""where a step of B1, B1v1, B3 and B4 goes, phase by phase, on the card.

Each kernel runs a year (or its interior) as one launch, so a profiler sees
one kernel and no passes.  This script builds copies of the kernels'
sources with clock marks in the first block, runs the port's own wrappers
on those copies, and prints, as JSON lines, each phase's SM cycles a step:
  * B1 and B1v1 (iage_year): chip_smoke.py's phase 2 year (40 x 50, T = 2,
    8760 steps) on three inputs -- the F route from the solver's initial
    iterate, the JVP route (source zeroed) from seeded normal noise, and the
    F route from seeded uniform noise, which tells whether a gap between
    the first two follows the source or the data.  Every warp stamps
    clock() where it ends a phase; after each block barrier warp 0 takes
    each phase's latest stamp, so a phase runs from the previous phase's
    latest stamp to its own, and a barrier from the latest arrival to the
    release.  These marks add no barrier but cost some 200 cycles each: the
    unmarked year's ms on each input is printed beside the marked one's.  Either design of csrc/iage_year.cu is
    recognised (B1_DESIGNS): to profile the parent's, unpack the parent
    tree into build/parent (git archive), copy this file into it and run
    it there with --kernels B1 B1v1;
  * B4 (transport3d_year): the gx3 year of cli/irf3d_spinup.py's settings
    (60 x 116 x 100, T = 2, 2000 steps), and 200 steps at gx1 (60 x 384 x
    320, T = 1, tiles walked) -- stage (1): staging the state, f1, the grid
    sync; stage (2): staging the stage state, f2 and the Heun add, the CN
    solve, publishing y, the grid sync;
  * B3 (iage_block): the bench's million-cell year (256 x 2000, 12,615
    steps, blocks of 8) and a spin-up year at the sharded example's
    defaults (4 modules, 24 x 48, 2920 steps) on 1 and 4 shards of the
    card -- the halo loads of an interval, the two explicit stages, the CN
    solve, publishing the tile's edges, the grid sync (with the wait for the
    slowest block), each a step.
In B3 and B4 each mark first waits for the block at a __syncthreads and
adds a clock64() difference; those barriers cost a little.  The year's wall
time is printed beside each profile.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_phases \
        [--kernels B1 B1v1 B3 B4]

Needs a CUDA card and nvcc; the copies go to build/phase_probe/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models.irf_offline import synthetic
from ..models.py_driver_2d import phosphorus, physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
from ..models.py_driver_2d.incore import IageKernel, PhosphorusKernel
from ..ops import imex_block_cuda, imex_cuda, transport3d_cuda
from ..ops.compute import resolve_device
from ..parallel.mesh import make_mesh
from ..parallel.sharded_transport3d import family_year_inputs
from ..parallel.sharded_year import build_sharded_year_blocked
from .incore_spinup import MODELINFO, build_axes
from .irf3d_spinup import GX3, GX3_SPECS

PROBE_DIR = imex_cuda.BUILD_DIR.parent / "phase_probe"
MARK = """
__device__ unsigned long long g_phase[16];
#define MARK(i) do { if (blockIdx.x == 0) { __syncthreads(); \\
  if (threadIdx.x == 0) { unsigned long long now = clock64(); \\
  g_phase[i] += now - t_mark; t_mark = now; } } } while (0)
"""
READ = """
extern "C" int %s_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[16] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return (int)err;
}
"""
B4_PHASES = ("stage_y", "f1", "sync_1", "stage_ys", "f2_heun", "cn",
             "publish", "sync_2")
B3_PHASES = ("halo", "stage_1", "stage_2", "cn", "publish", "sync")
KERNELS = ("B1", "B1v1", "B2", "B3", "B4")
B1_SHAPE, B1_STEPS = (40, 50), 8760

# B1's and B1v1's marks: STAMP(i) where a warp ends phase i; LEAVE(i, j)
# right after a block barrier, in warp 0: phases i..j from their latest
# stamps, and phase j + 1, the barrier, from the latest arrival to now
STAMPS = """
__device__ unsigned long long g_phase[16];
__shared__ unsigned s_stamp[16][32];
__shared__ unsigned s_tmark;
#define PROBE_START do { if (blockIdx.x == 0 && threadIdx.x == 0) \\
  s_tmark = (unsigned)clock(); } while (0)
#define STAMP(i) do { if (blockIdx.x == 0) { __syncwarp(); \\
  if ((threadIdx.x & 31) == 0) s_stamp[i][threadIdx.x >> 5] = \\
  (unsigned)clock(); } } while (0)
#define LEAVE(first, last) do { if (blockIdx.x == 0 && threadIdx.x < 32) { \\
  unsigned now_ = __shfl_sync(0xffffffffu, (unsigned)clock(), 0); \\
  unsigned prev_ = s_tmark; \\
  for (int s_ = first; s_ <= last; ++s_) { \\
    int d_ = threadIdx.x < (blockDim.x >> 5) \\
        ? max(0, (int)(s_stamp[s_][threadIdx.x] - prev_)) : 0; \\
    d_ = __reduce_max_sync(0xffffffffu, d_); \\
    if (threadIdx.x == 0) g_phase[s_] += (unsigned)d_; \\
    prev_ += (unsigned)d_; } \\
  if (threadIdx.x == 0) { g_phase[last + 1] += now_ - prev_; \\
    s_tmark = now_; } \\
  __syncwarp(); } } while (0)
"""
# each design of csrc/iage_year.cu: a line only it has, then the marks as
# (anchor, code before it, code after it), each anchor found after the
# previous one, from the start anchor on; and its phases' labels
B1_DESIGNS = {
    "three barriers a step": {
        "has": "cn_phase_pcr(y, comp, pcr, kv, diag, h_cn, nz, ny, g);",
        "start": "__device__ inline void cn_phase_pcr(",
        "marks": [
            ("__syncthreads();", "STAMP(7); ", " LEAVE(7, 7);"),
            ("__syncthreads();\n    p ^= 1;", "STAMP(9); ", " LEAVE(9, 9);"),
            ("extern __shared__ float smem[];", None, " PROBE_START;"),
            ("for (int step = 0; step < n_steps; ++step) {", "PROBE_START; ",
             None),
            ("kv_phase(kv, t + dt, nz, ny, h, g);", "STAMP(0); ",
             " STAMP(1);"),
            ("__syncthreads();", None, " LEAVE(0, 1);"),
            ("__syncthreads();", "STAMP(3); ", " LEAVE(3, 3);"),
            ("__syncthreads();", "STAMP(5); ", " LEAVE(5, 5);"),
        ],
        "labels": ("heun_1", "kv", "barrier_1", "heun_2_kahan", "barrier_2",
                   "cn", "barrier_3", "pcr_setup", "pcr_setup_barrier",
                   "pcr_rounds", "pcr_round_barriers"),
    },
    # cn_setup: B1's r' = rhs w, B1v1's a, b, c, r; cn_solve: B1's scan
    # chain, B1v1's PCR rounds and x = r / b; cn_add: the Kahan add and y's
    # publication
    "the table and two barriers a step": {
        "has": "cn_setup<M, kPcr>(",
        "start": "extern __shared__ __align__(16) float smem[];",
        "marks": [
            ("extern __shared__ __align__(16) float smem[];", None,
             " PROBE_START;"),
            ("for (int step = 0; step < n_steps; ++step) {", "PROBE_START; ",
             None),
            ("__syncthreads();", "STAMP(0); ", " LEAVE(0, 0);"),
            ("    // CN solve s = step + 1", "    STAMP(2);\n", None),
            ("slot_wait(&slot_bar[s & 1], (s >> 1) & 1);", None, " STAMP(3);"),
            ("b, c, lane, lanes, k0, jc, nz, ny);", None, " STAMP(4);"),
            ("cn_solve<M, kPcr>(slot, v, a, b, c, lane, lanes, k0, jc, nz,"
             " ny);", None, " STAMP(5);"),
            ("__syncthreads();", "STAMP(6); ", " LEAVE(2, 6);"),
        ],
        "labels": ("heun_1", "barrier_1", "heun_2_kahan", "table_wait",
                   "cn_setup", "cn_solve", "cn_add", "barrier_2"),
    },
}

# each design of csrc/phosphorus_year.cu, as B1_DESIGNS
B2_DESIGNS = {
    "three barriers a step": {
        "has": "cn_phase(y, comp, f1, ys, kv, step == n_steps - 1 ? half_dt",
        "start": "extern __shared__ float smem[];",
        "marks": [
            ("extern __shared__ float smem[];", None, " PROBE_START;"),
            ("for (int step = 0; step < n_steps; ++step) {", "PROBE_START; ",
             None),
            ("kv_phase(kv, t + dt, nz, ny, h, g);", "STAMP(0); ",
             " STAMP(1);"),
            ("__syncthreads();", None, " LEAVE(0, 1);"),
            ("__syncthreads();", "STAMP(3); ", " LEAVE(3, 3);"),
            ("__syncthreads();", "STAMP(5); ", " LEAVE(5, 5);"),
        ],
        "labels": ("heun_1", "kv", "barrier_1", "heun_2_kahan", "barrier_2",
                   "cn", "barrier_3"),
    },
    # B1's skeleton on a cluster of blocks, each barrier split: the column
    # terms of a Heun stage (heun_*_column) run between arriving and
    # waiting, the lateral terms after; cn_rhs r' = rhs w of the three
    # tracers, cn_chain the scans, cn_add the Kahan add and y's
    # publication; block 0 marked
    "the table and two split barriers a step": {
        "has": "lateral_terms(ys_sh, st, f2, k0, jw, je, nz, ny);",
        "start": "extern __shared__ __align__(16) float smem[];",
        "marks": [
            ("extern __shared__ __align__(16) float smem[];", None,
             " PROBE_START;"),
            ("for (int step = 0; step < n_steps; ++step) {", "PROBE_START; ",
             None),
            ("    cluster_arrive();", "    STAMP(0);\n", None),
            ("    cluster_wait();", "    STAMP(1);\n", "\n    LEAVE(0, 1);"),
            ("    // CN solve s = step + 1", "    STAMP(3);\n", None),
            ("slot_wait(&slot_bar[s & 1], (s >> 1) & 1);", None, " STAMP(4);"),
            ("jc, nz, ny);", None, " STAMP(5);"),
            ("cn_chain(slot, v, lane, lanes, k0, jc, nz, ny);", None,
             " STAMP(6);"),
            ("    cluster_arrive();", "    STAMP(7);\n", None),
            ("    cluster_wait();", "    STAMP(8);\n", "\n    LEAVE(3, 8);"),
        ],
        "labels": ("heun_1_lateral", "heun_2_column", "barrier_1",
                   "heun_2_lateral_kahan", "table_wait", "cn_rhs", "cn_chain",
                   "cn_add", "heun_1_column", "barrier_2"),
    },
}


# the tree's B2 with a line or two changed, to time what it was chosen over
# (--b2-variants): the same step on a cluster of two blocks of at most 448
# threads (128 registers a thread) and on one block of 864 (72); the uptake
# in the plain year's order, mu L po4 / (po4 + K), whose zero and subnormal
# numerators in the deep levels take the division's slow path
B2_VARIANTS = {
    "two blocks": (("constexpr int kCtas = 4;", "constexpr int kCtas = 2;"),
                   ("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 448;")),
    "one block": (("constexpr int kCtas = 4;", "constexpr int kCtas = 1;"),
                  ("constexpr int kThreads = 256;",
                   "constexpr int kThreads = 864;")),
    "uptake in the plain order": (
        ("    const float num = k < nz ? po4 : 1.0f;\n"
         "    const float uptake = uc[m] * (num / (num + p.halfsat));",
         "    const float uptake = uc[m] * po4 / (po4 + p.halfsat);"),),
}


def _marked(text, start, ends, grid_anchor):
    """text with MARK(i) after each of `ends`, found in order after
    `start`, a start mark after `grid_anchor`, and MARK's definitions"""
    pos = text.index(start)
    for num, end in enumerate(ends):
        if end is None:
            continue
        pos = text.index(end, pos) + len(end)
        text = text[:pos] + f" MARK({num});" + text[pos:]
    text = text.replace(grid_anchor, grid_anchor
                        + "\n  unsigned long long t_mark = clock64();", 1)
    return text.replace('#include "', MARK + '#include "', 1)


def _edited(text, start, marks):
    """text with each mark's code inserted before and after its anchor,
    each anchor found after the previous one, from `start` on"""
    pos = text.index(start)
    for anchor, before, after in marks:
        at = text.index(anchor, pos)
        end = at + len(anchor)
        text = (text[:at] + (before or "") + anchor + (after or "")
                + text[end:])
        pos = end + len(before or "") + len(after or "")
    return text


def source_design(source, designs):
    """(name, spec) of the entry of `designs` that csrc/<source>'s text
    is"""
    text = (imex_cuda.CSRC / source).read_text()
    found = [(name, spec) for name, spec in designs.items()
             if spec["has"] in text]
    if len(found) != 1:
        raise RuntimeError(f"csrc/{source} matches no single design")
    return found[0]


def _stamped_probe(library, designs):
    """csrc/<library>.cu with its design's stamps, and the counters' reader"""
    text = (imex_cuda.CSRC / f"{library}.cu").read_text()
    _, spec = source_design(f"{library}.cu", designs)
    text = _edited(text, spec["start"], spec["marks"])
    text = text.replace('#include "', STAMPS + '#include "', 1)
    return text + READ % library


def _probe_sources(kernels):
    """the instrumented copies' text by library name"""
    csrc = imex_cuda.CSRC
    out = {}
    if {"B1", "B1v1"} & set(kernels):
        out["iage_year"] = _stamped_probe("iage_year", B1_DESIGNS)
    if "B2" in kernels:
        out["phosphorus_year"] = _stamped_probe("phosphorus_year", B2_DESIGNS)
    if "B4" not in kernels and "B3" not in kernels:
        return out
    b4 = _marked(
        (csrc / "transport3d_year.cu").read_text(),
        "for (int step = 0; step < a.n_steps; ++step) {",
        ["__syncthreads();", "__syncthreads();", "grid.sync();",
         "__syncthreads();", "__syncthreads();", "__syncthreads();",
         "if (kResident) publish(j0, i0, th, tw);", "grid.sync();"],
        "cg::grid_group grid = cg::this_grid();")
    b3 = _marked(
        (csrc / "iage_block.cu").read_text(),
        "for (int it = 0; it < n_int; ++it) {",
        ["__syncthreads();", "__syncthreads();", "__syncthreads();",
         "__syncthreads();"],
        "cg::grid_group grid = cg::this_grid();")
    b3 = b3.replace("    if (!last) grid.sync();",
                    "    MARK(4);\n    if (!last) grid.sync();\n    MARK(5);", 1)
    if "B4" in kernels:
        out["transport3d_year"] = b4 + READ % "transport3d_year"
    if "B3" in kernels:
        out["iage_block"] = b3 + READ % "iage_block"
    return out


def _compile(sources):
    """compile {stem: text} into PROBE_DIR (one nvcc each, together),
    printing each one's ptxas registers and spills; returns {stem: path of
    the .so}"""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, text in sources.items():
        src = PROBE_DIR / f"{stem}.cu"
        src.write_text(text)
        lib = PROBE_DIR / f"{stem}.so"
        procs[stem] = (lib, subprocess.Popen(
            [imex_cuda._nvcc(), *imex_cuda.NVCC_FLAGS, "-I",
             str(imex_cuda.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for stem, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {stem} probe:\n{err}")
        ptxas = [line.strip() for line in (out + err).splitlines()
                 if any(key in line for key in ("Function properties",
                                                "registers", "spill"))]
        print(json.dumps({"probe": stem, "ptxas": ptxas}), flush=True)
    return {stem: lib for stem, (lib, _) in procs.items()}


def build_probes(kernels=KERNELS):
    """compile the instrumented copies; returns {library name: path of the
    .so}"""
    return _compile(_probe_sources(kernels))


def build_b2_variants(variants):
    """compile each of B2_VARIANTS named, unmarked; returns {variant: .so}"""
    plain = (imex_cuda.CSRC / "phosphorus_year.cu").read_text()
    reader = "__device__ unsigned long long g_phase[16];\n"
    sources = {}
    for num, name in enumerate(variants):
        text = reader + plain + READ % "phosphorus_year"
        for old, new in B2_VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"B2 variant {name!r}: {old!r} is not in "
                                   "csrc/phosphorus_year.cu")
            text = text.replace(old, new, 1)
        sources[f"b2_variant{num}"] = text
    paths = _compile(sources)
    return {name: paths[f"b2_variant{num}"]
            for num, name in enumerate(variants)}


def _use_probes(paths):
    """point the wrappers of B1, B2, B3 and B4 at the libraries in `paths`
    ({library name: .so}, read at each load)"""
    def load(name, signatures):
        if name not in paths:
            return plain_load(name, signatures)
        lib = ctypes.CDLL(str(paths[name]))
        signatures = {**signatures,
                      "error_string": ([ctypes.c_int], ctypes.c_char_p),
                      "phases": ([ctypes.c_void_p], ctypes.c_int)}
        for suffix, (argtypes, restype) in signatures.items():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes, restype
        return lib
    plain_load = imex_cuda.load_library
    imex_block_cuda.load_library = load
    transport3d_cuda.load_library = load
    imex_cuda.load_library = load


def _phases(lib, name, labels, steps):
    counts = (ctypes.c_ulonglong * 16)()
    err = getattr(lib, f"{name}_phases")(counts)
    if err:
        raise RuntimeError(f"reading {name}'s phase counters: CUDA error {err}")
    return {label: counts[num] / steps for num, label in enumerate(labels)}


def _run(year, y0):
    """wall ms of one synchronised call, after a warm-up call"""
    year(y0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    year(y0)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def _b1_years(kernels, device):
    """{(kernel, route): (year, y0)}: chip_smoke.py phase 2's F and JVP
    years, and the F year from seeded uniform noise"""
    if not kernels:
        return {}
    nz, ny = B1_SHAPE
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=device,
                             dtype=torch.float32)
    kernel = IageKernel(depth, ypos, MODELINFO, device=device,
                        n_steps=B1_STEPS)
    rng = np.random.default_rng(0)
    aging = np.full((2, 1, 1), 1.0 / physics.SEC_PER_YEAR)
    inputs = {
        "F": (aging, kernel.init_iterate()),
        "JVP": (np.zeros((2, 1, 1)), rng.standard_normal((2, nz, ny))),
        "F from noise": (aging, rng.uniform(0.0, 2.0, (2, nz, ny))),
    }
    builders = {"B1": imex_cuda.build_iage_year,
                "B1v1": imex_cuda.build_iage_year_v1}
    span = (0.0, physics.SEC_PER_YEAR)
    return {
        (name, route): (
            builders[name](grid, kernel._vert_diag, source, span, B1_STEPS,
                           device=device),
            torch.as_tensor(y0, dtype=torch.float32, device=device))
        for name in kernels for route, (source, y0) in inputs.items()
    }


def profile_b1(kernels, unmarked, device, card):
    """B1's and B1v1's phases on each route, beside the unmarked ms"""
    design, spec = source_design("iage_year.cu", B1_DESIGNS)
    lib = imex_cuda._library("iage_year")
    for (name, route), (year, y0) in _b1_years(kernels, device).items():
        year(y0)
        torch.cuda.synchronize()
        _phases(lib, "iage_year", spec["labels"], 1)  # reset
        ms = _run(year, y0)
        phases = _phases(lib, "iage_year", spec["labels"], 2 * B1_STEPS)
        total = sum(phases.values())
        print(json.dumps({"kernel": name, "design": design, "route": route,
                          "year": f"{B1_SHAPE[0]}x{B1_SHAPE[1]}, T = 2, "
                                  f"{B1_STEPS} steps",
                          "ms_unmarked": unmarked[name, route],
                          "ms_marked": ms, "cycles_per_step": phases,
                          "total_cycles_per_step": total,
                          "sm_mhz_implied": total / (1e3 * ms / B1_STEPS),
                          "card": card}), flush=True)


def _b2_years(device):
    """{input: (year, y0)}: chip_smoke.py phase 4's year (40 x 50, 8760
    steps) from the solver's initial iterate and from seeded uniform
    noise, which tells whether a gap follows the data"""
    nz, ny = B1_SHAPE
    depth, ypos = build_axes(nz, ny)
    grid = physics.make_grid(depth, ypos, MODELINFO, device=device,
                             dtype=torch.float32)
    light = phosphorus.light_lim_2d(depth, ypos, device=device,
                                    dtype=torch.float32)
    year = imex_cuda.build_phosphorus_year(
        grid, phosphorus.DEFAULT_PARAMS, light, (0.0, physics.SEC_PER_YEAR),
        B1_STEPS, device=device)
    init = PhosphorusKernel(depth, ypos, MODELINFO, device="cpu",
                            n_steps=B1_STEPS).init_iterate()
    noise = np.random.default_rng(0).uniform(0.0, 2.0, (3, nz, ny))
    return {label: (year, torch.as_tensor(np.asarray(y0), dtype=torch.float32,
                                          device=device))
            for label, y0 in (("init_iterate", init), ("noise", noise))}


def profile_b2(unmarked, device, card):
    """B2's phases from each input, beside the unmarked ms"""
    design, spec = source_design("phosphorus_year.cu", B2_DESIGNS)
    lib = imex_cuda._library("phosphorus_year")
    for label, (year, y0) in _b2_years(device).items():
        year(y0)
        torch.cuda.synchronize()
        _phases(lib, "phosphorus_year", spec["labels"], 1)  # reset
        ms = _run(year, y0)
        phases = _phases(lib, "phosphorus_year", spec["labels"],
                         2 * B1_STEPS)
        total = sum(phases.values())
        print(json.dumps({"kernel": "B2", "design": design, "input": label,
                          "year": f"{B1_SHAPE[0]}x{B1_SHAPE[1]}, "
                                  f"{B1_STEPS} steps",
                          "ms_unmarked": unmarked[label], "ms_marked": ms,
                          "cycles_per_step": phases,
                          "total_cycles_per_step": total,
                          "sm_mhz_implied": total / (1e3 * ms / B1_STEPS),
                          "card": card}), flush=True)


def profile_b2_variants(variants, paths, device, card):
    """the unmarked ms of each of B2_VARIANTS named, from each input"""
    for name, lib in build_b2_variants(variants).items():
        paths["phosphorus_year"] = lib
        ms = {label: _run(year, y0)
              for label, (year, y0) in _b2_years(device).items()}
        print(json.dumps({"kernel": "B2", "variant": name,
                          "year": f"{B1_SHAPE[0]}x{B1_SHAPE[1]}, "
                                  f"{B1_STEPS} steps",
                          "ms_unmarked": ms, "card": card}), flush=True)


def profile_b4(device, card):
    span = (0.0, transport3d_cuda.SEC_PER_YEAR)
    for label, shape, specs, n_steps in (("gx3", GX3, GX3_SPECS, 2000),
                                         ("gx1", (60, 384, 320),
                                          [[{"name": "T"}]], 200)):
        circ = synthetic.gen_circulation(*shape)
        coef, kv, dz_r, diag, src, couple = family_year_inputs(circ, specs)
        year = transport3d_cuda.build_transport3d_year(
            coef, kv, dz_r, diag, src, span, n_steps, couple, device=device)
        y0 = torch.as_tensor(np.random.default_rng(0).uniform(
            0.0, 1.0, (diag.shape[0],) + shape), dtype=torch.float32,
            device=device)
        lib = transport3d_cuda._library()
        year(y0)
        torch.cuda.synchronize()
        _phases(lib, "transport3d_year", B4_PHASES, 1)  # reset
        ms = _run(year, y0)
        phases = _phases(lib, "transport3d_year", B4_PHASES, 2 * n_steps)
        print(json.dumps({"kernel": "B4", "year": f"{label} {n_steps} steps",
                          "plan": list(year.plan), "ms": ms,
                          "cycles_per_step": phases,
                          "total_cycles_per_step": sum(phases.values()),
                          "card": card}), flush=True)


def profile_b3(device, card):
    for label, (nz, ny, modules, n_steps, k, shards) in (
            ("million-cell", (256, 2000, 1, 12615, 8, 1)),
            ("spin-up (1, 1)", (24, 48, 4, 2920, 8, 1)),
            ("spin-up (1, 4) on one card", (24, 48, 4, 2920, 4, 4))):
        depth, ypos = build_axes(nz, ny)
        rate = surf_restore_rate(depth)
        diag = np.zeros((modules, 2, nz, ny), np.float32)
        diag[:, 0, 0, :] = -rate
        diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
        aging = np.full((modules, 2), 1.0 / physics.SEC_PER_YEAR, np.float32)
        year = build_sharded_year_blocked(
            make_mesh(1, shards, devices=[device] * shards), depth, ypos,
            MODELINFO, diag, aging, (0.0, physics.SEC_PER_YEAR), n_steps,
            block_steps=k)
        y0 = torch.full((modules, 2, nz, ny), 0.5, dtype=torch.float32,
                        device=device)
        lib = imex_block_cuda._library()
        year(y0)
        torch.cuda.synchronize()
        _phases(lib, "iage_block", B3_PHASES, 1)  # reset
        ms = _run(year, y0)
        phases = _phases(lib, "iage_block", B3_PHASES, 2 * (n_steps - 1))
        print(json.dumps({"kernel": "B3", "year": label, "ms": ms,
                          "cycles_per_step": phases,
                          "total_cycles_per_step": sum(phases.values()),
                          "card": card}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SM cycles a step by phase of B1, B1v1, B2, B3 and B4")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS,
                        default=list(KERNELS))
    parser.add_argument("--b2-variants", nargs="+", choices=B2_VARIANTS,
                        default=[], help="also profile these variants of "
                        "B2's design (with B2)")
    args = parser.parse_args(argv)
    kernels = args.kernels
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    b1 = [name for name in ("B1", "B1v1") if name in kernels]
    unmarked = {key: _run(year, y0)
                for key, (year, y0) in _b1_years(b1, device).items()}
    unmarked_b2 = ({label: _run(year, y0)
                    for label, (year, y0) in _b2_years(device).items()}
                   if "B2" in kernels else {})
    paths = build_probes(kernels)
    _use_probes(paths)
    if b1:
        profile_b1(b1, unmarked, device, card)
    if "B2" in kernels:
        profile_b2(unmarked_b2, device, card)
        profile_b2_variants(args.b2_variants, paths, device, card)
    if "B4" in kernels:
        profile_b4(device, card)
    if "B3" in kernels:
        profile_b3(device, card)


if __name__ == "__main__":
    main()
