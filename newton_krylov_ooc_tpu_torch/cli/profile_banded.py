"""where a banded_lu pivot and a solve's row step go, in SM cycles, on the card.

banded_lu (csrc/banded_lu.cu) factors a matrix as one chain of m pivots in
one block, and solves a right-hand side as two chains of m rows in one
warp, so a profiler sees one kernel and no steps.  This script builds a copy
of the source with clock marks in the first block (build/phase_probe/),
runs the port's wrappers on it, and prints, as JSON lines, at the py_driver_2d
path's shapes (chip_smoke.py's BANDED_SHAPES) in float64 and complex128:

  * the factor's SM cycles a pivot, the mean over the block's warps, split
    into forming the multipliers (the cycles a pivot that the warps forming
    them spend before their update: the parent design's phase (A), the
    look-ahead of the next pivot's column in the current one), the update
    (the mean warp's rank-1 update, window refills and write-outs) and the
    barriers (the mean warp's wait, arrival to release);
  * a solve's SM cycles a row step, forward (L) and back (U), of the first
    right-hand side;
  * the unmarked kernels' factor and solve microseconds (medians of
    synchronised calls), the marked factor's, and the clock the marks
    imply; the pair launches' microseconds (both stage systems in one
    launch) where ops/banded_cuda.py has them.

Every warp's lane 0 reads clock64() where a phase ends; the marks add no
barrier.  Either design of csrc/banded_lu.cu is recognised (DESIGNS): to
profile the parent's, unpack the parent tree into build/parent (git
archive), copy this file into its cli/ and run it there.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_banded [--reps 20]

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import banded, banded_cuda, imex_cuda
from ..ops.compute import resolve_device
from .profile_phases import _compile, _edited

# chip_smoke.py's path shapes (blocks, rows, half-width)
SHAPES = {"iage 30x30": (2, 900, 30), "iage 40x50": (2, 2000, 40),
          "phosphorus 30x30": (1, 2700, 90)}
PROBE = """
__device__ unsigned long long g_factor_probe[32][4];
__device__ unsigned long long g_solve_probe[2];
#define PROBE_ON (blockIdx.x == 0 && (threadIdx.x & 31) == 0)
#define PROBE_DECL unsigned long long pr_t_ = 0, pr0_ = 0, pr1_ = 0, \\
  pr2_ = 0, pr3_ = 0;
#define PROBE_START if (PROBE_ON) pr_t_ = clock64();
#define PROBE_MARK(k) if (PROBE_ON) { \\
  const unsigned long long n_ = clock64(), d_ = n_ - pr_t_; \\
  const int k_ = (k); pr_t_ = n_; pr0_ += k_ == 0 ? d_ : 0; \\
  pr1_ += k_ == 1 ? d_ : 0; pr2_ += k_ == 2 ? d_ : 0; \\
  pr3_ += k_ == 3 ? d_ : 0; }
#define PROBE_FLUSH if (PROBE_ON) { \\
  unsigned long long* g_ = g_factor_probe[threadIdx.x >> 5]; \\
  g_[0] += pr0_; g_[1] += pr1_; g_[2] += pr2_; g_[3] += pr3_; }
#define SPROBE_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define SPROBE_DECL unsigned long long sp_t_ = 0;
#define SPROBE_START if (SPROBE_ON) sp_t_ = clock64();
#define SPROBE_MARK(k) if (SPROBE_ON) { \\
  const unsigned long long n_ = clock64(); g_solve_probe[k] += n_ - sp_t_; \\
  sp_t_ = n_; }
"""
READ = """
extern "C" int banded_lu_probe(unsigned long long* factor,
                               unsigned long long* solve) {
  static unsigned long long zero[32 * 4] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(factor, g_factor_probe,
                                         sizeof(g_factor_probe));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(solve, g_solve_probe, sizeof(g_solve_probe));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_factor_probe, zero, sizeof(g_factor_probe));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_solve_probe, zero, sizeof(g_solve_probe));
  return (int)err;
}
"""
# each design of csrc/banded_lu.cu: a line only it has, and the marks to
# insert as profile_phases._edited takes them (None: the source has its
# own).  Phases: 0 forming the multipliers, 1 the update, 2 and 3 barriers
DESIGNS = {
    "two barriers a pivot": {
        "has": "// (A) the multipliers of pivot p",
        "start": "template <typename T, bool kShared, int kSlots>",
        "marks": [
            ("int pm = 0;  // p mod n", "PROBE_DECL PROBE_START ", None),
            ("// (A) the multipliers of pivot p", None, None),
            ("__syncthreads();", "PROBE_MARK(0) ", " PROBE_MARK(3)"),
            ("__syncthreads();", "PROBE_MARK(1) ", " PROBE_MARK(2)"),
            ("  if (kShared) {\n    // rows m-2 and m-1", "  PROBE_FLUSH\n",
             None),
            ("  T enter[kD];", None, " SPROBE_DECL SPROBE_START"),
            ("  __syncwarp();\n\n  // back substitution", "  SPROBE_MARK(0)\n",
             None),
            ("? v[jn - 32 * kS] : zero;\n    }\n  }\n", None,
             "  SPROBE_MARK(1)\n"),
        ],
        # the warps that form the multipliers do so together
        "form": "max",
    },
    "one barrier a pivot, the next pivot's multipliers ahead": {
        "has": "the lowest column down to the warp below",
        "marks": None,
        # one warp forms them a pivot, a different one each pivot
        "form": "sum",
    },
}


def source_design():
    text = (imex_cuda.CSRC / "banded_lu.cu").read_text()
    found = [(name, spec) for name, spec in DESIGNS.items()
             if spec["has"] in text]
    if len(found) != 1:
        raise RuntimeError("csrc/banded_lu.cu matches no single design")
    return text, found[0]


def build_probe():
    """compile the marked copy; returns (design name, form rule, .so)"""
    text, (name, spec) = source_design()
    if spec["marks"] is not None:
        text = _edited(text, spec["start"], spec["marks"])
    include = "#include <cuda_runtime.h>\n"
    text = text.replace(include, include + PROBE, 1)
    lib = _compile({"banded_lu_probe": text + READ})["banded_lu_probe"]
    return name, spec["form"], lib


class Probe:
    """the wrappers' library swapped for the marked copy while `on`"""

    def __init__(self, path):
        self.path = path
        self.on = False
        self.lib = None
        self.plain_load = imex_cuda.load_library
        imex_cuda.load_library = self.load

    def load(self, name, signatures):
        if not (self.on and name == "banded_lu"):
            return self.plain_load(name, signatures)
        if self.lib is None:
            lib = ctypes.CDLL(str(self.path))
            signatures = {**signatures,
                          "error_string": ([ctypes.c_int], ctypes.c_char_p),
                          "probe": ([ctypes.c_void_p] * 2, ctypes.c_int)}
            for suffix, (argtypes, restype) in signatures.items():
                fn = getattr(lib, f"banded_lu_{suffix}")
                fn.argtypes, fn.restype = argtypes, restype
            self.lib = lib
        return self.lib

    def read(self):
        factor = (ctypes.c_ulonglong * 128)()
        solve = (ctypes.c_ulonglong * 2)()
        torch.cuda.synchronize()
        err = self.lib.banded_lu_probe(factor, solve)
        if err:
            raise RuntimeError(f"reading banded_lu's probe: CUDA error {err}")
        return np.array(factor[:], dtype=np.float64).reshape(32, 4), \
            np.array(solve[:], dtype=np.float64)


def median_us(fn, reps):
    """median microseconds of `reps` synchronised calls after one warm-up"""
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e6 * (time.perf_counter() - start))
    return statistics.median(runs)


def dominant_bands(rng, n_blocks, m, bw, dtype, device):
    """chip_smoke.py's diagonally dominant bands, zero outside the matrix"""
    vals = rng.uniform(-1.0, 1.0, (n_blocks, m, 2 * bw + 1))
    if dtype.is_complex:
        vals = vals + 1j * rng.uniform(-1.0, 1.0, vals.shape)
    rows = np.arange(m)[:, None] + np.arange(2 * bw + 1)[None, :] - bw
    vals[:, (rows < 0) | (rows >= m)] = 0.0
    vals[:, :, bw] = np.abs(vals).sum(axis=-1) + 1.0
    return torch.as_tensor(vals, dtype=dtype, device=device)


def profile_shape(label, shape, dtype, probe, form, reps, device):
    n_blocks, m, bw = shape
    rng = np.random.default_rng(17)
    bands = dominant_bands(rng, n_blocks, m, bw, dtype, device)
    rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, (n_blocks, m)), dtype=dtype,
                          device=device)
    lu = banded.banded_lu_factor_blocks(bands)
    factor_us = median_us(lambda: banded.banded_lu_factor_blocks(bands), reps)
    solve_us = median_us(lambda: banded.banded_lu_solve_blocks(lu, rhs), reps)
    warps = banded_cuda.factor_plan(dtype, bw, device)[0] // 32
    probe.on = True
    try:
        banded.banded_lu_factor_blocks(bands)
        banded.banded_lu_solve_blocks(lu, rhs)
        probe.read()  # the first calls' counts: not kept
        marked_us = median_us(lambda: banded.banded_lu_factor_blocks(bands), 1)
        probe.read()
        banded.banded_lu_factor_blocks(bands)
        factor, _ = probe.read()
        banded.banded_lu_solve_blocks(lu, rhs)
        _, solve = probe.read()
    finally:
        probe.on = False
    per = factor[:warps] / m  # cycles a pivot, by warp and phase
    total = float(per.sum(axis=1).mean())
    form_cycles = float(per[:, 0].max() if form == "max" else per[:, 0].sum())
    print(json.dumps({
        "shape": f"{label} ({n_blocks} x {m} x {2 * bw + 1})",
        "dtype": str(dtype).replace("torch.", ""),
        "factor_us": round(factor_us, 2), "solve_us": round(solve_us, 2),
        "warps": warps,
        "factor_cycles_a_pivot": round(total, 1),
        "form_multipliers": round(form_cycles, 1),
        "update": round(float(per[:, 1].mean()), 1),
        "barriers": round(float(per[:, 2:].sum(axis=1).mean()), 1),
        "solve_cycles_a_row_forward": round(float(solve[0]) / m, 1),
        "solve_cycles_a_row_back": round(float(solve[1]) / m, 1),
        "marked_factor_us": round(marked_us, 2),
        "clock_ghz": round(total * m / (1e3 * marked_us), 3),
    }), flush=True)


def profile_pairs(label, shape, reps, device):
    """the pair launches beside the two single launches they replace"""
    n_blocks, m, bw = shape
    rng = np.random.default_rng(17)
    bands_r = dominant_bands(rng, n_blocks, m, bw, torch.float64, device)
    bands_c = dominant_bands(rng, n_blocks, m, bw, torch.complex128, device)
    rhs_r = torch.as_tensor(rng.uniform(-1.0, 1.0, (n_blocks, m)),
                            dtype=torch.float64, device=device)
    rhs_c = rhs_r.to(torch.complex128) * (1 - 0.5j)
    lu_r, lu_c = banded.banded_lu_factor_pair(bands_r, bands_c)
    pair_factor = median_us(
        lambda: banded.banded_lu_factor_pair(bands_r, bands_c), reps)
    pair_solve = median_us(
        lambda: banded.banded_lu_solve_pair(lu_r, rhs_r, lu_c, rhs_c), reps)

    def singles_factor():
        banded.banded_lu_factor_blocks(bands_r)
        banded.banded_lu_factor_blocks(bands_c)

    def singles_solve():
        banded.banded_lu_solve_blocks(lu_r, rhs_r)
        banded.banded_lu_solve_blocks(lu_c, rhs_c)

    print(json.dumps({
        "pair": f"{label} ({n_blocks} x {m} x {2 * bw + 1}), float64 + "
                "complex128",
        "factor_pair_us": round(pair_factor, 2),
        "two_factors_us": round(median_us(singles_factor, reps), 2),
        "solve_pair_us": round(pair_solve, 2),
        "two_solves_us": round(median_us(singles_solve, reps), 2),
    }), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    imex_cuda.build_libraries(("banded_lu",))
    design, form, path = build_probe()
    print(json.dumps({"design": design}), flush=True)
    probe = Probe(path)
    for label, shape in SHAPES.items():
        for dtype in (torch.float64, torch.complex128):
            profile_shape(label, shape, dtype, probe, form, args.reps, device)
    if hasattr(banded, "banded_lu_factor_pair"):
        for label, shape in SHAPES.items():
            profile_pairs(label, shape, args.reps, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
