"""where a step of B3 and of B4 goes, phase by phase, on the card.

Both kernels run a year (or its interior) as one cooperative launch, so a
profiler sees one kernel and no passes.  This script builds copies of
csrc/iage_block.cu and csrc/transport3d_year.cu in which the first block
adds clock64() differences into a device array at each of its phase ends
(each mark first waits for the block at a __syncthreads), runs the port's
own wrappers on those copies, and prints, as JSON lines, each phase's SM
cycles a step:
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
The marks' barriers cost a little; the year's wall time is printed beside.

    python -m newton_krylov_ooc_tpu_torch.cli.profile_phases

Needs a CUDA card and nvcc; the copies go to build/phase_probe/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models.irf_offline import synthetic
from ..models.py_driver_2d import physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
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


def _probe_sources():
    """the instrumented copies' text by kernel name"""
    csrc = imex_cuda.CSRC
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
    return {"transport3d_year": b4 + READ % "transport3d_year",
            "iage_block": b3 + READ % "iage_block"}


def build_probes():
    """compile the instrumented copies (one nvcc each, together); returns
    {name: path of the .so}"""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in _probe_sources().items():
        src = PROBE_DIR / f"{name}.cu"
        src.write_text(text)
        lib = PROBE_DIR / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [imex_cuda._nvcc(), *imex_cuda.NVCC_FLAGS, "-I",
             str(imex_cuda.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} probe:\n{err}")
    return {name: lib for name, (lib, _) in procs.items()}


def _use_probes(paths):
    """point the wrappers of B3 and B4 at the probes' libraries"""
    def load(name, signatures):
        lib = ctypes.CDLL(str(paths[name]))
        signatures = {**signatures,
                      "error_string": ([ctypes.c_int], ctypes.c_char_p),
                      "phases": ([ctypes.c_void_p], ctypes.c_int)}
        for suffix, (argtypes, restype) in signatures.items():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes, restype
        return lib
    imex_block_cuda.load_library = load
    transport3d_cuda.load_library = load


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


def main():
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _use_probes(build_probes())
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


if __name__ == "__main__":
    main()
