"""coloring-based Jacobian probing (Curtis-Powell-Reid).

Port of newton_krylov_ooc_tpu/ops/probing.py.  The reference packs many
impulse-response (IRF) tracers into one forward model run by graph-coloring
grid cells so that structurally-orthogonal Jacobian columns share a probe.
Here:

  * build_distance2_graph: column-intersection graph of a sparsity pattern
    (columns sharing a row are adjacent -- a distance-2 coloring of the
    bipartite column graph),
  * color_graph: the native C++ gcol library (greedy/DSatur/RLF/backtracking/
    TabuCol/PartialCol/HillClimber/HybridEA/AntCol) via ctypes, with a
    pure-python DSatur fallback when no library is built,
  * probe_jacobian: recover the sparse Jacobian from one JVP per color --
    exact when the JVP is exact, matching the reference's FD probing
    otherwise.  The JVP takes and returns tensors on the caller's device.

The library is native/gcol/gcol.cpp built as a shared object: first
build/native/libgcol.so (where chip_smoke.py builds it, git-ignored), then
native/build/libgcol.so (the JAX package's path).
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os

import numpy as np
import torch

from .compute import resolve_device

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
)
GCOL_LIB_PATHS = (
    os.path.join(_REPO_ROOT, "build", "native", "libgcol.so"),
    os.path.join(_REPO_ROOT, "native", "build", "libgcol.so"),
)


@functools.cache
def gcol_library():
    """(ctypes library, its path) of the first native gcol library found on
    GCOL_LIB_PATHS, or (None, None); loaded once a process"""
    lib_path = next((path for path in GCOL_LIB_PATHS if os.path.exists(path)),
                    None)
    if lib_path is None:
        logging.getLogger(__name__).info(
            "native gcol library not built (%s); using python fallback",
            " or ".join(GCOL_LIB_PATHS),
        )
        return None, None
    lib = ctypes.CDLL(lib_path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gcol_greedy.argtypes = [ctypes.c_int, i64p, i32p, i32p]
    lib.gcol_dsatur.argtypes = [ctypes.c_int, i64p, i32p, i32p]
    lib.gcol_backtracking_dsatur.argtypes = [
        ctypes.c_int, i64p, i32p, i32p, ctypes.c_int64,
    ]
    lib.gcol_tabucol.argtypes = [
        ctypes.c_int, i64p, i32p, ctypes.c_int, i32p, ctypes.c_int64,
        ctypes.c_uint64,
    ]
    lib.gcol_hybrid_ea.argtypes = [
        ctypes.c_int, i64p, i32p, i32p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64,
    ]
    lib.gcol_partialcol.argtypes = [
        ctypes.c_int, i64p, i32p, ctypes.c_int, i32p, ctypes.c_int64,
        ctypes.c_uint64,
    ]
    lib.gcol_hillclimber.argtypes = [
        ctypes.c_int, i64p, i32p, i32p, ctypes.c_int64, ctypes.c_uint64,
    ]
    lib.gcol_antcol.argtypes = [
        ctypes.c_int, i64p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_uint64,
    ]
    lib.gcol_rlf.argtypes = [ctypes.c_int, i64p, i32p, i32p]
    for fn in ["gcol_greedy", "gcol_dsatur", "gcol_backtracking_dsatur",
               "gcol_tabucol", "gcol_hybrid_ea", "gcol_partialcol",
               "gcol_hillclimber", "gcol_antcol", "gcol_rlf"]:
        getattr(lib, fn).restype = ctypes.c_int
    return lib, lib_path


def build_distance2_graph(sparsity):
    """
    CSR adjacency of the column-intersection graph of a sparsity pattern

    sparsity: (m, n) boolean/float array or scipy sparse; columns that share a
    nonzero row become adjacent.  returns (row_ptr int64 (n+1,), col_ind int32)
    """
    from scipy import sparse as sp

    mat = sp.csc_matrix(sparsity, dtype=bool)
    inter = (mat.T @ mat).tocsr()
    inter.setdiag(False)
    inter.eliminate_zeros()
    return inter.indptr.astype(np.int64), inter.indices.astype(np.int32)


def _dsatur_py(n, row_ptr, col_ind):
    """pure-python DSatur fallback"""
    colors = np.full(n, -1, dtype=np.int32)
    sat = [set() for _ in range(n)]
    degrees = np.diff(row_ptr)
    done = np.zeros(n, dtype=bool)
    for _ in range(n):
        best = -1
        for v in range(n):
            if done[v]:
                continue
            if best < 0 or len(sat[v]) > len(sat[best]) or (
                len(sat[v]) == len(sat[best]) and degrees[v] > degrees[best]
            ):
                best = v
        used = {
            colors[u]
            for u in col_ind[row_ptr[best] : row_ptr[best + 1]]
            if colors[u] >= 0
        }
        c = 0
        while c in used:
            c += 1
        colors[best] = c
        done[best] = True
        for u in col_ind[row_ptr[best] : row_ptr[best + 1]]:
            if not done[u]:
                sat[u].add(c)
    return int(colors.max()) + 1, colors


def color_graph(row_ptr, col_ind, algorithm="hybrid_ea", max_iters=100_000,
                pop_size=10, seed=12345, node_budget=1_000_000,
                target_k=None):
    """color a CSR graph; returns (n_colors, colors int32 (n,))

    algorithm: greedy | dsatur | rlf | backtracking | hybrid_ea | hillclimber
    | antcol, plus the fixed-k searches tabucol | partialcol (which require
    target_k and raise if no proper target_k-coloring is found in max_iters).
    Without the native library every algorithm runs the python DSatur.
    """
    n = len(row_ptr) - 1
    if n == 0:
        return 0, np.zeros(0, dtype=np.int32)
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    colors = np.full(n, -1, dtype=np.int32)

    lib, _path = gcol_library()
    if lib is None:
        return _dsatur_py(n, row_ptr, col_ind)

    rp = row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    ci = col_ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    co = colors.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if algorithm == "greedy":
        n_colors = lib.gcol_greedy(n, rp, ci, co)
    elif algorithm == "dsatur":
        n_colors = lib.gcol_dsatur(n, rp, ci, co)
    elif algorithm == "rlf":
        n_colors = lib.gcol_rlf(n, rp, ci, co)
    elif algorithm == "backtracking":
        n_colors = lib.gcol_backtracking_dsatur(n, rp, ci, co, node_budget)
    elif algorithm == "hybrid_ea":
        n_colors = lib.gcol_hybrid_ea(n, rp, ci, co, max_iters, pop_size, seed)
    elif algorithm == "hillclimber":
        n_colors = lib.gcol_hillclimber(n, rp, ci, co, max_iters, seed)
    elif algorithm == "antcol":
        # the pheromone trail is a dense n x n double matrix: refuse graphs
        # where that allocation would abort the process inside the C call
        if n > 20_000:
            raise ValueError(
                f"antcol needs O(n^2) trail memory (n={n}); use hybrid_ea "
                "for large probing graphs"
            )
        n_colors = lib.gcol_antcol(n, rp, ci, co, pop_size, 50, max_iters,
                                   seed)
    elif algorithm in ("tabucol", "partialcol"):
        if target_k is None:
            raise ValueError(f"{algorithm} requires target_k")
        if target_k < 1:
            raise ValueError(f"target_k must be >= 1; got {target_k}")
        fn = lib.gcol_tabucol if algorithm == "tabucol" else lib.gcol_partialcol
        n_colors = fn(n, rp, ci, target_k, co, max_iters, seed)
    else:
        raise ValueError(f"unknown algorithm {algorithm}")
    if n_colors < 0:
        raise RuntimeError("coloring failed")
    return n_colors, colors


def probe_jacobian(jvp_fn, sparsity, algorithm="dsatur", device="cuda"):
    """
    recover a sparse Jacobian from one JVP per color group

    jvp_fn: v -> J @ v on tensors (the probe is a (n,) float64 tensor on
    `device`, the card unless the caller names the CPU; the result may live
    on any device)
    sparsity: (m, n) known sparsity pattern of J
    returns (jac dense numpy (m, n), n_colors)
    """
    from scipy import sparse as sp

    device = resolve_device(device)
    pattern = sp.csc_matrix(sparsity, dtype=bool)
    m, n = pattern.shape
    row_ptr, col_ind = build_distance2_graph(pattern)
    n_colors, colors = color_graph(row_ptr, col_ind, algorithm=algorithm)

    jac = np.zeros((m, n))
    for color in range(n_colors):
        probe = (colors == color).astype(np.float64)
        jv = jvp_fn(torch.as_tensor(probe, device=device))
        jv = jv.detach().cpu().numpy().astype(np.float64)
        # scatter: within a color group, each row belongs to at most one column
        for col in np.nonzero(probe)[0]:
            rows = pattern.indices[pattern.indptr[col] : pattern.indptr[col + 1]]
            jac[rows, col] = jv[rows]
    return jac, n_colors
