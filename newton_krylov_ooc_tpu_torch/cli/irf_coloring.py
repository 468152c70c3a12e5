"""IRF tracer coloring: pack many impulse-response tracers into one model run.

Port of examples/irf_coloring.py.  Estimating the columns of a transport
Jacobian needs one impulse tracer per grid cell -- unless cells whose
Jacobian columns are structurally orthogonal share a tracer.  Build the
distance-2 (column-intersection) graph of the transport stencil, color it
(native C++ gcol), and the color count is the number of impulse tracers
needed for one forward run.  Then recover a random Jacobian on that pattern
exactly through the coloring, one product a color on the device.

    python -m newton_krylov_ooc_tpu_torch.cli.irf_coloring [nz] [ny] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy import sparse

from ..ops.compute import resolve_device
from ..ops.probing import build_distance2_graph, color_graph, probe_jacobian


def transport_sparsity(nz, ny):
    """sparsity of a 5-point (z+-1, y+-1) transport stencil on an nz x ny grid"""
    n = nz * ny
    rows, cols = [], []
    for z in range(nz):
        for y in range(ny):
            i = z * ny + y
            for dz, dy in [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]:
                z2, y2 = z + dz, y + dy
                if 0 <= z2 < nz and 0 <= y2 < ny:
                    rows.append(i)
                    cols.append(z2 * ny + y2)
    return sparse.csr_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("nz", nargs="?", type=int, default=20)
    parser.add_argument("ny", nargs="?", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    nz, ny = args.nz, args.ny
    n = nz * ny

    pattern = transport_sparsity(nz, ny)
    row_ptr, col_ind = build_distance2_graph(pattern)
    print(f"grid {nz}x{ny}: {n} cells, distance-2 graph with "
          f"{len(col_ind)//2} edges")

    counts = {}
    for algorithm in ["greedy", "dsatur", "hybrid_ea"]:
        n_colors, _ = color_graph(row_ptr, col_ind, algorithm=algorithm)
        counts[algorithm] = n_colors
        print(f"  {algorithm:12s}: {n_colors} impulse tracers "
              f"({n / n_colors:.0f}x fewer than one per cell)")

    # exact Jacobian recovery through the coloring: one product a color
    rng = np.random.default_rng(0)
    jac = pattern.multiply(rng.normal(size=(n, n))).tocsr()
    jac_dev = torch.sparse_csr_tensor(
        torch.as_tensor(jac.indptr, dtype=torch.int64),
        torch.as_tensor(jac.indices, dtype=torch.int64),
        torch.as_tensor(jac.data, dtype=torch.float64),
        size=(n, n), check_invariants=True,
    ).to(device)
    recovered, n_colors = probe_jacobian(
        lambda v: jac_dev @ v, pattern, algorithm="dsatur", device=device
    )
    err = float(np.abs(recovered - jac.toarray()).max())
    print(f"probing with {n_colors} colors on {device}: max recovery error "
          f"{err:.1e}")
    return counts, n_colors, err


if __name__ == "__main__":
    main()
