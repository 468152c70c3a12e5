"""direct cyclostationary solve of py_driver_2d iage through its dense
year-transition operator.

Port of examples/year_operator_spinup.py.  The iage module is linear, so
its one-year map is affine, year(X) = B X + c.  The probe runs every grid
basis column as a channel of the source-free year (on a card, kernel B1,
2 x col_chunk channels a launch on the F and JVP years' one table, each
channel mapped to its tracer's factor slot), then solves the spin-up
directly: (I - B) X = c by Newton-Schulz inversion plus exact-residual
polish -- no Newton iteration, no Krylov subspace.  It prints the probe's
seconds and table bytes, the solve's seconds, the time-stepped residual
F(X*) and the leading eigenvalues of each tracer's annual propagator.

    python -m newton_krylov_ooc_tpu_torch.cli.year_operator_spinup \\
        [nz] [ny] [n_steps] [col_chunk] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.py_driver_2d.incore import IageKernel
from ..ops.compute import resolve_device
from .incore_spinup import MODELINFO, build_axes


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("nz", nargs="?", type=int, default=40)
    parser.add_argument("ny", nargs="?", type=int, default=50)
    parser.add_argument("n_steps", nargs="?", type=int, default=8760)
    parser.add_argument("col_chunk", nargs="?", type=int, default=125)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """probe, solve and print; returns (kernel, operator, X*, info) for
    callers that check the result, info holding probe_seconds,
    table_bytes (None off the kernel), solve_seconds, resid (max|F(X*)|
    through the kernel's year), spectrum_seconds and eigvals"""
    args = parse_args(argv)
    device = resolve_device(args.device)
    depth, ypos = build_axes(args.nz, args.ny)
    kernel = IageKernel(depth, ypos, MODELINFO, device=device,
                        dtype=torch.float32, n_steps=args.n_steps)
    n = args.nz * args.ny  # columns a tracer; both tracers probe together

    info = {"table_bytes": kernel.table.nbytes if kernel.use_kernel
            else None}
    start = time.perf_counter()
    op = kernel.build_year_operator(col_chunk=args.col_chunk)
    _sync(device)
    info["probe_seconds"] = time.perf_counter() - start
    table = (f", table {info['table_bytes']} bytes" if kernel.use_kernel
             else "")
    print(f"probed B ({n} columns x 2 tracers, chunk {args.col_chunk}"
          f"{table}): {info['probe_seconds']:.2f} s")

    start = time.perf_counter()
    x_star = op.solve_cyclostationary()
    _sync(device)
    info["solve_seconds"] = time.perf_counter() - start
    print(f"direct solve (Newton-Schulz + polish): "
          f"{info['solve_seconds']:.2f} s")

    resid = info["resid"] = float(kernel.comp_fcn(x_star).abs().max())
    scale = float(x_star.abs().max())
    print(f"time-stepped residual |F(X*)|_max = {resid:.3e} "
          f"(|X*|_max = {scale:.1f}, relative {resid / scale:.1e})")

    # the slow modes of the annual propagator are the spin-up problem:
    # their e-folding times say how many years a forward run would need
    start = time.perf_counter()
    eigvals, timescales = op.spectrum(k=5)
    _sync(device)
    info["spectrum_seconds"] = time.perf_counter() - start
    info["eigvals"] = eigvals
    print(f"propagator spectrum ({info['spectrum_seconds']:.2f} s):")
    for t, name in enumerate(("iage", "iage_slow_rest")):
        mags = ", ".join(f"|l|={abs(v):.4f} (tau={tau:.1f} yr)"
                         for v, tau in zip(eigvals[t], timescales[t]))
        print(f"  {name}: {mags}")
    return kernel, op, x_star, info


if __name__ == "__main__":
    main()
