"""on-device sparse solves: stencil-diagonal (DIA) matvec + BiCGSTAB.

Port of newton_krylov_ooc_tpu/ops/sparse.py, the in-process counterpart of
the distributed sparse preconditioner solve the reference delegates to
MPI/SuperLU_DIST (`solve_ABdist`).  gen_A-style matrices live on a
structured (nz, nhoriz) grid, so `cell[col] - cell[row]` takes only a few
dozen distinct values: regrouped by that offset (DIA format over the flat
cell index) the matvec is a short loop of dense shift + multiply-add passes
with no gathers.  CSR-to-ELL (gather) packing is kept for matrices without
grid structure.  The systems solve with right-preconditioned BiCGSTAB; the
preconditioner is pointwise Jacobi or, given the gen_A grid decomposition,
exact vertical-line solves (parallel cyclic reduction along depth), which
cut iteration counts by ~60x on vmix-stiff implicit transport matrices.

The JAX module runs each solve as a `lax.while_loop` under `jit`, vmapped
over the right-hand sides (no Pallas call).  Here each right-hand side runs
its own plain loop on the tensors' device, one stop flag read to the host an
iteration, with the same per-rhs iteration counts and convergence flags.
The host-side regroupings (csr_to_ell, grid_dia_from_csr, the column
tridiagonal extractions) are numpy copies of the JAX package's.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch
import torch.nn.functional as F

from .compute import resolve_device
from .tridiag import pcr_solve

# iterative-refinement tuning shared by the unsharded (_mixed_refine_one)
# and sharded (parallel.sharded_sparse._local_mixed_refine_loop)
# mixed-precision solves; keep the two paths' convergence behavior identical
MIXED_REFINE_MAX_ROUNDS = 12
MIXED_REFINE_STALL_FACTOR = 0.5
MIXED_INNER_RTOL = 1.0e-6

# DIA beyond this many diagonals would start to lose to the gather matvec
# (and signals the matrix isn't the structured-stencil kind DIA targets)
_DIA_MAX_OFFSETS = 96

_logger = logging.getLogger(__name__)


def csr_to_ell(row_ptr, col_ind, data, n_cols=None):
    """pad CSR to ELL: (vals, cols) of shape (rows, max_nnz_per_row)

    padding entries have value 0 and point at column 0, so the matvec needs
    no mask.  host-side (numpy); returns numpy arrays.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind, np.int64)
    data = np.asarray(data, np.float64)
    rows = row_ptr.size - 1
    per_row = np.diff(row_ptr)
    width = int(per_row.max()) if rows else 0
    vals = np.zeros((rows, width), np.float64)
    cols = np.zeros((rows, width), np.int64)
    # position (r, j) holds the j-th entry of row r; the boolean mask
    # enumerates exactly the CSR entries in storage order
    in_row = np.arange(width)[None, :] < per_row[:, None]
    vals[in_row] = data
    cols[in_row] = col_ind
    return vals, cols


def ell_matvec(vals, cols, x):
    """y = A x for an ELL-packed matrix (tensors on one device)"""
    return (vals * x[cols]).sum(dim=-1)


def grid_dia_from_csr(row_ptr, col_ind, data, row_to_cell, n_cells):
    """regroup a structured-grid CSR matrix into flat-cell diagonals

    gen_A numbers matrix rows over the wet cells of an (nz, nlat, nlon)
    grid; its stencil makes `cell[col] - cell[row]` take only a few dozen
    distinct values.  Host side (numpy).  Returns (offsets, coefs): a
    sorted int tuple and a (n_offsets, n_cells) float64 array with
    coefs[i][cell_of_row] = A[row, row_of(cell + offsets[i])], zero where no
    entry exists -- the DIA storage of the same matrix on the full grid.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    per_row = np.diff(row_ptr)
    cell_r = np.repeat(np.asarray(row_to_cell, np.int64), per_row)
    cell_c = np.asarray(row_to_cell, np.int64)[np.asarray(col_ind, np.int64)]
    d_all = cell_c - cell_r
    offsets = np.unique(d_all)
    coefs = np.zeros((offsets.size, n_cells))
    for ind, off in enumerate(offsets):
        sel = d_all == off
        # one entry per (row, col) pair, so plain assignment is exact
        coefs[ind][cell_r[sel]] = np.asarray(data, np.float64)[sel]
    return tuple(int(off) for off in offsets), coefs


def dia_matvec(offsets, coefs, x):
    """y = A x for grid-diagonal storage (offsets a tuple of ints)

    x is the flat-cell vector (dry cells zero) along its last axis.  One
    padded copy of x and len(offsets) dense multiply-adds, summed in the
    offsets' order -- no gathers.
    """
    n = x.shape[-1]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    x_pad = F.pad(x, (lo, hi))
    out = None
    for ind, off in enumerate(offsets):
        term = coefs[ind] * x_pad[..., lo + off:lo + off + n]
        out = term if out is None else out + term
    return out


def column_tridiag_grid(row_ptr, col_ind, data, row_to_cell, nhoriz, nz):
    """vertical-line bands of a gen_A-style matrix on the FULL grid layout

    Like column_tridiag_from_csr, but the bands come back as (nhoriz, nz)
    float64 arrays over every grid cell (identity rows where a cell has no
    matrix row or a zero diagonal), so the line preconditioner applies to a
    flat-cell vector as reshape + pcr_solve + reshape -- no gather/scatter.
    Host side (numpy).
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    per_row = np.diff(row_ptr)
    cell_r = np.repeat(np.asarray(row_to_cell, np.int64), per_row)
    cell_diff = (
        np.asarray(row_to_cell, np.int64)[np.asarray(col_ind, np.int64)]
        - cell_r
    )
    n_cells = nz * nhoriz
    data = np.asarray(data, np.float64)
    dl = np.zeros(n_cells)
    d = np.zeros(n_cells)
    du = np.zeros(n_cells)
    for target, band in ((0, d), (nhoriz, du), (-nhoriz, dl)):
        sel = cell_diff == target
        band[cell_r[sel]] = data[sel]
    bad = d == 0.0
    d[bad] = 1.0
    dl[bad] = 0.0
    du[bad] = 0.0
    # (nz, nhoriz) C-order matches the flat cell index; lines want depth
    # on the (pcr_solve) last axis
    return tuple(
        np.ascontiguousarray(band.reshape(nz, nhoriz).T)
        for band in (dl, d, du)
    )


def grid_line_precond_apply(dl, d, du, v):
    """line preconditioner on a flat-cell vector: reshape + PCR, no gathers"""
    nhoriz, nz = d.shape
    v2 = v.reshape(nz, nhoriz).T
    return pcr_solve(dl, d, du, v2).T.reshape(-1)


def ell_diagonal(vals, cols):
    """main diagonal of an ELL-packed matrix"""
    rows = torch.arange(vals.shape[0], device=vals.device)
    return torch.where(cols == rows[:, None], vals, 0.0).sum(dim=1)


def jacobi_inverse_diagonal(vals, cols):
    """1/diag(A) for Jacobi preconditioning, with 1.0 substituted on zero
    diagonal entries (the single source of the singular-diagonal convention)
    """
    diag = ell_diagonal(vals, cols)
    nonzero = diag != 0
    return torch.where(nonzero, 1.0 / torch.where(nonzero, diag, 1.0), 1.0)


def column_tridiag_from_csr(row_ptr, col_ind, data, row_to_cell, nhoriz,
                            nz=None):
    """extract the vertical-line part of a gen_A-style CSR matrix

    gen_A numbers matrix rows over masked cells of an (nz, nlat, nlon) grid
    in C order, so cell = k * nhoriz + h with h the horizontal
    (water-column) index.  This regroups the rows into vertical lines and
    pulls out, per line, the tridiagonal coupling along depth: the full
    matrix diagonal plus the adjacent-level entries.

    host-side (numpy).  returns (dl, d, du, slot_of_row):
      dl/d/du: (n_lines, nz) float64 padded with identity rows where a line
               has no active cell at that level
      slot_of_row: (nrows,) int64 position of each matrix row in the packed
               (n_lines * nz) layout
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind, np.int64)
    data = np.asarray(data, np.float64)
    row_to_cell = np.asarray(row_to_cell, np.int64)
    nrows = row_ptr.size - 1
    if nz is None:
        nz = int(row_to_cell.max()) // int(nhoriz) + 1 if nrows else 1
    h_of_row = row_to_cell % nhoriz
    k_of_row = row_to_cell // nhoriz
    _, line_of_row = np.unique(h_of_row, return_inverse=True)
    n_lines = int(line_of_row.max()) + 1 if nrows else 0
    slot_of_row = line_of_row * nz + k_of_row

    dl = np.zeros(n_lines * nz)
    du = np.zeros(n_lines * nz)
    d = np.ones(n_lines * nz)
    d[slot_of_row] = 0.0

    # the diagonal is cell_col == cell_row and a same-column vertical
    # neighbor is exactly cell_col - cell_row == +-nhoriz
    per_row = np.diff(row_ptr)
    cell_diff = row_to_cell[col_ind] - np.repeat(row_to_cell, per_row)
    slot_rep = np.repeat(slot_of_row, per_row)
    for target, band in ((0, d), (nhoriz, du), (-nhoriz, dl)):
        sel = cell_diff == target
        band += np.bincount(
            slot_rep[sel], weights=data[sel], minlength=band.size
        )
    # a zero diagonal would poison the line solve; fall back to identity on
    # such rows (same convention as jacobi_inverse_diagonal)
    bad = d == 0.0
    d[bad] = 1.0
    dl[bad] = 0.0
    du[bad] = 0.0
    shape = (n_lines, nz)
    return dl.reshape(shape), d.reshape(shape), du.reshape(shape), slot_of_row


def line_precond_apply(dl, d, du, slot_of_row, v):
    """apply the column-line preconditioner: scatter v into the packed
    (n_lines, nz) layout, PCR-solve every line at once, gather back"""
    packed = torch.zeros(dl.shape[0] * dl.shape[1], dtype=v.dtype,
                         device=v.device)
    packed[slot_of_row] = v
    return pcr_solve(dl, d, du, packed.reshape(dl.shape)).reshape(-1)[
        slot_of_row]


def bicgstab_ell(vals, cols, b, rtol=1.0e-12, atol=0.0, max_iter=10000):
    """Jacobi-preconditioned BiCGSTAB solve of A x = b, A in ELL form;
    returns (x, converged, n_iter)"""
    d_inv = jacobi_inverse_diagonal(vals, cols)
    return bicgstab(lambda v: ell_matvec(vals, cols, v), b,
                    precond=lambda v: d_inv * v, rtol=rtol, atol=atol,
                    max_iter=max_iter)


def bicgstab(matvec, b, precond=None, rtol=1.0e-12, atol=0.0,
             max_iter=10000):
    """matrix-free right-preconditioned BiCGSTAB solve of A x = b

    matvec, precond: callables on flat tensors like b (precond None: the
    identity); any linear operator works, the 3D transport stencils
    (ops/transport3d.py) in particular.  The iteration stops when
    |r| <= max(rtol |b|, atol), after max_iter steps, or at a breakdown
    (omega, r_hat . v or rho exactly 0), as the JAX package's does.  A
    plain loop on b's device: each iteration reads one flag to the host.
    Returns (x, converged (a 0-d bool tensor), iterations (an int)).
    """
    if precond is None:
        def precond(v):
            return v

    bnorm = torch.sqrt(b @ b)
    tol = torch.clamp(rtol * bnorm, min=atol)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r, r_hat = b, b
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and bool((torch.sqrt(r @ r) > tol) & ~broke):
        rho_new = r_hat @ r
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        p_hat = precond(p)
        v = matvec(p_hat)
        denom = r_hat @ v
        alpha = rho_new / denom
        s = r - alpha * v
        s_hat = precond(s)
        t = matvec(s_hat)
        tt = t @ t
        omega = torch.where(tt > 0, (t @ s) / torch.where(tt > 0, tt, one),
                            0.0)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        broke = (omega == 0.0) | (denom == 0.0) | (rho_new == 0.0)
        rho = rho_new
        k += 1
    return x, torch.sqrt(r @ r) <= tol, k


def _mixed_refine_one(matvec64, matvec32, precond32, precond64, b, rtol,
                      max_iter, refine_rounds):
    """float32 BiCGSTAB inside float64 iterative refinement for ONE rhs,
    with a float64 polish when refinement stalls before reaching rtol

    Each round solves the float64 residual's correction system at unit
    scale in float32 and keeps the correction only when it reduced the
    float64 residual; a round that fails to halve it stops the refinement.
    The polish solves the remaining residual in float64 to the original
    tolerance (absolute), so the mode converges whenever the float64 solve
    would.  Returns (x, converged, inner iterations + polish iterations).
    """
    bnorm = torch.sqrt(b @ b)
    tol = rtol * bnorm
    x, r, rnorm = torch.zeros_like(b), b, bnorm
    rounds = inner = 0
    stalled = False
    while bool(rnorm > tol) and rounds < refine_rounds and not stalled:
        # normalize the correction system so the f32 inner solve works at
        # unit scale (no under/overflow as the residual shrinks)
        scale = torch.where(rnorm > 0, rnorm, 1.0)
        dx32, _ok, k = bicgstab(
            matvec32, (r / scale).to(torch.float32), precond=precond32,
            rtol=MIXED_INNER_RTOL, max_iter=max_iter,
        )
        x_new = x + scale * dx32.to(torch.float64)
        r_new = b - matvec64(x_new)
        rn = torch.sqrt(r_new @ r_new)
        # a round that fails to contract the f64 residual means the f32
        # solve has hit its floor: stop, and commit only corrections that
        # reduced the residual
        stalled = bool(rn >= MIXED_REFINE_STALL_FACTOR * rnorm)
        if bool(rn < rnorm):
            x, r, rnorm = x_new, r_new, rn
        rounds += 1
        inner += k
    if not bool(rnorm > tol):
        return x, rnorm <= tol, inner
    # float64 polish on the remaining residual (absolute target: the
    # original tol)
    dx, ok_polish, k_polish = bicgstab(matvec64, r, precond=precond64,
                                       rtol=0.0, atol=tol, max_iter=max_iter)
    return x + dx, ok_polish, inner + k_polish


def solve_csr_systems(row_ptr, col_ind, data, rhs_batch, rtol=1.0e-12,
                      max_iter=10000, row_to_cell=None, nhoriz=None,
                      return_iters=False, mixed_precision=False,
                      precond="line", refine_rounds=None, device="cuda"):
    """solve A x_i = b_i for a batch of right-hand sides (host entry)

    rhs_batch: (n_rhs, n) numpy array; returns numpy (x_batch,
    converged_flags), with return_iters=True a third array of per-rhs
    (inner-)iteration counts.  The solve runs on `device`, the card unless
    the caller names the CPU.

    With row_to_cell + nhoriz (gen_A writes both: the row map variable and
    the grid_nhoriz dimension) the matrix regroups into flat-cell diagonals
    (grid_dia_from_csr) and every BiCGSTAB vector lives on the full grid
    (dry cells identically zero).  BiCGSTAB preconditions with exact
    vertical-line solves (precond="line", the default) or pointwise Jacobi
    (precond="jacobi").  Without the grid arguments the matrix pads to ELL
    and the matvec is a gather, preconditioned by Jacobi.

    mixed_precision=True (requires the grid arguments) runs the BiCGSTAB
    iterations in float32 inside a float64 iterative-refinement loop, with
    a float64 polish when refinement stalls before reaching rtol;
    refine_rounds overrides the refinement-round cap (mainly for tests).
    Each call logs one `solve_csr_systems:` line: the route, the host
    regrouping's seconds (to the matrix on the device), the solves' seconds
    (to the solutions on the host) and the per-rhs iterations.
    """
    if precond not in ("line", "jacobi"):
        raise ValueError(f"precond {precond!r} not supported")
    start = time.perf_counter()
    device = resolve_device(device)
    rhs_np = np.asarray(rhs_batch, np.float64)
    f64 = {"dtype": torch.float64, "device": device}
    f32 = {"dtype": torch.float32, "device": device}

    if row_to_cell is not None and nhoriz is not None:
        row_to_cell = np.asarray(row_to_cell, np.int64)
        nz = int(row_to_cell.max()) // int(nhoriz) + 1 if row_to_cell.size else 1
        n_cells = nz * int(nhoriz)
        offsets, coefs_np = grid_dia_from_csr(
            row_ptr, col_ind, data, row_to_cell, n_cells
        )
        if len(offsets) > _DIA_MAX_OFFSETS:
            raise ValueError(
                f"{len(offsets)} distinct cell offsets: this matrix is not "
                "the structured-stencil kind the grid arguments promise"
            )
        # BiCGSTAB state lives on the full grid: scatter the right-hand
        # sides once host-side, gather the solutions once at the end
        rhs_grid = np.zeros((rhs_np.shape[0], n_cells))
        rhs_grid[:, row_to_cell] = rhs_np
        coefs = torch.as_tensor(coefs_np, **f64)
        rhs = torch.as_tensor(rhs_grid, **f64)
        route = (f"DIA {len(offsets)} offsets, "
                 f"{'mixed ' if mixed_precision else ''}{precond} precond")

        def matvec64(v):
            return dia_matvec(offsets, coefs, v)

        if precond == "jacobi":
            diag = (
                coefs_np[offsets.index(0)]
                if 0 in offsets
                else np.zeros(n_cells)
            )
            d_inv = torch.as_tensor(
                np.where(diag != 0.0,
                         1.0 / np.where(diag != 0.0, diag, 1.0), 1.0), **f64)
            regrouped = time.perf_counter()
            solves = [bicgstab(matvec64, b, precond=lambda v: d_inv * v,
                               rtol=rtol, max_iter=max_iter) for b in rhs]
        else:
            bands = column_tridiag_grid(
                row_ptr, col_ind, data, row_to_cell, nhoriz, nz
            )
            dl, d, du = (torch.as_tensor(band, **f64) for band in bands)

            def line64(v):
                return grid_line_precond_apply(dl, d, du, v)

            if mixed_precision:
                rounds = (
                    MIXED_REFINE_MAX_ROUNDS
                    if refine_rounds is None
                    else refine_rounds
                )
                coefs32 = torch.as_tensor(coefs_np, **f32)
                dl32, d32, du32 = (torch.as_tensor(band, **f32)
                                   for band in bands)
                regrouped = time.perf_counter()
                solves = [
                    _mixed_refine_one(
                        matvec64,
                        lambda v: dia_matvec(offsets, coefs32, v),
                        lambda v: grid_line_precond_apply(dl32, d32, du32, v),
                        line64, b, rtol, max_iter, rounds,
                    )
                    for b in rhs
                ]
            else:
                regrouped = time.perf_counter()
                solves = [bicgstab(matvec64, b, precond=line64, rtol=rtol,
                                   max_iter=max_iter) for b in rhs]
        x = torch.stack([sol[0] for sol in solves]).cpu().numpy()[
            :, row_to_cell]
    elif mixed_precision:
        raise ValueError(
            "mixed_precision needs the grid arguments (row_to_cell + nhoriz)"
        )
    else:
        vals_np, cols_np = csr_to_ell(row_ptr, col_ind, data)
        vals = torch.as_tensor(vals_np, **f64)
        cols = torch.as_tensor(cols_np, device=device)
        route = f"ELL width {vals_np.shape[1]}, jacobi precond"
        regrouped = time.perf_counter()
        solves = [bicgstab_ell(vals, cols, b, rtol=rtol, max_iter=max_iter)
                  for b in torch.as_tensor(rhs_np, **f64)]
        x = torch.stack([sol[0] for sol in solves]).cpu().numpy()
    ok = np.array([bool(sol[1]) for sol in solves], dtype=bool)
    iters = np.array([int(sol[2]) for sol in solves], dtype=np.int32)
    _logger.info(
        "solve_csr_systems: %d rows, %d nonzeros, %s, %d rhs on %s: "
        "regroup %.3f s, solve %.3f s, iterations %s, converged %s",
        len(row_ptr) - 1, len(data), route, rhs_np.shape[0], device,
        regrouped - start, time.perf_counter() - regrouped, iters.tolist(),
        ok.tolist(),
    )
    if return_iters:
        return x, ok, iters
    return x, ok
