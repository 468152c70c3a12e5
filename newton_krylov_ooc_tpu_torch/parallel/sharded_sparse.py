"""mesh-sharded sparse solve: the distributed `solve_ABdist` counterpart.

Port of newton_krylov_ooc_tpu/parallel/sharded_sparse.py.  The reference
solves its gen_A preconditioner matrices with an external MPI program on an
nprow x npcol process grid; the JAX module solves them on a 1-D device mesh
under `shard_map`.  Here the mesh is the port's (parallel/mesh.py) with one
module row: the ELL-packed matrix rows split into contiguous blocks, one a
shard, each on its shard's device (shards may share a device, as the other
sharded paths allow).  Each BiCGSTAB iteration concatenates the shards'
preconditioned direction onto every shard's device -- the JAX all_gather,
the analog of SuperLU_DIST's row exchange -- and sums the shards' partial
dot products on the first shard's device, the JAX psum.  Preconditioning is
pointwise Jacobi, or -- given the gen_A grid decomposition -- the rows
repack into vertical lines (whole lines per shard) and each iteration
applies exact shard-local column-tridiagonal solves at no added
communication.

Right-hand sides batch along a leading axis (one per tracer, as in the
reference's `-v tracer_a,tracer_b` invocation); converged systems freeze via
masks so the loop runs until every system is done, one flag read to the
host an iteration.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.compute import resolve_device
from ..ops.sparse import (
    MIXED_INNER_RTOL,
    MIXED_REFINE_MAX_ROUNDS,
    MIXED_REFINE_STALL_FACTOR,
    column_tridiag_from_csr,
    csr_to_ell,
    jacobi_inverse_diagonal,
    solve_csr_systems,
)
from ..ops.tridiag import pcr_solve
from .mesh import make_mesh

_logger = logging.getLogger(__name__)


def pad_ell_rows(vals, cols, n_shards):
    """pad an ELL matrix with identity rows so rows divide n_shards evenly

    padding rows get a 1 on their own diagonal and (with zero right-hand
    sides) carry a zero solution; no real row references the padded columns,
    so the solution of the original system is unchanged.  host-side numpy.
    """
    vals = np.asarray(vals)
    cols = np.asarray(cols)
    rows, width = vals.shape
    width = max(width, 1)
    n_pad = (-rows) % n_shards
    if n_pad == 0 and vals.shape[1] == width:
        return vals, cols, rows
    vals_p = np.zeros((rows + n_pad, width), vals.dtype)
    cols_p = np.zeros((rows + n_pad, width), cols.dtype)
    vals_p[:rows, : vals.shape[1]] = vals
    cols_p[:rows, : cols.shape[1]] = cols
    pad_rows = np.arange(rows, rows + n_pad)
    vals_p[rows:, 0] = 1.0
    cols_p[rows:, 0] = pad_rows
    return vals_p, cols_p, rows


class _Shards:
    """the row blocks of a 1-D mesh: shard i holds rows [i * rows_l,
    (i + 1) * rows_l) on devices[i]"""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.first = self.devices[0]

    def split(self, arr, axis, dtype=None):
        """host array -> one contiguous block a shard on its device"""
        arr = torch.as_tensor(np.asarray(arr))
        if dtype is not None:
            arr = arr.to(dtype)
        blocks = torch.chunk(arr, len(self.devices), dim=axis)
        return [blk.to(dev).contiguous()
                for blk, dev in zip(blocks, self.devices)]

    def gather(self, blocks, axis):
        """blocks -> one host numpy array"""
        return torch.cat([blk.cpu() for blk in blocks], dim=axis).numpy()

    def all_gather(self, blocks):
        """(n_rhs, rows_l) blocks -> the whole (n_rhs, rows) vector on each
        shard's device (one concatenation a distinct device)"""
        whole = {}
        for dev in self.devices:
            if dev not in whole:
                whole[dev] = torch.cat([blk.to(dev) for blk in blocks], dim=1)
        return [whole[dev] for dev in self.devices]

    def dot(self, a_blocks, b_blocks):
        """per-rhs dot products: each shard's partial sums, summed on the
        first shard's device in shard order"""
        total = None
        for a, b in zip(a_blocks, b_blocks):
            part = (a * b).sum(dim=1).to(self.first)
            total = part if total is None else total + part
        return total

    def per_shard(self, vec):
        """a (n_rhs,) tensor on the first device -> (n_rhs, 1) a shard"""
        return [vec[:, None].to(dev) for dev in self.devices]


def _ell_matvec_gathered(shards, vals, cols, x_blocks):
    """shard-local rows x global vector: gather the vector onto each shard,
    then contract -- the analog of the MPI row exchange"""
    return [torch.einsum("rk,brk->br", vals_l, x_g[:, cols_l])
            for vals_l, cols_l, x_g in zip(vals, cols,
                                           shards.all_gather(x_blocks))]


def _where(mask_blocks, a_blocks, b_blocks):
    return [torch.where(m, a, b)
            for m, a, b in zip(mask_blocks, a_blocks, b_blocks)]


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0), ok


def _local_bicgstab_loop(shards, matvec, precond, rhs, rtol, max_iter):
    """masked batched BiCGSTAB loop on the shards' blocks

    matvec/precond map blocks of (n_rhs, rows_l) to blocks of the same
    shapes; precond is shard-local.  Returns (x blocks, converged (n_rhs,),
    per-rhs iteration counts (n_rhs,)), the last two on the first device.
    """
    n_rhs = rhs[0].shape[0]
    dtype = rhs[0].dtype

    def resid_norm(r):
        return torch.sqrt(shards.dot(r, r))

    bnorm = resid_norm(rhs)
    tol = rtol * bnorm

    def scale(vec, blocks):
        return [c * blk for c, blk in zip(shards.per_shard(vec), blocks)]

    def axpy(a, xs, ys):
        return [x + y for x, y in zip(xs, scale(a, ys))]

    x = [torch.zeros_like(blk) for blk in rhs]
    r = list(rhs)
    r_hat = list(rhs)
    p = [torch.zeros_like(blk) for blk in rhs]
    v = [torch.zeros_like(blk) for blk in rhs]
    ones = torch.ones((n_rhs,), dtype=dtype, device=shards.first)
    rho, alpha, omega = ones, ones, ones
    # the residual norm is carried so that each iteration pays one
    # reduction for it
    rnorm = bnorm
    broke = torch.zeros((n_rhs,), dtype=torch.bool, device=shards.first)
    iters = torch.zeros((n_rhs,), dtype=torch.int32, device=shards.first)
    k = 0
    while k < max_iter:
        active = (rnorm > tol) & ~broke
        if not bool(active.any()):
            break
        act = shards.per_shard(active)

        rho_new = shards.dot(r_hat, r)
        beta, ok_b = _safe_div(rho_new * alpha, rho * omega)
        p_new = axpy(beta, r, [pp - ww for pp, ww in
                               zip(p, scale(omega, v))])
        p_hat = precond(p_new)
        v_new = matvec(p_hat)
        denom = shards.dot(r_hat, v_new)
        alpha_new, ok_a = _safe_div(rho_new, denom)
        s = [rr - vv for rr, vv in zip(r, scale(alpha_new, v_new))]
        s_hat = precond(s)
        t = matvec(s_hat)
        tt = shards.dot(t, t)
        omega_new, _ = _safe_div(shards.dot(t, s), tt)
        x_new = axpy(omega_new, axpy(alpha_new, x, p_hat), s_hat)
        r_new = [ss - tv for ss, tv in zip(s, scale(omega_new, t))]
        broke = broke | (
            active & (~ok_b | ~ok_a | (omega_new == 0.0) | (rho_new == 0.0))
        )

        # freeze systems that are done (or broke) this iteration
        x = _where(act, x_new, x)
        r = _where(act, r_new, r)
        p = _where(act, p_new, p)
        v = _where(act, v_new, v)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha_new, alpha)
        omega = torch.where(active, omega_new, omega)
        rnorm = torch.where(active, resid_norm(r_new), rnorm)
        iters = iters + active.to(torch.int32)
        k += 1
    return x, rnorm <= tol, iters


def _local_mixed_refine_loop(shards, matvec64, matvec32, precond32, rhs,
                             rtol, max_iter):
    """float32 BiCGSTAB rounds under float64 iterative refinement, masked
    per right-hand side (the sharded twin of ops.sparse's
    `_mixed_refine_one`)

    Each round solves the f64-residual correction system in f32 at unit
    scale, applies it, and recomputes the true f64 residual; systems that
    stop contracting freeze as stalled.  Returns (x blocks, converged,
    per-rhs inner iteration counts).
    """
    n_rhs = rhs[0].shape[0]
    bnorm = torch.sqrt(shards.dot(rhs, rhs))
    tol = rtol * bnorm

    x = [torch.zeros_like(blk) for blk in rhs]
    r = list(rhs)
    rnorm = bnorm
    stalled = torch.zeros((n_rhs,), dtype=torch.bool, device=shards.first)
    inner = torch.zeros((n_rhs,), dtype=torch.int32, device=shards.first)
    for _round in range(MIXED_REFINE_MAX_ROUNDS):
        active = (rnorm > tol) & ~stalled
        if not bool(active.any()):
            break
        # normalize the correction system so the f32 inner solve works at
        # unit scale; frozen systems get a zero rhs and exit at once
        scale = torch.where(rnorm > 0, rnorm, 1.0)
        scale_l = shards.per_shard(scale)
        dx32, _ok, k = _local_bicgstab_loop(
            shards, matvec32, precond32,
            [torch.where(a, blk / c, 0.0).to(torch.float32) for a, blk, c
             in zip(shards.per_shard(active), r, scale_l)],
            MIXED_INNER_RTOL, max_iter,
        )
        x_new = [xx + c * dd.to(torch.float64) for xx, c, dd in
                 zip(x, scale_l, dx32)]
        r_new = [bb - ax for bb, ax in zip(rhs, matvec64(x_new))]
        rn = torch.sqrt(shards.dot(r_new, r_new))
        # a round that fails to contract the f64 residual means the f32
        # solve has hit its floor: freeze, and commit only corrections
        # that reduced the residual
        stalled = stalled | (
            active & (rn >= MIXED_REFINE_STALL_FACTOR * rnorm)
        )
        accept = active & (rn < rnorm)
        acc = shards.per_shard(accept)
        x = _where(acc, x_new, x)
        r = _where(acc, r_new, r)
        rnorm = torch.where(accept, rn, rnorm)
        inner = inner + k
    return x, rnorm <= tol, inner


def _line_precond(dl, d, du):
    """shard-local column-tridiagonal solves on line-packed blocks"""

    def apply(blocks):
        out = []
        for dl_l, d_l, du_l, v in zip(dl, d, du, blocks):
            nz = dl_l.shape[1]
            packed = v.reshape(v.shape[0], -1, nz)
            out.append(pcr_solve(dl_l[None], d_l[None], du_l[None], packed)
                       .reshape(v.shape))
        return out

    return apply


def _line_pack_system(row_ptr, col_ind, data, rhs_np, row_to_cell, nhoriz,
                      n_shards):
    """permute a gen_A system into line-packed slot order (host-side numpy)

    Slot s = line * nz + level; identity rows fill the slots of inactive
    cells and whole identity lines pad n_lines to a multiple of n_shards, so
    splitting the slot axis keeps every vertical line on one shard.
    Returns (vals_s, cols_s, dl, d, du, rhs_s, slot_of_row).
    """
    dl, d, du, slot_of_row = column_tridiag_from_csr(
        row_ptr, col_ind, data, row_to_cell, nhoriz
    )
    n_lines, nz = dl.shape
    n_lines_pad = -(-n_lines // n_shards) * n_shards
    if n_lines_pad != n_lines:
        pad = ((0, n_lines_pad - n_lines), (0, 0))
        dl = np.pad(dl, pad)
        du = np.pad(du, pad)
        d = np.pad(d, pad, constant_values=1.0)
    n_slots = n_lines_pad * nz

    vals_e, cols_e = csr_to_ell(row_ptr, col_ind, data)
    width = max(vals_e.shape[1], 1)
    vals_s = np.zeros((n_slots, width))
    cols_s = np.zeros((n_slots, width), np.int64)
    vals_s[slot_of_row, : vals_e.shape[1]] = vals_e
    cols_s[slot_of_row, : cols_e.shape[1]] = slot_of_row[cols_e]
    pad_slot = np.ones(n_slots, bool)
    pad_slot[slot_of_row] = False
    vals_s[pad_slot, 0] = 1.0
    cols_s[pad_slot, 0] = np.nonzero(pad_slot)[0]

    rhs_s = np.zeros((rhs_np.shape[0], n_slots))
    rhs_s[:, slot_of_row] = rhs_np
    return vals_s, cols_s, dl, d, du, rhs_s, slot_of_row


def _mesh_shards(mesh, device):
    """the 1-D mesh's shards, or None when the default mesh would hold one
    device (the unsharded fallback)"""
    if mesh is None:
        device = resolve_device(device)
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev == 1:
            return None
        mesh = make_mesh(1, n_dev)
    if mesh.shape["module"] != 1 or "space_x" in mesh.shape:
        raise ValueError(
            "solve_csr_systems_sharded needs a 1-D mesh (one module row, no "
            f"space_x axis); got {mesh.shape}"
        )
    return _Shards(mesh.devices[0])


def solve_csr_systems_sharded(
    row_ptr,
    col_ind,
    data,
    rhs_batch,
    mesh=None,
    rtol=1.0e-12,
    max_iter=10000,
    row_to_cell=None,
    nhoriz=None,
    mixed_precision=False,
    device="cuda",
    return_iters=False,
):
    """solve A x_i = b_i over a 1-D mesh of shards (host entry)

    Same contract as `ops.sparse.solve_csr_systems`, but the matrix rows
    split over `mesh`, a parallel.mesh.Mesh with one module row (its
    'space' axis carries the rows; devices may repeat).  With mesh=None the
    mesh is every visible device of `device`'s kind, the card unless the
    caller names the CPU; when that is one device the solve falls back to
    the unsharded `solve_csr_systems` and logs it.  An explicit mesh always
    runs the sharded code, on any number of shards.

    With row_to_cell + nhoriz the rows repack into vertical lines (whole
    lines per shard) and BiCGSTAB preconditions with exact shard-local
    column-tridiagonal solves instead of pointwise Jacobi.
    mixed_precision=True (requires the line-precond arguments) runs the
    sharded BiCGSTAB iterations in float32 inside a float64
    iterative-refinement loop that reaches the same rtol.
    return_iters=True appends the per-rhs (inner-)iteration counts.
    """
    if mixed_precision and (row_to_cell is None or nhoriz is None):
        raise ValueError(
            "mixed_precision needs the line-precond arguments "
            "(row_to_cell + nhoriz)"
        )
    shards = _mesh_shards(mesh, device)
    if shards is None:
        _logger.info("sharded sparse solve: one %s device visible; solving "
                     "unsharded", resolve_device(device).type)
        return solve_csr_systems(
            row_ptr, col_ind, data, rhs_batch, rtol=rtol,
            max_iter=max_iter, row_to_cell=row_to_cell, nhoriz=nhoriz,
            mixed_precision=mixed_precision, return_iters=return_iters,
            device=device,
        )
    n_shards = len(shards.devices)
    rhs_np = np.asarray(rhs_batch, np.float64)
    n_rows = len(row_ptr) - 1

    if row_to_cell is not None and nhoriz is not None:
        if rhs_np.ndim != 2 or rhs_np.shape[1] != n_rows:
            raise ValueError(
                f"rhs_batch must be (n_rhs, {n_rows}); got {rhs_np.shape}"
            )
        vals_s, cols_s, dl, d, du, rhs_s, slot_of_row = _line_pack_system(
            row_ptr, col_ind, data, rhs_np, row_to_cell, nhoriz, n_shards
        )
        _logger.info(
            "sharded line-precond sparse solve: %d rows in %d slots x %d rhs "
            "over %d shards%s",
            n_rows, vals_s.shape[0], rhs_s.shape[0], n_shards,
            " (f32 inner / f64 refinement)" if mixed_precision else "",
        )
        cols = shards.split(cols_s, 0)
        rhs = shards.split(rhs_s, 1, torch.float64)
        vals64 = shards.split(vals_s, 0, torch.float64)
        if mixed_precision:
            vals32 = shards.split(vals_s, 0, torch.float32)
            x, ok, iters = _local_mixed_refine_loop(
                shards,
                lambda xs: _ell_matvec_gathered(shards, vals64, cols, xs),
                lambda xs: _ell_matvec_gathered(shards, vals32, cols, xs),
                _line_precond(*(shards.split(band, 0, torch.float32)
                                for band in (dl, d, du))),
                rhs, float(rtol), int(max_iter),
            )
        else:
            x, ok, iters = _local_bicgstab_loop(
                shards,
                lambda xs: _ell_matvec_gathered(shards, vals64, cols, xs),
                _line_precond(*(shards.split(band, 0, torch.float64)
                                for band in (dl, d, du))),
                rhs, float(rtol), int(max_iter),
            )
        x = shards.gather(x, 1)[:, slot_of_row]
    else:
        vals_np, cols_np = csr_to_ell(row_ptr, col_ind, data)
        vals_np, cols_np, n_rows = pad_ell_rows(vals_np, cols_np, n_shards)
        if rhs_np.ndim != 2 or rhs_np.shape[1] != n_rows:
            raise ValueError(
                f"rhs_batch must be (n_rhs, {n_rows}); got {rhs_np.shape}"
            )
        rhs_p = np.zeros((rhs_np.shape[0], vals_np.shape[0]), np.float64)
        rhs_p[:, :n_rows] = rhs_np
        d_inv = jacobi_inverse_diagonal(torch.as_tensor(vals_np),
                                        torch.as_tensor(cols_np))
        _logger.info(
            "sharded sparse solve: %d rows (+%d pad) x %d rhs over %d shards",
            n_rows, vals_np.shape[0] - n_rows, rhs_p.shape[0], n_shards,
        )
        vals = shards.split(vals_np, 0, torch.float64)
        cols = shards.split(cols_np, 0)
        d_inv_l = shards.split(d_inv, 0, torch.float64)
        x, ok, iters = _local_bicgstab_loop(
            shards,
            lambda xs: _ell_matvec_gathered(shards, vals, cols, xs),
            lambda vs: [di[None, :] * blk for di, blk in zip(d_inv_l, vs)],
            shards.split(rhs_p, 1, torch.float64), float(rtol), int(max_iter),
        )
        x = shards.gather(x, 1)[:, :n_rows]
    ok = ok.cpu().numpy()
    if return_iters:
        return x, ok, iters.cpu().numpy()
    return x, ok
