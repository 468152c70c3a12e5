"""k steps of the 3D transport year on one halo-extended latitude block, as a
hand-written CUDA kernel (B7), beside its plain PyTorch version.

`build_block3d_steps` is the port of
newton_krylov_ooc_tpu/ops/transport3d_block_pallas.py::build_block3d_steps,
the per-shard compute of parallel/sharded_transport3d.py::
build_sharded_transport3d_year_blocked.  The returned fn(y, c, coef_stack,
dlb, dub[, diag][, src]) -> (y, c) advances a block's state y and Kahan
carry c, (T, nz, rows_ext, nlon) float32, by k x [Heun(dt); CN(dt)]:
  * the tendency is ops/transport3d.py::transport_tend on the block's
    coefficient fields (coef_stack, (n_coef, nz, rows_ext, nlon), in the
    order of coef_names): zeros past the window in latitude and depth,
    periodic in longitude; plus src;
  * the (T, T) surface coupling acts in both Heun stages, the second at
    y + dt f1;
  * the CN step over the bands dlb, dub (ops/transport3d_cuda.py::
    _cn_bands) and the implicit rate diag has its right-hand side in flux
    form and is solved in increment form;
  * both increments are Kahan adds.
A rate field of the a wet + b wet_surf form (diag_fac / src_fac: the two
scalars per tracer, ops/transport3d_stream_cuda.py::_factor_rate_field)
is rebuilt from the window's wet mask instead of being passed.  Only the
rows at least 4 k from the window's latitude edges come out exact.

On a CUDA device fn launches csrc/transport3d_block.cu (the note at the top
of that file gives the design): the k steps of a block in one cooperative
launch, and through fn.many the blocks of up to MAX_SHARDS shards of one
card in that launch, each launch counted in `transport3d_block_launches`;
on the CPU it is `block3d_steps_plain`.  The kernel reads the upwind3
selectors as a byte a cell packed from the window's wet mask
(transport3d_stream_cuda.pack_selectors): a caller that steps the same
window many times packs them once and passes them as `sel`, else fn packs
them anew on every call.  The TPU kernel's VMEM budget
(block3d_vmem_bytes, VmemBudgetError) has no counterpart: `block_schedule`
lays the shards' tiles on the card's co-resident blocks and refuses,
naming the limit, a step tile that does not fit its shared memory.
tend_chunk bounds the TPU kernel's live tracer width; it is checked here
and changes nothing on the card.

`block3d_steps_plain` is the same function in plain PyTorch, in the inputs'
dtype on their device: transport_tend with the selectors coef_stack holds
(the JAX kernel's contract; the CUDA kernel derives them from the window's
wet mask, which differs only in rows that are garbage anyway), and the
port's divide-form PCR for the column solves, where the JAX kernel uses the
reciprocal form and the CUDA kernel Thomas.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .compute import resolve_device
from .imex import _kahan_add
from .imex_cuda import cuda_error, load_library
from .transport3d import _shift, transport_tend
from .transport3d_stream_cuda import _SLOTS as _STEP_SLOTS, pack_selectors
from .tridiag import pcr_solve

# launches of the CUDA block kernel in this process; callers reset it to 0
# to count a run's launches
transport3d_block_launches = 0

# the coefficient fields the kernel reads from coef_stack; its operand
# slots are the fused step's (transport3d_stream_cuda._SLOTS)
_FIELD_SLOTS = ("wet", "recip_vol", "t_e", "t_n", "t_t", "cond_e", "cond_n")
_ABSENT, _DENSE, _FACTORED = 0, 1, 2


def _chunk(tend_chunk, t_dim):
    chunk = int(tend_chunk) if tend_chunk else (t_dim if t_dim <= 2 else 1)
    if not 1 <= chunk <= t_dim:
        raise ValueError(f"tend_chunk={chunk} outside [1, {t_dim}]")
    return chunk


def _couple_np(couple, t_dim):
    if couple is None:
        return None
    if isinstance(couple, torch.Tensor):
        couple = couple.detach().cpu().numpy()
    couple = np.asarray(couple, np.float64)
    if couple.shape != (t_dim, t_dim):
        raise ValueError("couple must be (tracer, tracer)")
    return couple


def factored_rates(fac, wet):
    """(T,) + wet.shape rate fields a_t wet + b_t wet_surf rebuilt from their
    two scalars a tracer, fac = (a, b) (_factor_rate_field's form), in
    float32 arithmetic as the kernels rebuild them"""
    parts = []
    for a_val, b_val in zip(*fac):
        f = float(np.float32(a_val)) * wet if a_val else torch.zeros_like(wet)
        if b_val:
            f = torch.cat([(f[0] + float(np.float32(b_val)) * wet[0])[None],
                           f[1:]])
        parts.append(f)
    return torch.stack(parts)


def couple_rows(couple_np, surf, wet):
    """(T, ...) surface coupling tendencies wet_surf * sum_u couple[t, u]
    surf[u], the zero couplings skipped, as the kernels sum them"""
    rws = []
    for row in couple_np:
        acc = None
        for c_val, s_u in zip(row, surf):
            if c_val != 0.0:
                term = float(c_val) * s_u
                acc = term if acc is None else acc + term
        rws.append(torch.zeros_like(surf[0]) if acc is None else acc)
    return wet[0] * torch.stack(rws)


def cn_band_increment(y, dlb, dub, diag, half):
    """the Crank-Nicolson increment over h = 2 half of (..., nz, rows, nlon)
    states on the bands dlb, dub and the implicit rate diag (or None): the
    flux-form right-hand side h M y, solved (I - half M) dv = h M y along
    depth by the port's divide-form PCR"""
    d_up = _shift(y, 1, -3) - y   # dub's zero last level
    d_dn = _shift(y, -1, -3) - y  # dlb's zero first level
    m_v = dub * d_up + dlb * d_dn
    b_main = 1.0 + half * (dub + dlb)
    if diag is not None:
        m_v = m_v + diag * y
        b_main = b_main - half * diag

    def col(arr):
        return arr.expand(y.shape).movedim(-3, -1)

    return pcr_solve(col(-half * dlb), col(b_main), col(-half * dub),
                     col((2.0 * half) * m_v)).movedim(-1, -3)


def block3d_steps_plain(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps, *,
                        has_diag=False, has_src=False, diag_fac=None,
                        src_fac=None, couple=None):
    """fn(y, c, coef_stack, dlb, dub[, diag][, src]) -> (y, c) in plain
    PyTorch, in y's dtype on y's device; arguments and shapes as
    build_block3d_steps's (diag / src passed only when present and not
    factored)"""
    coef_names = list(coef_names)
    stream_diag = has_diag and diag_fac is None
    stream_src = has_src and src_fac is None
    n_extra = int(stream_diag) + int(stream_src)
    couple_np = _couple_np(couple, t_dim)
    shape = (t_dim, nz, rows_ext, nlon)
    dt_f = float(np.float32(dt))
    half = float(np.float32(0.5 * dt))

    def fn(y, c, coef_stack, dlb, dub, *extra):
        if len(extra) != n_extra:
            raise ValueError(f"expected {3 + n_extra} coefficient operands, "
                             f"got {3 + len(extra)}")
        for arr in (y, c):
            if tuple(arr.shape) != shape:
                raise ValueError(f"block state has shape {tuple(arr.shape)}, "
                                 f"expected {shape}")
        coef = {name: coef_stack[i] for i, name in enumerate(coef_names)}
        wet = coef["wet"]
        extra = list(extra)
        diag_w = (extra.pop(0) if stream_diag else
                  factored_rates(diag_fac, wet) if has_diag else None)
        src_w = (extra.pop(0) if stream_src else
                 factored_rates(src_fac, wet) if has_src else None)

        def base_tend(y_v):
            out = transport_tend(coef, y_v)
            return out if src_w is None else out + src_w

        for _step in range(k_steps):
            # Heun (explicit trapezoid), the coupling in both stages
            f1 = base_tend(y)
            if couple_np is not None:
                f1 = torch.cat([(f1[:, 0] + couple_rows(couple_np, y[:, 0],
                                                        wet))[:, None],
                                f1[:, 1:]], dim=1)
                c2 = couple_rows(couple_np, y[:, 0] + dt_f * f1[:, 0], wet)
            f2 = base_tend(y + dt_f * f1)
            if couple_np is not None:
                f2 = torch.cat([(f2[:, 0] + c2)[:, None], f2[:, 1:]], dim=1)
            y, c = _kahan_add(y, c, (0.5 * dt_f) * (f1 + f2))
            # Crank-Nicolson(dt), column-local
            y, c = _kahan_add(y, c, cn_band_increment(y, dlb, dub, diag_w,
                                                      half))
        return y, c

    def plain_fn(y, c, coef_stack, dlb, dub, *extra, sel=None):
        # sel, the kernel's packed selectors, is not read: the plain
        # version takes the selectors coef_stack holds
        return fn(y, c, coef_stack, dlb, dub, *extra)

    plain_fn.many = lambda calls, sels=None: [fn(*args) for args in calls]
    return plain_fn


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("transport3d_block", {
        "max_shards": ([], c_int),
        "smem_bytes": ([c_int] * 2, ctypes.c_long),
        "tile": ([ctypes.POINTER(c_int)] * 2, None),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        "occupancy": ([ctypes.c_long, ctypes.POINTER(c_int)], c_int),
        # fields, bufs, opts, n_shards, t_dim, nz, rows, nlon, k_steps, dt,
        # grid, stream
        "launch": ([c_ptr] * 3 + [c_int] * 6 + [ctypes.c_float, c_int, c_ptr],
                   c_int),
    })


# the shards one launch takes (csrc/transport3d_block.cu's kMaxShards)
MAX_SHARDS = 16


class Schedule(NamedTuple):
    """how B7 lays k steps of n_shards slabs on the card: the step tile's
    shared memory, the tiles of one slab, the shards of each launch, each
    launch's persistent blocks and the most tiles one of them takes a step"""
    smem_bytes: int
    tiles_y: int
    tiles_x: int
    groups: tuple
    grids: tuple
    tiles_per_block: tuple


def block_schedule(smem, tile, rows, nlon, n_shards, blocks_per_sm, n_sm,
                   smem_limit, max_shards=MAX_SHARDS):
    """the Schedule of B7 for n_shards (rows, nlon) slabs, whose step tile
    (rows, columns) takes smem bytes of shared memory (both as the kernel's
    library gives them): every shard's tiles in one grid of at most
    blocks_per_sm x n_sm co-resident blocks (a cooperative launch cannot
    take more), max_shards shards a launch.  smem_limit: the bytes one
    block may use.  Raises ValueError, naming the limit, when one tile's
    step does not fit."""
    if smem > smem_limit:
        raise ValueError(
            f"the transport3d_block kernel needs {smem} bytes of shared "
            f"memory a block, over the {smem_limit} bytes one block may use "
            "on this card; split the family, or use "
            "build_sharded_transport3d_year_stream (kernel B6)"
        )
    if blocks_per_sm < 1:
        raise ValueError("no block of the transport3d_block kernel fits an SM")
    tile_y, tile_x = tile
    tiles_y, tiles_x = -(-rows // tile_y), -(-nlon // tile_x)
    groups = tuple(min(max_shards, n_shards - start)
                   for start in range(0, n_shards, max_shards))
    grids = tuple(min(tiles_y * tiles_x * g, blocks_per_sm * n_sm)
                  for g in groups)
    per_block = tuple(-(-tiles_y * tiles_x * g // grid)
                      for g, grid in zip(groups, grids))
    return Schedule(smem, tiles_y, tiles_x, groups, grids, per_block)


def _card(device, t_dim, coupled):
    """(library, shared-memory limit, blocks an SM, SM count, the step
    tile's shared memory, the tile) of the card"""
    lib = _library()
    limit = ctypes.c_int(0)
    err = lib.transport3d_block_smem_optin(device.index, ctypes.byref(limit))
    if err:
        raise cuda_error(lib, "transport3d_block", err,
                         "querying the shared-memory opt-in limit")
    per_sm = ctypes.c_int(0)
    smem = lib.transport3d_block_smem_bytes(t_dim, int(coupled))
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    lib.transport3d_block_tile(ctypes.byref(rows), ctypes.byref(cols))
    if smem <= limit.value:
        with torch.cuda.device(device):
            err = lib.transport3d_block_occupancy(smem, ctypes.byref(per_sm))
        if err:
            raise cuda_error(lib, "transport3d_block", err,
                             "querying the kernel's occupancy")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return lib, limit.value, per_sm.value, n_sm, smem, (rows.value,
                                                        cols.value)


def build_block3d_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps, *,
                        has_diag=False, has_src=False, diag_fac=None,
                        src_fac=None, couple=None, tend_chunk=None, device):
    """fn(y, c, coef_stack, dlb, dub[, diag][, src], sel=None) -> (y, c):
    k_steps x [Heun(dt); CN(dt)] on one halo-extended block, through B7 on
    a CUDA `device` and through block3d_steps_plain on the CPU.

    The JAX function's arguments without vmem_cap and interpret:
      y, c: (t_dim, nz, rows_ext, nlon) float32, contiguous, on `device`
      coef_stack: (n_coef, nz, rows_ext, nlon), the fields named by
          coef_names in order (everything transport_tend reads, 'wet' and
          'recip_vol' included; upwind3 when 'sel3p_e' is among them)
      dlb, dub: (nz, rows_ext, nlon) Crank-Nicolson bands
      diag, src: (t_dim, nz, rows_ext, nlon), passed only when
          has_diag / has_src and no factored form (diag_fac / src_fac) is
          given
    couple: optional (t_dim, t_dim) surface coupling [1/s]; tend_chunk in
    [1, t_dim] (checked only).  sel: optional pack_selectors(wet) of
    coef_stack's wet mask, (nz, rows_ext, nlon) uint8 (read on the card
    only; packed from coef_stack when None).  fn.many([(y, c, coef_stack,
    dlb, dub[, diag][, src]), ...], sels=None) steps several blocks of the
    same shape on one device at once -- on the card the slabs of up to
    MAX_SHARDS shards in one launch, sels their selectors in order -- and
    returns their (y, c) in order.  fn carries
    stream_diag, stream_src, tend_chunk, smem_bytes (0 on the CPU),
    max_shards (None on the CPU) and schedule(n_shards) (None on the CPU).
    """
    chunk = _chunk(tend_chunk, t_dim)
    stream_diag = has_diag and diag_fac is None
    stream_src = has_src and src_fac is None
    couple_np = _couple_np(couple, t_dim)
    k_steps = int(k_steps)
    if k_steps < 1:
        raise ValueError("k_steps must be positive")
    device = resolve_device(device)
    if device.type == "cpu":
        fn = block3d_steps_plain(
            coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps,
            has_diag=has_diag, has_src=has_src, diag_fac=diag_fac,
            src_fac=src_fac, couple=couple)
        fn.smem_bytes, fn.max_shards = 0, None
        fn.schedule = lambda n_shards: None
    else:
        fn = _kernel_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps,
                           has_diag, has_src, diag_fac, src_fac, couple_np,
                           device)
    fn.stream_diag = stream_diag
    fn.stream_src = stream_src
    fn.tend_chunk = chunk
    return fn


def _kernel_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps,
                  has_diag, has_src, diag_fac, src_fac, couple_np, device):
    coef_names = list(coef_names)
    f32 = torch.float32
    shape = (t_dim, nz, rows_ext, nlon)
    stream_diag = has_diag and diag_fac is None
    stream_src = has_src and src_fac is None
    n_extra = int(stream_diag) + int(stream_src)
    upwind3 = "sel3p_e" in coef_names
    for name in ("wet", "recip_vol"):
        if name not in coef_names:
            raise ValueError(f"coef_names lacks {name!r}")
    coupled = couple_np is not None
    lib, limit, per_sm, n_sm, smem, tile = _card(device, t_dim, coupled)

    def schedule(n_shards):
        return block_schedule(smem, tile, rows_ext, nlon, n_shards, per_sm,
                              n_sm, limit)

    schedule(1)  # refuses a tile that does not fit
    rates = None
    if diag_fac is not None or src_fac is not None:
        zeros = [0.0] * t_dim
        dfac = diag_fac if (has_diag and diag_fac is not None) else (zeros,
                                                                     zeros)
        sfac = src_fac if (has_src and src_fac is not None) else (zeros, zeros)
        rates = torch.tensor(np.concatenate([dfac[0], dfac[1], sfac[0],
                                             sfac[1]]).astype(np.float32),
                             device=device)
    couple32 = (None if couple_np is None else
                torch.tensor(couple_np.astype(np.float32), device=device))
    opts = np.array([
        int(upwind3),
        _ABSENT if not has_diag else (_DENSE if stream_diag else _FACTORED),
        _ABSENT if not has_src else (_DENSE if stream_src else _FACTORED),
    ], np.int32)
    dt32 = float(np.float32(dt))

    def check(name, arr, want):
        if not isinstance(arr, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(arr).__name__}")
        if arr.device != device or arr.dtype != f32:
            raise ValueError(f"{name} is {arr.dtype} on {arr.device}; this "
                             f"block takes float32 on {device}")
        if tuple(arr.shape) != want or not arr.is_contiguous():
            raise ValueError(f"{name} has shape {tuple(arr.shape)}"
                             f"{'' if arr.is_contiguous() else ' (strided)'}"
                             f", expected a contiguous {want}")

    def prepare(sel, y, c, coef_stack, dlb, dub, *extra):
        """one shard's operand pointers and its five buffers: the input
        state, two ping-pong states, the carry (a copy, stepped in place)
        and the sweep factors' scratch (gp and cp); sel: the packed
        selectors of coef_stack's wet mask, or None to pack them here"""
        if len(extra) != n_extra:
            raise ValueError(f"expected {3 + n_extra} coefficient operands, "
                             f"got {3 + len(extra)}")
        check("y", y, shape)
        check("c", c, shape)
        check("coef_stack", coef_stack, (len(coef_names),) + shape[1:])
        check("dlb", dlb, shape[1:])
        check("dub", dub, shape[1:])
        fields = {name: coef_stack[coef_names.index(name)]
                  for name in _FIELD_SLOTS if name in coef_names}
        if sel is None:
            sel = pack_selectors(fields["wet"])
        elif (not isinstance(sel, torch.Tensor) or sel.dtype != torch.uint8
              or sel.device != device or tuple(sel.shape) != shape[1:]
              or not sel.is_contiguous()):
            raise ValueError(f"sel must be a contiguous uint8 {shape[1:]} "
                             f"tensor on {device} (pack_selectors)")
        fields.update(dlb=dlb, dub=dub, rates=rates, couple=couple32, sel=sel)
        for pos, name in enumerate(
                [n for n, on in (("diag", stream_diag), ("src", stream_src))
                 if on]):
            check(name, extra[pos], shape)
            fields[name] = extra[pos]
        bufs = (y, torch.empty_like(y), torch.empty_like(y), c.clone(),
                y.new_empty((2,) + shape))
        return fields, bufs

    def many(calls, sels=None):
        global transport3d_block_launches
        sels = [None] * len(calls) if sels is None else list(sels)
        if len(sels) != len(calls):
            raise ValueError(f"{len(sels)} selector fields for "
                             f"{len(calls)} calls")
        prepared = [prepare(sel, *args) for sel, args in zip(sels, calls)]
        sched = schedule(len(prepared))
        start = 0
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for group, grid in zip(sched.groups, sched.grids):
                part = prepared[start:start + group]
                start += group
                ptrs = (ctypes.c_void_p * (len(_STEP_SLOTS) * group))(*(
                    None if fields.get(name) is None
                    else fields[name].data_ptr()
                    for fields, _ in part for name in _STEP_SLOTS))
                bufs = (ctypes.c_void_p * (5 * group))(*(
                    buf.data_ptr() for _, five in part for buf in five))
                err = lib.transport3d_block_launch(
                    ctypes.cast(ptrs, ctypes.c_void_p),
                    ctypes.cast(bufs, ctypes.c_void_p), opts.ctypes.data,
                    group, t_dim, nz, rows_ext, nlon, k_steps, dt32, grid,
                    stream)
                if err:
                    raise cuda_error(lib, "transport3d_block", err,
                                     "transport3d_block cooperative launch")
                transport3d_block_launches += 1
        # the end of k steps lands in the first ping-pong state when k is odd
        return [(bufs[1] if k_steps % 2 else bufs[2], bufs[3])
                for _, bufs in prepared]

    def fn(y, c, coef_stack, dlb, dub, *extra, sel=None):
        return many([(y, c, coef_stack, dlb, dub, *extra)], [sel])[0]

    fn.many = many
    fn.schedule = schedule
    fn.smem_bytes = int(smem)
    fn.max_shards = MAX_SHARDS
    return fn
