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
of that file gives the design) in ceil(k / j') launches of j' steps, each
counted in `transport3d_block_launches`; on the CPU it is
`block3d_steps_plain`.  The TPU kernel's VMEM budget (block3d_vmem_bytes,
VmemBudgetError) has no counterpart: `block_plan` sizes the kernel's tiles
from the card's shared memory and refuses, naming the limit, a block that
cannot take one cell.  tend_chunk bounds the TPU kernel's live tracer width;
it is checked here and changes nothing on the card.

`block3d_steps_plain` is the same function in plain PyTorch, in the inputs'
dtype on their device: transport_tend with the selectors coef_stack holds
(the JAX kernel's contract; the CUDA kernel derives them from the window's
wet mask, which differs only in rows that are garbage anyway), and the
port's divide-form PCR for the column solves, where the JAX kernel uses the
reciprocal form and the CUDA kernel Thomas.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .compute import resolve_device
from .imex import _kahan_add
from .imex_cuda import cuda_error, load_library
from .transport3d import _shift, transport_tend
from .tridiag import pcr_solve

# launches of the CUDA block kernel in this process; callers reset it to 0
# to count a run's launches
transport3d_block_launches = 0

# the kernel's operand slots, in csrc/transport3d_block.cu's order
_FIELD_SLOTS = ("wet", "recip_vol", "t_e", "t_n", "t_t", "cond_e", "cond_n")
_SLOTS = _FIELD_SLOTS + ("dlb", "dub", "diag", "src", "rates", "couple")
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

    return fn


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("transport3d_block", {
        "smem_bytes": ([c_int] * 4, ctypes.c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        # y_in, c_in, y_out, c_out, fields, opts, t_dim, nz, rows, nlon,
        # tracers, tile_y, tile_x, halo, j_steps, dt, stream
        "launch": ([c_ptr] * 6 + [c_int] * 9 + [ctypes.c_float, c_ptr],
                   c_int),
    })


def block_plan(smem_bytes, smem_limit, n_sm, nz, tracers, n_groups, rows,
               nlon, k_steps, j_inner=None):
    """(j_inner, tile_y, tile_x): the steps of one launch and one CUDA
    block's owned rows and columns (tile_x = nlon: the whole longitude),
    for a kernel whose block loading ly x lx columns of nz levels for
    `tracers` tracers takes smem_bytes(nz, tracers, ly, lx) bytes, within
    smem_limit; n_groups blocks share each tile (the tracer groups).

    Each candidate is costed as the cell-steps the busiest of the card's
    n_sm SMs works through: ceil(blocks / n_sm) blocks a launch, (j' + 1)
    per loaded cell of a block (its steps, and its load and store); the
    cheapest wins, ties to more steps a launch and larger tiles; j_inner
    fixes the steps a launch (cli/profile_block3d.py times each).  Raises
    ValueError, naming the limit, when a block cannot take one owned cell
    at one step a launch, or no tile takes j_inner steps."""
    per_cell = smem_bytes(nz, tracers, 1, 2) - smem_bytes(nz, tracers, 1, 1)
    fixed = smem_bytes(nz, tracers, 1, 1) - per_cell
    max_cells = (smem_limit - fixed) // per_cell if per_cell else 0

    def loaded(tile_y, tile_x, halo):
        ly = min(rows, tile_y + 2 * halo)
        lx = nlon if tile_x + 2 * halo >= nlon else tile_x + 2 * halo
        return ly, lx

    ly, lx = loaded(1, 1, 4)
    if ly * lx > max_cells:
        need = smem_bytes(nz, tracers, ly, lx)
        raise ValueError(
            f"the transport3d_block kernel needs {need} bytes of shared "
            f"memory for one cell of {nz} levels and "
            f"{tracers} tracer(s) with its one-step halo, over the "
            f"{smem_limit} bytes one block may use on this card; use "
            "build_sharded_transport3d_year_stream (kernel B6), which "
            "streams the slab from device memory"
        )
    best, best_key = None, None
    for j_inner in ([j_inner] if j_inner else range(1, int(k_steps) + 1)):
        halo = 4 * j_inner
        launches = -(-int(k_steps) // j_inner)
        widths = sorted({nlon} | set(range(1, nlon, 1 if nlon <= 64 else 8)))
        for tile_x in widths:
            lx = loaded(1, tile_x, halo)[1]
            if tile_x + 2 * halo >= nlon and tile_x != nlon:
                continue  # the whole longitude loads anyway
            for tile_y in range(1, rows + 1):
                ly = loaded(tile_y, tile_x, halo)[0]
                if ly * lx > max_cells:
                    break
                blocks = (-(-rows // tile_y) * -(-nlon // tile_x)
                          * n_groups)
                cost = (launches * -(-blocks // n_sm) * ly * lx
                        * (j_inner + 1))
                key = (cost, -j_inner, -tile_y * tile_x)
                if best_key is None or key < best_key:
                    best, best_key = (j_inner, tile_y, tile_x), key
    if best is None:
        raise ValueError(
            f"no tile of {nz} levels and {tracers} tracer(s) with a halo of "
            f"{4 * j_inner} cells fits the {smem_limit} bytes one block may "
            "use on this card; take fewer steps a launch"
        )
    return best


def _smem_limit(device):
    """(the kernel's library, the shared memory one block may use on the
    card)"""
    lib = _library()
    limit = ctypes.c_int(0)
    err = lib.transport3d_block_smem_optin(device.index, ctypes.byref(limit))
    if err:
        raise cuda_error(lib, "transport3d_block", err,
                         "querying the shared-memory opt-in limit")
    return lib, limit.value


def card_plan(nz, t_dim, coupled, rows, nlon, k_steps, device, j_inner=None):
    """block_plan for the card of CUDA `device`: its opt-in shared memory
    and SM count; a block takes every tracer when coupled, else one"""
    lib, limit = _smem_limit(device)
    tracers = t_dim if coupled else 1
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return block_plan(lib.transport3d_block_smem_bytes, limit, n_sm, nz,
                      tracers, t_dim // tracers, rows, nlon, k_steps, j_inner)


def build_block3d_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps, *,
                        has_diag=False, has_src=False, diag_fac=None,
                        src_fac=None, couple=None, tend_chunk=None, device,
                        plan=None):
    """fn(y, c, coef_stack, dlb, dub[, diag][, src]) -> (y, c): k_steps x
    [Heun(dt); CN(dt)] on one halo-extended block, through B7 on a CUDA
    `device` and through block3d_steps_plain on the CPU.

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
    [1, t_dim] (checked only).  plan: (j_inner, tile_y, tile_x) instead of
    block_plan's choice (CUDA only; tests use it to hold tiles and splits
    against one block).  fn carries stream_diag, stream_src, tend_chunk,
    smem_bytes (0 on the CPU) and plan (None on the CPU).
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
        fn.smem_bytes, fn.plan = 0, None
    else:
        fn = _kernel_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps,
                           has_diag, has_src, diag_fac, src_fac, couple_np,
                           device, plan)
    fn.stream_diag = stream_diag
    fn.stream_src = stream_src
    fn.tend_chunk = chunk
    return fn


def _kernel_steps(coef_names, nz, rows_ext, nlon, t_dim, dt, k_steps,
                  has_diag, has_src, diag_fac, src_fac, couple_np, device,
                  plan):
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
    lib, limit = _smem_limit(device)
    tracers = t_dim if couple_np is not None else 1
    if plan is None:
        plan = card_plan(nz, t_dim, couple_np is not None, rows_ext, nlon,
                         k_steps, device)
    j_inner, tile_y, tile_x = (int(v) for v in plan)
    tile_x = min(tile_x, nlon)
    if tile_x + 8 * j_inner >= nlon:
        tile_x = nlon  # the halo would meet itself: load the whole longitude
    halo = 4 * j_inner
    ly = min(rows_ext, tile_y + 2 * halo)
    lx = nlon if tile_x == nlon else tile_x + 2 * halo
    smem = lib.transport3d_block_smem_bytes(nz, tracers, ly, lx)
    if smem > limit:
        raise ValueError(
            f"the transport3d_block kernel's tiles of {tile_y} x {tile_x} at "
            f"{j_inner} step(s) a launch need {smem} bytes of shared memory, "
            f"over the {limit} bytes one block may use on "
            f"{torch.cuda.get_device_name(device)}"
        )
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
    n_launch = -(-k_steps // j_inner)
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

    def fn(y, c, coef_stack, dlb, dub, *extra):
        global transport3d_block_launches
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
        fields.update(dlb=dlb, dub=dub, rates=rates, couple=couple32)
        for pos, name in enumerate(
                [n for n, on in (("diag", stream_diag), ("src", stream_src))
                 if on]):
            check(name, extra[pos], shape)
            fields[name] = extra[pos]
        ptrs = (ctypes.c_void_p * len(_SLOTS))(*(
            None if fields.get(name) is None else fields[name].data_ptr()
            for name in _SLOTS))
        outs = (torch.empty_like(y), torch.empty_like(c))
        scratch = ((torch.empty_like(y), torch.empty_like(c))
                   if n_launch > 1 else None)
        src_y, src_c = y, c
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for r in range(n_launch):
                steps = min(j_inner, k_steps - r * j_inner)
                # the last launch lands in outs
                dst_y, dst_c = (outs if (n_launch - 1 - r) % 2 == 0
                                else scratch)
                err = lib.transport3d_block_launch(
                    src_y.data_ptr(), src_c.data_ptr(), dst_y.data_ptr(),
                    dst_c.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
                    opts.ctypes.data, t_dim, nz, rows_ext, nlon, tracers,
                    tile_y, tile_x, 4 * steps, steps, dt32, stream)
                if err:
                    raise cuda_error(lib, "transport3d_block", err,
                                     "transport3d_block kernel launch")
                transport3d_block_launches += 1
                src_y, src_c = dst_y, dst_c
        return outs

    fn.smem_bytes = int(smem)
    fn.plan = (j_inner, tile_y, tile_x)
    fn.n_launch = n_launch
    return fn
