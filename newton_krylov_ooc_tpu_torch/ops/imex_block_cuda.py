"""the IMEX step block of the sharded 2D year (kernel B3), beside its plain
PyTorch version.

Port of newton_krylov_ooc_tpu/ops/imex_pallas.py::_block_callable (the
kernel), ::pack_block_consts (the operand packing) and
::build_iage_step_block_pallas (the single-shard wrapper).  A block is
j_steps interior steps, [Heun(dt); CN(dt)] each, of a linear py_driver_2d
family on a closed (C, nz, nx) window -- zero lateral flux outside it --
carrying a Kahan buffer in and out, with step i at t_start + i dt computed
in float32.  parallel/sharded_year.py::build_sharded_year_blocked runs the
interior of a year as such blocks on every (module, space) shard of a
mesh, with windows extended by 2 j_steps exchanged halo columns a side.

`build_iage_step_block(..., device=)` returns fn(y, comp, t_start) ->
(y, comp): on a CUDA device it launches csrc/iage_block.cu (see the note at
the top of that file) and raises if it cannot; on the CPU it is the plain
version.  `build_iage_step_block_plain` is the plain version on any device:
the TPU kernel's arithmetic, lane-packed as it is, its reciprocal-form PCR
included, except that the CN column solve runs in float64, as the kernel's
does: at 256 levels a float32 column solve (PCR or Thomas) loses about
h |M| ~ 6e3 ulps of a rough state's slow modes a step (ROADMAP C).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.py_driver_2d import physics
from .compute import resolve_device
from .imex_cuda import (
    _check_state,
    cuda_error,
    load_library,
    mixing_header,
)

# launches of csrc/iage_block.cu in this process (one per launch, a block
# of j steps may take several); callers reset it to 0 to count a run's
iage_block_launches = 0


def pack_block_consts(vfaces, hfaces, wvel, diag, source, bld_max, dy_r,
                      dz_r, dz_mid, dz_mid_r, depth_mid):
    """numpy packing of one window's static arrays into the lane-packed
    operand tuple of the step block (channel ch's column x at lane
    ch * nx + x; the fused-flux coefficients carry a zero at each channel
    seam): (ca, wvel, diag, src, bld_max, dz_r, dz_mid, dz_mid_r,
    depth_mid, dy_r, cb)

    vfaces, hfaces: (nz, nx+1) face velocity and mixing coefficient (zero
    at physical boundaries and beyond); wvel: (nz+1, nx); diag: (C, nz,
    nx); source: (C,) uniform rates or (C, nz) depth profiles; bld_max,
    dy_r: (nx,); dz_r, depth_mid: (nz,); dz_mid, dz_mid_r: (nz-1,)
    """
    diag = np.asarray(diag, np.float32)
    c_dim, nz, nx = diag.shape
    w_dim = c_dim * nx

    vf = np.asarray(vfaces, np.float32)
    hf = np.asarray(hfaces, np.float32)
    ca_int = 0.5 * vf[:, 1:-1] + hf[:, 1:-1]
    cb_int = 0.5 * vf[:, 1:-1] - hf[:, 1:-1]
    seam = np.zeros((nz, 1), np.float32)
    ca = np.concatenate(([ca_int, seam] * c_dim)[:-1], axis=1)
    cb = np.concatenate(([cb_int, seam] * c_dim)[:-1], axis=1)

    wvel_p = np.tile(np.asarray(wvel, np.float32)[1:-1, :], (1, c_dim))
    dy_r_p = np.tile(np.asarray(dy_r, np.float32).reshape(-1), c_dim)[None, :]
    diag_p = diag.transpose(1, 0, 2).reshape(nz, w_dim)
    source = np.asarray(source, np.float32)
    if source.ndim <= 1:
        # spatially uniform per-channel rate -> (1, W)
        src_p = np.repeat(source.reshape(c_dim), nx)[None, :]
    else:
        # per-channel depth profile (C, nz) -> (nz, W), channel-major like
        # diag_p (e.g. surface-only restoring sources)
        src_p = np.repeat(source.reshape(c_dim, nz).T, nx, axis=1)
    bld_max_p = np.tile(np.asarray(bld_max, np.float32), c_dim)[None, :]
    return (
        ca,
        wvel_p,
        diag_p,
        src_p,
        bld_max_p,
        np.asarray(dz_r, np.float32)[:, None],
        np.asarray(dz_mid, np.float32)[:, None],
        np.asarray(dz_mid_r, np.float32)[:, None],
        np.asarray(depth_mid, np.float32)[:, None],
        dy_r_p,
        cb,
    )


def _pcr_recip_rows(dl, d, du, b):
    """parallel cyclic reduction along the first axis of (n, ...) systems
    (dl[0] and du[-1] unused), one reciprocal a round as the TPU kernel's
    _pcr_minor2(recip=True) has it; out-of-range rows act as identity"""
    n = b.shape[0]

    def sh(arr, s, fill):
        pad = arr.new_full((abs(s),) + arr.shape[1:], fill)
        if s > 0:
            return torch.cat([arr[s:], pad], dim=0)
        return torch.cat([pad, arr[:s]], dim=0)

    a_c, b_c, c_c, r_c = dl, d, du, b
    stride = 1
    while stride < n:
        rb = 1.0 / b_c
        alpha = -a_c * sh(rb, -stride, 1.0)
        gamma = -c_c * sh(rb, stride, 1.0)
        a_n = alpha * sh(a_c, -stride, 0.0)
        c_n = gamma * sh(c_c, stride, 0.0)
        b_c = b_c + alpha * sh(c_c, -stride, 0.0) + gamma * sh(a_c, stride, 0.0)
        r_c = r_c + alpha * sh(r_c, -stride, 0.0) + gamma * sh(r_c, stride, 0.0)
        a_c, c_c = a_n, c_n
        stride *= 2
    return r_c / b_c


def _consts_on(consts, device):
    """pack_block_consts' tuple as contiguous float32 tensors on `device`"""
    return tuple(torch.as_tensor(np.array(c, np.float32),
                                 device=device) for c in consts)


def _check_j(j_steps):
    if int(j_steps) < 1:
        raise ValueError(f"a step block takes j_steps >= 1, got {j_steps}")
    return int(j_steps)


def plain_block(consts, shape, dt, j_steps, *, device):
    """fn(y, comp, t_start) -> (y, comp) over (C, nz, nx) float32 tensors on
    `device`: the plain PyTorch version of the step block for packed
    operands `consts` (numpy, pack_block_consts' tuple); its CN column
    solves run in float64"""
    j_steps = _check_j(j_steps)
    device = resolve_device(device)
    c_dim, nz, nx = shape
    w_dim = c_dim * nx
    f32 = torch.float32
    ca, wv, diag, src, bldmax_p, dzr, dzm, dzmr, edges, dy_rv, cb = _consts_on(
        consts, device)
    abs_wv = wv[:, :nx].abs()
    e_lo, e_hi = edges[:nz - 1], edges[1:]
    e_delta = e_hi - e_lo
    bldmax = bldmax_p[:, :nx]
    zero_row = torch.zeros((1, w_dim), dtype=f32, device=device)
    zero_col = torch.zeros((nz, 1), dtype=f32, device=device)

    def kv_of(t):
        frac = physics.interp(t, physics._BLD_TFRAC, physics._BLD_FRAC)
        bld = physics.BLD_MIN + (bldmax - physics.BLD_MIN) * frac
        x0 = bld - 20.0
        x1 = bld + 20.0
        slope = (physics.VERT_MIX_LOG_DEEP - physics.VERT_MIX_LOG_SHALLOW) / (
            x1 - x0)

        def antider(x):
            c = torch.minimum(torch.maximum(x, x0), x1) - x0
            return 0.5 * c * c + (x1 - x0) * torch.clamp(x - x1, min=0.0)

        num = physics.VERT_MIX_LOG_SHALLOW * e_delta + slope * (
            antider(e_hi) - antider(e_lo))
        coeff = torch.exp(num / e_delta)
        peclet = 0.5 * dzm * abs_wv / coeff
        coeff = coeff * torch.clamp(peclet, min=1.0)
        return (coeff * dzmr).repeat(1, c_dim)             # (nz-1, W)

    f64 = torch.float64
    dzr64, diag64, zero_row64 = dzr.to(f64), diag.to(f64), zero_row.to(f64)
    # the kernel takes dt as a float32
    h64 = float(np.float32(dt))

    def cn_incr(kv, y):
        # in float64 from the float32 state and kv, rounded once
        kv, y = kv.to(f64), y.to(f64)
        up = kv * dzr64[:nz - 1]
        lo = kv * dzr64[1:]
        du = torch.cat([up, zero_row64], dim=0)
        dl = torch.cat([zero_row64, lo], dim=0)
        dmain = -(du + dl) + diag64
        flux = kv * (y[1:] - y[:-1])
        m_v = dzr64 * (torch.cat([flux, zero_row64], dim=0)
                       - torch.cat([zero_row64, flux], dim=0)) + diag64 * y
        rhs = h64 * m_v
        half = 0.5 * h64
        return _pcr_recip_rows(-half * dl, 1.0 - half * dmain, -half * du,
                               rhs).float()

    def tend(y):
        g_int = ca * y[:, :-1] + cb * y[:, 1:]
        g = torch.cat([zero_col, g_int, zero_col], dim=1)
        res = dy_rv * (g[:, :-1] - g[:, 1:])
        wz_int = 0.5 * (y[1:] + y[:-1]) * wv
        wz = torch.cat([zero_row, wz_int, zero_row], dim=0)
        res = res + dzr * (wz[1:] - wz[:-1])
        return res + src

    def kahan(y, c, delta):
        adj = delta + c
        y_new = y + adj
        return y_new, adj - (y_new - y)

    def pack(arr):
        return arr.reshape(c_dim, nz, nx).permute(1, 0, 2).reshape(nz, w_dim)

    def unpack(arr):
        return arr.reshape(nz, c_dim, nx).permute(1, 0, 2).contiguous()

    def block(y, comp, t_start):
        _check_state(y, shape, f32, device)
        _check_state(comp, shape, f32, device)
        t_start = torch.tensor(float(np.float32(t_start)), dtype=f32,
                               device=device)
        y, c = pack(y), pack(comp)
        for i in range(j_steps):
            t = t_start + torch.tensor(float(i), dtype=f32, device=device) * dt
            f1 = tend(y)
            f2 = tend(y + dt * f1)
            y, c = kahan(y, c, 0.5 * dt * (f1 + f2))
            y, c = kahan(y, c, cn_incr(kv_of(t + dt), y))
        return unpack(y), unpack(c)

    return block


def _library():
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    return load_library("iage_block", {
        "smem_bytes": ([c_int] * 2, ctypes.c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        # y_in, c_in, y_out, c_out, ca, cb, wv, diag, src, src_rows,
        # bld_max, dy_r, dz_r, dz_mid, dz_mid_r, depth_mid, header, c_dim,
        # nz, nx, tile, halo, i0, j_steps, t_start, dt, stream
        "launch": ([c_ptr] * 9 + [c_int] + [c_ptr] * 7 + [c_int] * 7
                   + [ctypes.c_float] * 2 + [c_ptr], c_int),
    })


def block_plan(smem_bytes, smem_limit, nz, nx, j_steps):
    """(j_inner, tile): the steps of one launch and the owned columns of
    one CUDA block, for kernel shared memory smem_bytes(nz, width) within
    smem_limit bytes.  The whole window in one block per channel when it
    fits (j_inner = j_steps, tile = nx); otherwise launches of j_inner
    steps whose halo of 4 j_inner loaded columns is at most a quarter of
    what a block holds, and the rest of it owned."""
    if smem_bytes(nz, nx) <= smem_limit:
        return j_steps, nx
    per_col = smem_bytes(nz, 2) - smem_bytes(nz, 1)
    max_cols = (smem_limit - smem_bytes(nz, 1) + per_col) // per_col
    j_inner = min(j_steps, max(1, max_cols // 16))
    tile = max_cols - 4 * j_inner
    if tile < 1:
        raise ValueError(
            f"one column of {nz} levels and its halo need "
            f"{smem_bytes(nz, 5)} bytes of shared memory, over the "
            f"{smem_limit} one block may use"
        )
    return j_inner, tile


def kernel_block(consts, shape, dt, j_steps, *, device, smem_limit=None):
    """fn(y, comp, t_start) -> (y, comp) over (C, nz, nx) float32 tensors on
    the CUDA `device`, through csrc/iage_block.cu: ceil(j_steps / j_inner)
    launches (block_plan), ping-ponged through one scratch pair.
    smem_limit: bytes a block may use (default: the card's opt-in limit;
    a smaller one forces tiles and split steps, for tests)."""
    j_steps = _check_j(j_steps)
    c_dim, nz, nx = shape
    dev = _consts_on(consts, device)
    ca, wv, diag, src, bld_max, dz_r, dz_mid, dz_mid_r, depth_mid, dy_r, cb = dev
    src_rows = int(src.shape[0])
    header = mixing_header().to(torch.float32).to(device)
    lib = _library()
    if smem_limit is None:
        limit = ctypes.c_int(0)
        err = lib.iage_block_smem_optin(device.index, ctypes.byref(limit))
        if err:
            raise cuda_error(lib, "iage_block", err,
                             "querying the shared-memory opt-in limit")
        smem_limit = limit.value
    j_inner, tile = block_plan(lib.iage_block_smem_bytes, smem_limit, nz, nx,
                               j_steps)
    n_launch = -(-j_steps // j_inner)
    dt32 = float(np.float32(dt))
    consts_ptrs = [a.data_ptr() for a in (ca, cb, wv, diag, src)]
    tail_ptrs = [a.data_ptr() for a in (bld_max, dy_r, dz_r, dz_mid,
                                        dz_mid_r, depth_mid, header)]

    def block(y, comp, t_start):
        global iage_block_launches
        _check_state(y, shape, torch.float32, device)
        _check_state(comp, shape, torch.float32, device)
        t0 = float(np.float32(t_start))
        outs = (torch.empty_like(y), torch.empty_like(comp))
        scratch = ((torch.empty_like(y), torch.empty_like(comp))
                   if n_launch > 1 else None)
        src_y, src_c = y, comp
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for r in range(n_launch):
                steps = min(j_inner, j_steps - r * j_inner)
                # the last launch lands in outs
                dst_y, dst_c = outs if (n_launch - 1 - r) % 2 == 0 else scratch
                err = lib.iage_block_launch(
                    src_y.data_ptr(), src_c.data_ptr(), dst_y.data_ptr(),
                    dst_c.data_ptr(), *consts_ptrs, src_rows, *tail_ptrs,
                    c_dim, nz, nx, tile, 2 * steps, r * j_inner, steps, t0,
                    dt32, stream,
                )
                if err:
                    raise cuda_error(lib, "iage_block", err,
                                     "iage_block_kernel launch")
                iage_block_launches += 1
                src_y, src_c = dst_y, dst_c
        return outs

    block.plan = (j_inner, tile)
    # the launches take raw pointers: the block keeps their tensors alive
    block.operands = (*dev, header)
    return block


def step_block(consts, shape, dt, j_steps, *, device, smem_limit=None):
    """the step block for packed operands on `device`: the kernel on a CUDA
    device, the plain version on the CPU"""
    device = resolve_device(device)
    if device.type == "cpu":
        return plain_block(consts, shape, dt, j_steps, device=device)
    return kernel_block(consts, shape, dt, j_steps, device=device,
                        smem_limit=smem_limit)


def _packed(vfaces, hfaces, wvel, diag, source, bld_max, dy_r, dz_r, dz_mid,
            dz_mid_r, depth_mid):
    consts = pack_block_consts(vfaces, hfaces, wvel, diag, source, bld_max,
                               dy_r, dz_r, dz_mid, dz_mid_r, depth_mid)
    return consts, np.asarray(diag).shape


def build_iage_step_block_plain(vfaces, hfaces, wvel, diag, source, bld_max,
                                dy_r, dz_r, dz_mid, dz_mid_r, depth_mid, dt,
                                j_steps, *, device="cpu"):
    """fn(y, comp, t_start) -> (y, comp) over (C, nz, nx) float32 tensors:
    the plain version of the step block on any device (see
    pack_block_consts for the arguments)"""
    consts, shape = _packed(vfaces, hfaces, wvel, diag, source, bld_max, dy_r,
                            dz_r, dz_mid, dz_mid_r, depth_mid)
    return plain_block(consts, shape, dt, j_steps, device=device)


def build_iage_step_block(vfaces, hfaces, wvel, diag, source, bld_max, dy_r,
                          dz_r, dz_mid, dz_mid_r, depth_mid, dt, j_steps, *,
                          device, smem_limit=None):
    """fn(y, comp, t_start) -> (y, comp) over (C, nz, nx) float32 tensors,
    the arguments of build_iage_step_block_pallas: on a CUDA `device`
    through the kernel, on the CPU the plain version.

    Contract (the JAX wrapper's): the year decomposes as CNh, [Heun CNf] x
    (n-1), Heun, CNh; a spatial shard runs the interior steps in blocks of
    j_steps between halo exchanges.  Each Heun consumes two ghost columns a
    side, so a caller exchanging h halo columns may take h // 2 steps a
    block; the block treats its width as a closed domain.  Face arrays must
    carry ZERO at physical domain boundaries and beyond.  smem_limit: see
    kernel_block (CUDA only)."""
    consts, shape = _packed(vfaces, hfaces, wvel, diag, source, bld_max, dy_r,
                            dz_r, dz_mid, dz_mid_r, depth_mid)
    return step_block(consts, shape, dt, j_steps, device=device,
                      smem_limit=smem_limit)
