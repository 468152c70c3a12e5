"""the IMEX step blocks of the sharded 2D year (kernel B3), beside their
plain PyTorch version.

Port of newton_krylov_ooc_tpu/ops/imex_pallas.py::_block_callable (the
kernel), ::pack_block_consts (the operand packing) and
::build_iage_step_block_pallas (the single-shard wrapper).  A block is
j_steps interior steps, [Heun(dt); CN(dt)] each, of a linear py_driver_2d
family on a closed (C, nz, nx) window -- zero lateral flux outside it --
carrying a Kahan buffer in and out, with step i at t_start + i dt computed
in float32.  parallel/sharded_year.py::build_sharded_year_blocked runs the
interior of a year as such blocks on every (module, space) shard of a
mesh, with windows extended by 2 j_steps halo columns a side.

On the card, csrc/iage_block.cu (see the note at the top of that file)
runs many such blocks in one cooperative launch: `SlabRun` holds the
slabs of one launch -- the shards of a card, and ghost slabs beside a
shard whose neighbour is on another device -- with their state buffers,
and steps them all for any span of a year, exchanging halos through
device memory; `block_plan` sizes its tiles so that all of them are on
the card at once.  `build_iage_step_block(..., device=)` returns fn(y,
comp, t_start) -> (y, comp): on a CUDA device one launch over the window
as one slab (and raises if it cannot); on the CPU the plain version.
`build_iage_step_block_plain` is the plain version on any device: the TPU
kernel's arithmetic, lane-packed as it is, its reciprocal-form PCR
included, except that the CN column solve runs in float64, as the
kernel's does: at 256 levels a float32 column solve (PCR or Thomas) loses
about h |M| ~ 6e3 ulps of a rough state's slow modes a step (ROADMAP C).
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

# launches of csrc/iage_block.cu in this process (one a step block, one a
# blocked year's interior on one card); callers reset it to 0 to count a
# run's
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
    c_int, c_ptr, c_long = ctypes.c_int, ctypes.c_void_p, ctypes.c_long
    return load_library("iage_block", {
        "max_levels": ([], c_int),
        "smem_bytes": ([c_int] * 2, c_long),
        "smem_optin": ([c_int, ctypes.POINTER(c_int)], c_int),
        "occupancy": ([c_int, c_long, ctypes.POINTER(c_int)], c_int),
        "slab_bytes": ([], c_int),
        "pack_slabs": ([c_ptr, c_ptr, c_int, c_ptr], None),
        # slabs, tiles, n_tiles, dz_r, dz_mid, dz_mid_r, depth_mid, header,
        # t_block, c_dim, nz, width_max, k_block, j_int, g0, n_steps,
        # in_buf, dt, stream
        "launch": ([c_ptr, c_ptr, c_int] + [c_ptr] * 6 + [c_int] * 8
                   + [ctypes.c_float, c_ptr], c_int),
    })


# the fewest owned columns a tile takes, where the slabs are that wide: a
# narrower tile spends more of its shared memory and work on its halo
MIN_TILE = 16


def block_plan(smem_bytes, smem_limit, nz, widths, c_dim, k_steps,
               capacity):
    """(j_int, tile) of B3's launch over slabs of `widths` columns and
    c_dim channels: the tile of the fewest owned columns (at least
    MIN_TILE, or the widest slab) whose tiles all fit on the card at once
    -- c_dim * sum(ceil(w / tile)) blocks within capacity(smem) co-resident
    blocks -- and the steps between halo exchanges, j_int <= k_steps, the
    most whose halo of 2 j_int columns a side is at most half the tile and
    whose region of tile + 4 j_int columns fits smem_bytes(nz, width)
    within smem_limit bytes.  Raises ValueError, naming the limit, when no
    tile fits."""
    widest = max(widths)
    for tile in range(min(MIN_TILE, widest), widest + 1):
        j_int = next((j for j in range(min(k_steps, max(1, tile // 4)), 0, -1)
                      if smem_bytes(nz, tile + 4 * j) <= smem_limit), 0)
        if not j_int:
            raise ValueError(
                f"a tile of {tile} columns of {nz} levels and its halo need "
                f"{smem_bytes(nz, tile + 4)} bytes of shared memory, over "
                f"the {smem_limit} one block may use"
            )
        blocks = c_dim * sum(-(-w // tile) for w in widths)
        held = capacity(smem_bytes(nz, tile + 4 * j_int))
        if blocks <= held:
            return j_int, tile
    raise ValueError(
        f"the year's {c_dim} channels of {sum(widths)} columns need "
        f"{blocks} tiles of {widest} columns at once, over the {held} "
        "blocks the card holds at once: use fewer shards or channels a card"
    )


def tile_table(widths, c_dim, tile):
    """(slab, channel, x0, x1) of every tile, one a CUDA block, as int32"""
    return np.array([(q, ch, x0, min(w, x0 + tile))
                     for q, w in enumerate(widths) for ch in range(c_dim)
                     for x0 in range(0, w, tile)], np.int32).reshape(-1, 4)


class SlabRun:
    """kernel B3 on one CUDA device: the slabs of one launch group, their
    state buffers (two of y and two of the carry a slab, (C, nz, w)), and
    their descriptors and tiles in device memory, made once.

    specs: per slab a dict of `consts` (_consts_on of the shard window's
    pack_block_consts tuple), `w` (columns), `xoff` (the window column of
    the slab's column 0) and `left`, `right` (neighbour slab indices, -1
    closed).  launch(g0, n_steps, in_buf, t_block) steps every slab from
    buffer in_buf and returns the buffer the state ends in."""

    def __init__(self, specs, c_dim, nz, dt, k_block, device, *,
                 smem_limit=None):
        lib = self.lib = _library()
        if nz > lib.iage_block_max_levels():
            raise ValueError(f"the iage_block kernel takes at most "
                             f"{lib.iage_block_max_levels()} levels, got {nz}")
        if smem_limit is None:
            limit = ctypes.c_int(0)
            err = lib.iage_block_smem_optin(device.index, ctypes.byref(limit))
            if err:
                raise cuda_error(lib, "iage_block", err,
                                 "querying the shared-memory opt-in limit")
            smem_limit = limit.value
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count

        def capacity(smem):
            per_sm = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.iage_block_occupancy(nz, smem, ctypes.byref(per_sm))
            if err:
                raise cuda_error(lib, "iage_block", err,
                                 "querying the kernel's occupancy")
            return per_sm.value * n_sm

        widths = [spec["w"] for spec in specs]
        self.plan = block_plan(lib.iage_block_smem_bytes, smem_limit, nz,
                               widths, c_dim, k_block, capacity)
        self.j_int, tile = self.plan
        self.width_max = tile + 4 * self.j_int
        tiles = tile_table(widths, c_dim, tile)
        self.n_tiles = len(tiles)
        self.device, self.c_dim, self.nz, self.k_block = (device, c_dim, nz,
                                                          int(k_block))
        self.dt32 = float(np.float32(dt))
        f32 = torch.float32
        self.y = [[torch.zeros((c_dim, nz, w), dtype=f32, device=device)
                   for _ in range(2)] for w in widths]
        self.c = [[torch.zeros_like(pair[0]) for _ in range(2)]
                  for pair in self.y]
        ptrs, ints = [], []
        for q, spec in enumerate(specs):
            ca, wv, diag, src, bld_max, _, _, _, _, dy_r, cb = spec["consts"]
            ptrs += [buf.data_ptr() for buf in (*self.y[q], *self.c[q],
                                                ca, cb, wv, diag, src,
                                                bld_max, dy_r)]
            ints += [spec["w"], spec["xoff"], int(dy_r.shape[1]) // c_dim,
                     spec["left"], spec["right"], int(src.shape[0])]
        raw = ctypes.create_string_buffer(lib.iage_block_slab_bytes()
                                          * len(specs))
        lib.iage_block_pack_slabs((ctypes.c_void_p * len(ptrs))(*ptrs),
                                  (ctypes.c_int * len(ints))(*ints),
                                  len(specs), raw)
        self.slabs = torch.frombuffer(bytearray(raw.raw),
                                      dtype=torch.uint8).to(device)
        self.tiles = torch.as_tensor(tiles, device=device)
        level = specs[0]["consts"][5:9]  # dz_r, dz_mid, dz_mid_r, depth_mid
        self.header = mixing_header().to(f32).to(device)
        self.level_ptrs = [a.data_ptr() for a in level] + [
            self.header.data_ptr()]
        # the launches take raw pointers: keep their tensors alive
        self.operands = [spec["consts"] for spec in specs]

    def launch(self, g0, n_steps, in_buf, t_block):
        """steps g0 .. g0 + n_steps - 1 of every slab from buffer in_buf,
        with t_block the float32 start time of each block of k_block steps
        (a tensor on the device); returns the buffer the state ends in"""
        global iage_block_launches
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self.lib.iage_block_launch(
                self.slabs.data_ptr(), self.tiles.data_ptr(), self.n_tiles,
                *self.level_ptrs, t_block.data_ptr(), self.c_dim, self.nz,
                self.width_max, self.k_block, self.j_int, int(g0),
                int(n_steps), int(in_buf), self.dt32, stream)
        if err:
            raise cuda_error(self.lib, "iage_block", err,
                             "iage_block cooperative launch")
        iage_block_launches += 1
        return (in_buf + -(-int(n_steps) // self.j_int)) % 2


def kernel_block(consts, shape, dt, j_steps, *, device, smem_limit=None):
    """fn(y, comp, t_start) -> (y, comp) over (C, nz, nx) float32 tensors on
    the CUDA `device`, through csrc/iage_block.cu: one cooperative launch
    over the window, closed at both edges, as one slab (block_plan's tiles,
    halos exchanged every j_int steps).  smem_limit: bytes a block may use
    (default: the card's opt-in limit; a smaller one forces narrower tiles
    and shorter intervals, for tests)."""
    j_steps = _check_j(j_steps)
    c_dim, nz, nx = shape
    dev = _consts_on(consts, device)
    run = SlabRun([dict(consts=dev, w=nx, xoff=0, left=-1, right=-1)],
                  c_dim, nz, dt, j_steps, device, smem_limit=smem_limit)

    def block(y, comp, t_start):
        _check_state(y, shape, torch.float32, device)
        _check_state(comp, shape, torch.float32, device)
        run.y[0][0].copy_(y)
        run.c[0][0].copy_(comp)
        t_block = torch.tensor([float(np.float32(t_start))],
                               dtype=torch.float32, device=device)
        out = run.launch(0, j_steps, 0, t_block)
        # the run's buffers are stepped again by the next call
        return run.y[0][out].clone(), run.c[0][out].clone()

    block.plan = run.plan
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
