"""the 3D offline IRF-transport family on a latitude-sharded mesh: the
per-step and streaming sharded years, and the in-core solver kernel.

Port of newton_krylov_ooc_tpu/parallel/sharded_transport3d.py: HALO,
_extended_slices, build_sharded_transport3d_year (the per-step year),
build_sharded_transport3d_year_stream (the streaming year, kernel B6 on
each shard) and ShardedTransport3dKernel with its reduction helpers
(_region_reduction_arrays_3d, _dot_pure_3d, _broadcast_pure_3d).  The
decomposition is the JAX package's:

  * the implicit vertical solves are column-local and stay in a shard;
  * the latitude of the (nz, nlat, nlon) grid splits over the mesh's
    'space' axis; each shard holds its coefficients extended past its
    block (zero-padded past the physical latitude edges), and its state's
    halo rows are copied from its neighbours' blocks -- zeros at the
    physical edges -- so the plain stencil on the extended block, kept on
    its interior, is the global stencil;
  * on a mesh with a 'space_x' axis the longitude splits too, and its
    halos wrap periodically; the longitude exchange runs on the
    latitude-extended block, so corner cells arrive filled.

The mesh is parallel/mesh.py's, in one process; the halo exchanges are
copies between shard tensors (moved with .to(device) where the devices
differ).  torch.distributed and NCCL are ROADMAP A5.1.  The per-step year
stacks the shards that share a device into one tensor, so its tendency
and column solves run once per device and step, whatever the shard
count.

The TPU path splits a family that overflows one core's VMEM into
per-module kernels (transport3d_pallas.py's VmemBudgetError,
megakernel_fits_vmem).  Hopper's kernel keeps its state in device memory,
so the whole family batch runs in one year call and that split has no
counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops.compute import resolve_device
from ..ops.imex import _kahan_add, cn_vertical_increment
from ..ops.tridiag import pcr_solve
from ..ops.transport3d import (
    STENCIL_RADIUS,
    assemble_rate_fields,
    build_transport3d,
    interp_month,
    mask_vmix_coeff,
    mean_transport_coef,
    transport_stencil_coef,
    transport_tend,
    transport_tridiag_bands,
    vmix_vertical_coeff,
)
from ..ops.transport3d_block_cuda import (
    _chunk,
    block3d_steps_plain,
    build_block3d_steps,
    cn_band_increment,
    couple_rows,
    factored_rates,
)
from ..ops.transport3d_cuda import (
    SEC_PER_YEAR,
    _cn_bands,
    _couple,
    _season,
    _tensor,
    build_transport3d_year,
    build_transport3d_year_plain,
    season_samples,
    year_frac,
)
from ..ops.transport3d_stream_cuda import (
    _FACES,
    _factor_rate_field,
    pack_selectors,
)
from ..ops.transport3d_sweep_cuda import build_stream_sweep, stream_sweep_plain
from ..utils.regions import region_mean_weights
from ..models.py_driver_2d.phosphorus import DEFAULT_PARAMS
from ..ops.banded import banded_lu_factor_blocks, banded_lu_solve_blocks
from .mesh import gather_grid, grid_devices, make_mesh, shard_grid
from .sharded_year import (
    PHOSPHORUS_PROFILES,
    _ShardedKernelInterface,
    phosphorus_column_bands,
    phosphorus_jvp,
    phosphorus_terms,
    phosphorus_uptake_slope,
    replay_steps,
)

HALO = 2  # upwind3 reaches two rows past a face
CPU = torch.device("cpu")


def _extended_slices(arr, n_space, nl_loc, n_x=None, nx_loc=None):
    """stack of per-shard blocks extended by HALO cells each side.

    Latitude (axis -2) extensions are zero-padded past the physical
    boundaries; longitude (axis -1) extensions, taken only when the mesh
    has a zonal axis (n_x is not None), wrap periodically.  Returns
    (n_space, ..., nl_loc + 2*HALO, nlon) for a 1-D decomposition and
    (n_space, n_x, ..., nl_loc + 2*HALO, nx_loc + 2*HALO) for 2-D; leading
    axes (depth, a seasonal time axis) ride along unchanged."""
    pad = [(0, 0)] * arr.ndim
    pad[-2] = (HALO, HALO)
    padded = np.pad(arr, pad)
    if n_x is None:
        return np.stack([
            padded[..., s * nl_loc:s * nl_loc + nl_loc + 2 * HALO, :]
            for s in range(n_space)
        ])
    pad_x = [(0, 0)] * arr.ndim
    pad_x[-1] = (HALO, HALO)
    padded = np.pad(padded, pad_x, mode="wrap")
    return np.stack([
        np.stack([
            padded[..., sy * nl_loc:sy * nl_loc + nl_loc + 2 * HALO,
                   sx * nx_loc:sx * nx_loc + nx_loc + 2 * HALO]
            for sx in range(n_x)
        ])
        for sy in range(n_space)
    ])


def _np64(arr):
    """a tensor or an array as a float64 numpy array"""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().to(torch.float64).numpy()
    return np.asarray(arr, np.float64)


def build_sharded_transport3d_year(mesh, coef, kv, dz_r, diag, src, t_span,
                                   n_steps, couple=None, local_tend=None,
                                   local_data=None):
    """the per-step sharded 3D year: ops/imex.py::imex_year on every shard,
    with a depth-HALO latitude halo (and, on a space_x mesh, a periodic
    longitude halo) copied from the neighbours at every explicit stage.

    mesh: parallel/mesh.py Mesh with a 'space' (latitude) axis and
        optionally a 'space_x' (longitude) axis; it replicates over
        'module' (grid_devices)
    coef: the port's coefficient dict (ops/transport3d.py::
        build_transport3d), steady or seasonal face fields; sliced into
        extended shard blocks here
    kv: (nz-1, nlat*nlon) or seasonal (n_time, nz-1, nlat*nlon); dz_r: (nz,)
    diag, src: (T, nz, nlat*nlon) implicit local rates, explicit sources
    couple: optional (T, T) surface gas-exchange coupling [1/s]; it is
        pointwise in the horizontal, so shard-local
    local_tend: optional COLUMN-LOCAL extra tendency,
        local_tend(t, y_local, data_local) -> y_local's shape, y_local
        (T, nz, nh_loc) with the shard's columns flat
    local_data: dict of global (..., nlat, nlon) arrays handed to
        local_tend as the shard's interior blocks, flat (..., nh_loc)
    Returns year(y) for y (T, nz, nlat, nlon) on any device, run in y's
    float dtype; the result lies on the mesh's first device.  When every
    shard lies on one CUDA device, the interior steps replay a CUDA graph
    of one step (sharded_year.py::replay_steps), forward-mode tangents
    included, captured at the year's first call of each kind and kept.
    """
    n_space = mesh.shape["space"]
    split_x = "space_x" in mesh.shape
    n_x = mesh.shape["space_x"] if split_x else 1
    wet_np = _np64(coef["wet"])
    nz, nlat, nlon = wet_np.shape
    if nlat % n_space != 0:
        raise ValueError(f"nlat {nlat} does not split over {n_space} shards")
    nl_loc = nlat // n_space
    if nl_loc < HALO:
        raise ValueError(
            f"latitude block {nl_loc} shorter than the halo depth {HALO}")
    if nlon % n_x != 0:
        raise ValueError(f"nlon {nlon} does not split over {n_x} shards")
    nx_loc = nlon // n_x
    if n_x > 1 and nx_loc < HALO:
        raise ValueError(
            f"longitude block {nx_loc} shorter than the halo depth {HALO}")
    nh_loc = nl_loc * nx_loc
    x0 = HALO if split_x else 0  # first interior column of an extended block
    ext_cols = nx_loc + 2 * x0
    diag = _np64(diag)
    t_dim = diag.shape[0]
    src = _np64(src)

    devs = grid_devices(mesh)
    shards = [(sy, sx) for sy in range(n_space) for sx in range(n_x)]
    # the shards that share a device run as one stacked tensor, in mesh order
    groups = {}
    for idx, (sy, sx) in enumerate(shards):
        groups.setdefault(devs[sy][sx], []).append(idx)
    where = {shards[idx]: (dev, pos) for dev, members in groups.items()
             for pos, idx in enumerate(members)}

    def at(per_device, sy, sx):
        """shard (sy, sx)'s block of a {device: stacked blocks} dict"""
        dev, pos = where[(sy, sx)]
        return per_device[dev][pos]

    names = [name for name, arr in sorted(coef.items()) if arr is not None]
    seasonal = {name for name in names
                if name in _FACES and coef[name].ndim == 4}
    ext = {name: _extended_slices(_np64(coef[name]), n_space, nl_loc,
                                  n_x if split_x else None, nx_loc)
           for name in names}

    def block(stack, idx):
        sy, sx = shards[idx]
        return stack[sy, sx] if split_x else stack[sy]

    def interior(arr, idx):
        """the shard's (..., nl_loc * nx_loc) block of (..., nlat, nlon)"""
        sy, sx = shards[idx]
        blk = arr[..., sy * nl_loc:(sy + 1) * nl_loc,
                  sx * nx_loc:(sx + 1) * nx_loc]
        return blk.reshape(blk.shape[:-2] + (nh_loc,))

    kv_np = _np64(kv)
    kv4 = kv_np.reshape(kv_np.shape[:-1] + (nlat, nlon))
    diag4 = diag.reshape(t_dim, nz, nlat, nlon)
    src4 = src.reshape(t_dim, nz, nlat, nlon)
    wet_surf = wet_np[0][None]
    data_np = {name: np.array(_np64(arr))
               for name, arr in (local_data or {}).items()}
    graphs = {}   # replay_steps' captured steps, kept across calls

    @functools.lru_cache(maxsize=None)
    def consts(dtype):
        """per device: the stacked operands of its shards, in dtype"""
        out = {}
        for dev, members in groups.items():
            def stack(fn, axis=0):
                return torch.as_tensor(
                    np.ascontiguousarray(np.stack([fn(i) for i in members],
                                                  axis=axis)),
                    dtype=dtype, device=dev)

            # coefficient blocks (n_g, 1, nz, rows, cols); a seasonal face
            # keeps its month axis first: (n_time, n_g, 1, nz, rows, cols)
            coef_g = {
                name: (stack(lambda i: block(ext[name], i), axis=1)[:, :, None]
                       if name in seasonal
                       else stack(lambda i: block(ext[name], i))[:, None])
                for name in names
            }
            kv_axis = 1 if kv_np.ndim == 3 else 0
            out[dev] = {
                "coef": coef_g,
                "kv": stack(lambda i: interior(kv4, i),
                            axis=kv_axis).unsqueeze(kv_axis + 1),
                "diag": stack(lambda i: interior(diag4, i)),
                "src": stack(lambda i: interior(src4, i)),
                "wet_surf": stack(lambda i: interior(wet_surf, i)),
                "dz_r": torch.tensor(_np64(dz_r), dtype=dtype, device=dev),
                "couple": (None if couple is None else
                           torch.tensor(_np64(couple), dtype=dtype,
                                        device=dev)),
                "data": [{name: torch.as_tensor(interior(arr, i), dtype=dtype,
                                                device=dev)
                          for name, arr in data_np.items()} for i in members],
                "t0": torch.tensor(t_span[0], dtype=dtype, device=dev),
                "dt": torch.tensor((t_span[1] - t_span[0]) / n_steps,
                                   dtype=dtype, device=dev),
            }
        return out

    @functools.lru_cache(maxsize=None)
    def ext_bufs(dtype, tangent):
        """per device: its shards' halo-extended state blocks (tangent:
        their forward-mode tangents), kept across calls -- a kept step graph
        reads and writes these very buffers; the halo rows past the physical
        edges are never written and stay 0"""
        return {dev: torch.zeros((len(members), t_dim, nz, nl_loc + 2 * HALO,
                                  ext_cols), dtype=dtype, device=dev)
                for dev, members in groups.items()}

    def exchange(exts):
        """fill every extended block's halos from its neighbours' blocks:
        latitude first (the physical edges keep the zeros the buffers
        start with), then longitude from the latitude-extended blocks"""
        interior_cols = slice(x0, x0 + nx_loc)
        for sy, sx in shards:
            e = at(exts, sy, sx)
            if sy > 0:
                e[..., :HALO, interior_cols].copy_(
                    at(exts, sy - 1, sx)[..., nl_loc:nl_loc + HALO,
                                         interior_cols])
            if sy < n_space - 1:
                e[..., nl_loc + HALO:, interior_cols].copy_(
                    at(exts, sy + 1, sx)[..., HALO:2 * HALO, interior_cols])
        if split_x:
            for sy, sx in shards:
                e = at(exts, sy, sx)
                e[..., :HALO].copy_(
                    at(exts, sy, (sx - 1) % n_x)[..., nx_loc:nx_loc + HALO])
                e[..., nx_loc + HALO:].copy_(
                    at(exts, sy, (sx + 1) % n_x)[..., HALO:2 * HALO])

    def year(y0):
        if not (isinstance(y0, torch.Tensor) and y0.is_floating_point()):
            raise ValueError("y0 must be a floating-point tensor")
        if tuple(y0.shape) != (t_dim, nz, nlat, nlon):
            raise ValueError(f"y0 has shape {tuple(y0.shape)}, expected "
                             f"{(t_dim, nz, nlat, nlon)}")
        dtype = y0.dtype
        k = consts(dtype)
        blocks = shard_grid(mesh, y0)
        ys = {dev: torch.stack([blocks[sy][sx].reshape(t_dim, nz, nh_loc)
                                for sy, sx in (shards[i] for i in members)])
              for dev, members in groups.items()}
        exts = ext_bufs(dtype, False)
        if fwAD.unpack_dual(y0).tangent is not None:
            exts = {dev: fwAD.make_dual(ext, ext_bufs(dtype, True)[dev])
                    for dev, ext in exts.items()}

        def tend_all(t_of, ys):
            for dev, y in ys.items():
                exts[dev][..., HALO:HALO + nl_loc, x0:x0 + nx_loc].copy_(
                    y.reshape(y.shape[:-1] + (nl_loc, nx_loc)))
            exchange(exts)
            out = {}
            for dev, y in ys.items():
                kd, t = k[dev], t_of(dev)
                frac = year_frac(t)
                c_t = {name: interp_month(arr, frac) if name in seasonal
                       else arr for name, arr in kd["coef"].items()}
                tend = transport_tend(c_t, exts[dev])[
                    ..., HALO:HALO + nl_loc, x0:x0 + nx_loc]
                tend = tend.reshape(y.shape) + kd["src"]
                if kd["couple"] is not None:
                    tend[:, :, 0, :] += kd["wet_surf"] * (
                        kd["couple"] @ y[:, :, 0, :])
                if local_tend is not None:
                    tend = tend + torch.stack([
                        local_tend(t, y[pos], kd["data"][pos])
                        for pos in range(y.shape[0])])
                out[dev] = tend
            return out

        def cn_all(t_of, ys, cs, h_of):
            out_y, out_c = {}, {}
            for dev, y in ys.items():
                kd, t = k[dev], t_of(dev)
                kv_t = (interp_month(kd["kv"], year_frac(t))
                        if kv_np.ndim == 3 else kd["kv"])
                incr = cn_vertical_increment(kv_t, kd["diag"], kd["dz_r"], y,
                                             h_of(dev))
                out_y[dev], out_c[dev] = _kahan_add(y, cs[dev], incr)
            return out_y, out_c

        def heun(t_of, ys, cs):
            # Heun (explicit trapezoid) for the non-stiff terms
            f1 = tend_all(t_of, ys)
            stage = {dev: y + k[dev]["dt"] * f1[dev] for dev, y in ys.items()}
            f2 = tend_all(lambda dev: t_of(dev) + k[dev]["dt"], stage)
            out_y, out_c = {}, {}
            for dev, y in ys.items():
                out_y[dev], out_c[dev] = _kahan_add(
                    y, cs[dev], 0.5 * k[dev]["dt"] * (f1[dev] + f2[dev]))
            return out_y, out_c

        def t0(dev):
            return k[dev]["t0"]

        def dt(dev):
            return k[dev]["dt"]

        def step(t_of, ys, cs):
            """one interior step, Heun then CN over dt, from time t_of"""
            ys, cs = heun(t_of, ys, cs)
            return cn_all(lambda dev: t_of(dev) + dt(dev), ys, cs, dt)

        # Strang splitting with merged interior half-steps, as imex_year:
        #   CNh(t0) H(t0) CNf(t1) H(t1) ... CNf(t_{n-1}) H(t_{n-1}) CNh(t_n)
        cs = {dev: torch.zeros_like(y) for dev, y in ys.items()}
        ys, cs = cn_all(t0, ys, cs, lambda dev: 0.5 * dt(dev))
        devices = list(ys)
        if len(devices) == 1 and devices[0].type == "cuda" and n_steps > 2:
            (dev,) = devices

            def dev_step(t, state):
                y_s, c_s = step(lambda _: t, {dev: state[0]}, {dev: state[1]})
                return [y_s[dev], c_s[dev]]

            ys[dev], cs[dev] = replay_steps(dev_step, [ys[dev], cs[dev]],
                                            t0(dev), dt(dev), n_steps - 1,
                                            graphs)
        else:
            for ind in range(n_steps - 1):
                ys, cs = step(lambda dev, ind=ind: t0(dev) + ind * dt(dev),
                              ys, cs)

        def t_last(dev):
            return t0(dev) + (n_steps - 1) * dt(dev)

        ys, cs = heun(t_last, ys, cs)
        ys, _ = cn_all(lambda dev: t_last(dev) + dt(dev), ys, cs,
                       lambda dev: 0.5 * dt(dev))

        return gather_grid(mesh, [
            [at(ys, sy, sx).reshape(t_dim, nz, nl_loc, nx_loc)
             for sx in range(n_x)] for sy in range(n_space)])

    return year


def _halo_rows(steps_per_sweep):
    """the stream sweep's halo for k steps a sweep: each step spends
    2 * STENCIL_RADIUS rows of validity a side (two radii per Heun step),
    padded up to the TPU's 8-row float32 sublane tile as the JAX package
    pads it (transport3d_stream_pallas.py::_halo_rows), so that the
    refusals match; on the card the floor costs at most 4 recomputed rows
    a side"""
    creep = 2 * STENCIL_RADIUS * int(steps_per_sweep)
    return max(8, -(-creep // 8) * 8)


def _exchange(bufs, halo, nl_loc, depth=None):
    """fill the `depth` (default: all `halo`) halo rows a side next to each
    latitude slab's interior from its neighbours' interior rows, zeros past
    the physical edges; bufs: the mesh's slabs (..., halo + nl_loc + halo,
    nlon) in latitude order, on any devices"""
    depth = halo if depth is None else depth
    top = halo + nl_loc
    for s, buf in enumerate(bufs):
        south = buf[..., halo - depth:halo, :]
        north = buf[..., top:top + depth, :]
        if s > 0:
            south.copy_(bufs[s - 1][..., top - depth:top, :])
        else:
            south.zero_()
        if s < len(bufs) - 1:
            north.copy_(bufs[s + 1][..., halo:halo + depth, :])
        else:
            north.zero_()


def build_sharded_transport3d_year_stream(
    mesh, coef, kv, dz_r, diag, src, t_span, n_steps, *, block_rows=16,
    steps_per_sweep=1, recip_area=None, recip_dz=None, tend_chunk=None,
    couple=None, t_dim=None, period=SEC_PER_YEAR, stencil=False, plain=False,
):
    """the streaming sharded 3D year: one sweep of steps_per_sweep steps on
    every shard's halo-extended latitude slab (kernel B6,
    ops/transport3d_sweep_cuda.py, on a CUDA shard; its plain version on a
    CPU shard), then the halo rows of the state and of the Kahan carry
    copied from the latitude neighbours, n_steps / steps_per_sweep + 1
    sweeps a year.

    Arguments as the JAX function's, without `interpret` (the mesh decides
    where each shard runs) and with the same refusals in the same words:
    latitude ('space') meshes only, float32, block_rows dividing the
    per-shard latitude, steps_per_sweep dividing n_steps (1 for a seasonal
    circulation, and dt <= period/n_time), a halo of _halo_rows rows no
    deeper than a shard, stencil only for a steady circulation.
    block_rows and tend_chunk choose the TPU kernel's schedule and are only
    checked here: Hopper's kernel tiles the whole slab.  Modes are B5's
    (ops/transport3d_stream_cuda.py): upwind3 or centred flux form, the
    13-offset stencil of the global transport_stencil_coef, factored or
    dense rate fields, recip_vol rebuilt from recip_area and recip_dz,
    seasonal faces and kv, the (T, T) coupling.  Time samples follow the
    port's plain year (season_samples), as B5's do.  plain=True runs every
    shard through stream_sweep_plain on its device, the card's included:
    the reference B6 is held against.

    Returns year(y) for y (T, nz, nlat, nlon) on any device, cast to
    float32; the result lies on the mesh's first device.  The year carries
    halo, seasonal, stencil, stream_diag, stream_src (as the JAX year's),
    n_sweeps, halo_copies (tensor copies a year) and halo_bytes (bytes they
    move), and sweeps (one per shard).
    """
    f32 = torch.float32
    n_space = mesh.shape["space"]
    if mesh.shape.get("space_x", 1) != 1:
        raise ValueError(
            "the streaming year shards latitude only; drop the 'space_x' "
            "mesh axis or use build_sharded_transport3d_year"
        )
    kv32 = _tensor(kv, f32, CPU)
    n_time = _season(coef, kv32)
    seasonal = n_time is not None
    if stencil and seasonal:
        raise ValueError(
            "stencil streaming collapses a STEADY operator; use the "
            "upwind3 streaming path for seasonal circulations"
        )
    wet_np = _np64(coef["wet"]).astype(np.float32)
    nz, nlat, nlon = wet_np.shape
    if nlat % n_space:
        raise ValueError(f"nlat {nlat} does not split over {n_space} shards")
    nl_loc = nlat // n_space
    if block_rows <= 0 or nl_loc % block_rows:
        raise ValueError(
            f"per-shard latitude {nl_loc} is not a multiple of "
            f"block_rows {block_rows}"
        )
    k = int(steps_per_sweep)
    if k < 1 or int(n_steps) % k:
        raise ValueError("steps_per_sweep must divide n_steps")
    if seasonal and k != 1:
        raise ValueError("seasonal streaming needs steps_per_sweep=1")
    halo = _halo_rows(k)
    if halo > nl_loc:
        raise ValueError(
            f"halo depth {halo} exceeds the shard width {nl_loc}; use "
            "fewer latitude shards or smaller steps_per_sweep"
        )
    rows = nl_loc + 2 * halo
    for arr in (diag, src):
        if t_dim is None and arr is not None:
            t_dim = int(np.shape(arr)[0])
    if t_dim is None:
        raise ValueError(
            "t_dim: pass it explicitly for a family with neither diag "
            "nor src"
        )
    n_steps = int(n_steps)
    dt = float((t_span[1] - t_span[0]) / n_steps)
    n_sweeps = n_steps // k + 1
    if seasonal and dt > period / n_time:
        raise ValueError(
            "seasonal streaming needs dt <= period/n_time "
            f"({period / n_time:.0f} s) -- raise n_steps"
        )
    if block_rows % 8:
        raise ValueError("block_rows must be a positive multiple of 8")
    chunk = int(tend_chunk) if tend_chunk else (t_dim if t_dim <= 2 else 1)
    if not 1 <= chunk <= t_dim:
        raise ValueError(f"tend_chunk={chunk} outside [1, {t_dim}]")
    couple = _couple(couple, t_dim, f32, CPU)

    def rate(arr):
        if arr is None or not np.any(_np64(arr)):
            return None, None
        field = _np64(arr).reshape(t_dim, nz, nlat, nlon)
        return field, _factor_rate_field(field, wet_np)

    diag4, diag_fac = rate(diag)
    src4, src_fac = rate(src)

    sep_rv = recip_area is not None and not stencil
    if sep_rv:
        if recip_dz is None:
            raise ValueError("recip_area requires recip_dz")
        recip_area = _np64(recip_area).astype(np.float32)
        recip_dz = _np64(recip_dz).astype(np.float32)
        if recip_area.shape != (nlat, nlon) or recip_dz.shape != (nz,):
            raise ValueError(
                f"recip_area {recip_area.shape} and recip_dz {recip_dz.shape} "
                f"must be {(nlat, nlon)} and {(nz,)} to factor "
                "coef['recip_vol']"
            )
        rv_chk = wet_np * recip_dz[:, None, None] * recip_area[None]
        if not np.allclose(rv_chk, _np64(coef["recip_vol"]).astype(np.float32),
                           rtol=1e-5, atol=0.0):
            raise ValueError(
                "recip_area/recip_dz do not factor coef['recip_vol']")
    st = None
    if stencil:
        st = _np64(transport_stencil_coef(
            {key: None if arr is None else arr.to(CPU)
             for key, arr in coef.items()}).to(f32))
    upwind3 = coef.get("sel3p_e") is not None
    samples = season_samples(t_span, n_steps, n_time, period)

    def ext(arr, s):
        """(..., nlat, nlon) -> shard s's (..., rows, nlon) slab, zero past
        the physical latitude edges"""
        pad = [(0, 0)] * arr.ndim
        pad[-2] = (halo, halo)
        return np.pad(arr, pad)[..., s * nl_loc:s * nl_loc + rows, :]

    def flat(arr):
        return arr.reshape(arr.shape[:-2] + (rows * nlon,))

    kv4 = kv32.numpy().reshape(kv32.shape[:-1] + (nlat, nlon))
    devs = [row[0] for row in grid_devices(mesh)]
    sweeps = []
    for s, dev in enumerate(devs):
        def put(arr, dev=dev):
            return None if arr is None else torch.tensor(arr, dtype=f32,
                                                         device=dev)

        coef_s = {name: put(ext(_np64(coef[name]), s))
                  for name in ("wet", "recip_vol", *_FACES)
                  if coef.get(name) is not None}
        slab = (coef_s, put(flat(ext(kv4, s))), put(_np64(dz_r)),
                None if diag4 is None else put(flat(ext(diag4, s))),
                None if src4 is None else put(flat(ext(src4, s))), dt, k,
                samples)
        common = dict(couple=couple, upwind3=upwind3, t_dim=t_dim,
                      st=None if st is None else put(ext(st, s)))
        if plain:
            sweeps.append(stream_sweep_plain(*slab, **common))
        else:
            sweeps.append(build_stream_sweep(
                *slab, **common, diag_fac=diag_fac, src_fac=src_fac,
                recip_area=put(ext(recip_area, s)) if sep_rv else None,
                recip_dz=put(recip_dz) if sep_rv else None, device=dev))

    shape = (t_dim, nz, nlat, nlon)

    def year(y):
        if not (isinstance(y, torch.Tensor) and y.is_floating_point()):
            raise ValueError("y must be a floating-point tensor")
        if tuple(y.shape) != shape:
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {shape}")
        slabs, spares, carries = [], [], []
        for (block,), dev in zip(shard_grid(mesh, y), devs):
            slab = torch.zeros((t_dim, nz, rows, nlon), dtype=f32, device=dev)
            slab[:, :, halo:halo + nl_loc].copy_(block)
            slabs.append(slab)
            spares.append(torch.empty_like(slab))
            carries.append(torch.zeros_like(slab))
        for sweep in range(n_sweeps):
            _exchange(slabs, halo, nl_loc)
            _exchange(carries, halo, nl_loc)
            for s in range(n_space):
                slabs[s], spares[s] = sweeps[s](
                    slabs[s], carries[s], spares[s], max(sweep - 1, 0) * k,
                    first=sweep == 0, last=sweep == n_sweeps - 1)
        return gather_grid(mesh, [[slab[:, :, halo:halo + nl_loc]]
                                  for slab in slabs])

    year.halo = halo
    year.seasonal = seasonal
    year.stencil = bool(stencil)
    year.stream_diag = diag4 is not None and diag_fac is None
    year.stream_src = src4 is not None and src_fac is None
    year.n_sweeps = n_sweeps
    year.sweeps = sweeps
    # per sweep, each interior boundary moves `halo` rows of the state and
    # of the carry each way
    year.halo_copies = n_sweeps * 4 * (n_space - 1)
    year.halo_bytes = year.halo_copies * 4 * t_dim * nz * halo * nlon
    return year


def build_sharded_transport3d_year_blocked(
    mesh, coef, kv, dz_r, diag, src, t_span, n_steps, block_steps=2,
    couple=None, tend_chunk=None, plain=False,
):
    """the blocked sharded 3D year: k-step blocks (kernel B7,
    ops/transport3d_block_cuda.py, on a CUDA shard; its plain version on a
    CPU shard) between latitude halo exchanges of 4 k rows.  The shards of
    one card take each block together, in one B7 launch.

    The port of the JAX package's build_sharded_transport3d_year_pallas,
    arguments as its, without `interpret` (the mesh decides where each
    shard runs), with its refusals in its words: latitude ('space') meshes
    only, steady coefficients and kv, nlat splitting over the shards,
    block_steps >= 1, a halo of 4 block_steps rows no deeper than a shard.
    The year decomposes as the single-device years do: a leading CN(dt/2)
    from a zero carry; (n_steps - 1) // k blocks of k steps, then a
    remainder block of the rest, the state and its Kahan carry exchanged
    before each; a final Heun in plain PyTorch, one 2-row exchange per
    stage over the global coefficients' 2-row extension; a trailing
    CN(dt/2).  diag / src: (T, nz, nlat*nlon); fields of the
    a wet + b wet_surf form (what assemble_rate_fields emits) pass as their
    two scalars a tracer.  couple: optional (T, T) surface coupling.
    plain=True runs block3d_steps_plain on every shard, the card's
    included: the reference B7 is held against.

    Returns year(y) for y (T, nz, nlat, nlon) on any device, run in float32;
    the result lies on the mesh's first device.  The year carries halo,
    stream_diag, stream_src (as the JAX year's), n_blocks, halo_copies
    (tensor copies a year), halo_bytes (bytes they move), smem_bytes (the
    largest shared memory a B7 block takes; 0 without a card), launches
    (B7 launches a year; 0 without a card) and blocks (the block functions
    of each shard's device: k steps, then the remainder; None where absent).
    """
    f32 = torch.float32
    n_space = mesh.shape["space"]
    if mesh.shape.get("space_x", 1) != 1:
        raise ValueError(
            "the blocked year shards latitude only; drop the 'space_x' mesh "
            "axis or use build_sharded_transport3d_year"
        )
    wet_np = _np64(coef["wet"])
    nz, nlat, nlon = wet_np.shape
    for name, arr in coef.items():
        if arr is not None and arr.ndim == 4:
            raise ValueError(
                f"seasonal coefficient {name!r}: the blocked year is "
                "steady-only; use build_sharded_transport3d_year"
            )
    kv_np = _np64(kv)
    if kv_np.ndim == 3:
        raise ValueError("seasonal kv: use build_sharded_transport3d_year")
    if nlat % n_space != 0:
        raise ValueError(f"nlat {nlat} does not split over {n_space} shards")
    nl_loc = nlat // n_space
    k = int(block_steps)
    if k < 1:
        raise ValueError("block_steps must be positive")
    halo = 4 * k
    if halo > nl_loc:
        raise ValueError(
            f"halo depth 4*block_steps={halo} exceeds the shard width "
            f"{nl_loc}; the exchange is single-neighbor -- use "
            f"block_steps <= {nl_loc // 4} (or fewer latitude shards)"
        )
    rows_ext = nl_loc + 2 * halo
    diag4 = _np64(diag)
    t_dim = diag4.shape[0]
    diag4 = diag4.reshape(t_dim, nz, nlat, nlon)
    src4 = _np64(src).reshape(t_dim, nz, nlat, nlon)
    dt = float((t_span[1] - t_span[0]) / n_steps)
    m_blocks, r_steps = divmod(int(n_steps) - 1, k)
    has_diag = bool(np.any(diag4))
    has_src = bool(np.any(src4))
    diag_fac = _factor_rate_field(diag4, wet_np) if has_diag else None
    src_fac = _factor_rate_field(src4, wet_np) if has_src else None
    stream_diag = has_diag and diag_fac is None
    stream_src = has_src and src_fac is None
    couple_np = None if couple is None else _np64(couple)
    if couple_np is not None and couple_np.shape != (t_dim, t_dim):
        raise ValueError("couple must be (tracer, tracer)")

    def ext(arr, s):
        """(..., nlat, nlon) -> shard s's (..., rows_ext, nlon) block, zero
        past the physical latitude edges"""
        pad = [(0, 0)] * arr.ndim
        pad[-2] = (halo, halo)
        return np.pad(arr, pad)[..., s * nl_loc:s * nl_loc + rows_ext, :]

    coef_names = [name for name, arr in sorted(coef.items())
                  if arr is not None]
    dl_b, du_b = _cn_bands(kv_np, _np64(dz_r), nz, nlat, nlon)
    devs = [row[0] for row in grid_devices(mesh)]
    on_dev = {}  # each device's shards, in order
    for s, dev in enumerate(devs):
        on_dev.setdefault(dev, []).append(s)
    blk_kw = dict(has_diag=has_diag, has_src=has_src, diag_fac=diag_fac,
                  src_fac=src_fac, couple=couple_np)
    steppers = {}
    for dev in devs:
        if dev in steppers:
            continue
        if plain:
            _chunk(tend_chunk, t_dim)
            steppers[dev] = [None if steps == 0 else block3d_steps_plain(
                coef_names, nz, rows_ext, nlon, t_dim, dt, steps, **blk_kw)
                for steps in ((k if m_blocks else 0), r_steps)]
        else:
            steppers[dev] = [None if steps == 0 else build_block3d_steps(
                coef_names, nz, rows_ext, nlon, t_dim, dt, steps, **blk_kw,
                tend_chunk=tend_chunk, device=dev)
                for steps in ((k if m_blocks else 0), r_steps)]

    rows_i = slice(halo, halo + nl_loc)
    rows_2 = slice(halo - 2, halo + nl_loc + 2)
    half_cn = float(np.float32(0.25 * dt))  # CN(dt/2): half = 0.5 (dt/2)
    dt_f = float(np.float32(dt))

    def put(arr, dev):
        return torch.tensor(np.ascontiguousarray(arr), dtype=f32, device=dev)

    shards = []
    for s, dev in enumerate(devs):
        stack = put(np.stack([ext(_np64(coef[name]), s)
                              for name in coef_names]), dev)
        dlb, dub = put(ext(dl_b, s), dev), put(ext(du_b, s), dev)
        extras = [put(ext(arr, s), dev)
                  for arr, on in ((diag4, stream_diag), (src4, stream_src))
                  if on]
        wet_i = stack[coef_names.index("wet")][:, rows_i]

        def interior(field, fac, on, dev=dev, s=s, wet_i=wet_i):
            if on:
                return put(ext(field, s)[..., rows_i, :], dev)
            return None if fac is None else factored_rates(fac, wet_i)

        shards.append({
            "dev": dev, "stack": stack, "dlb": dlb, "dub": dub,
            # B7's selector bytes, packed once for the year's every block
            "sel": None if plain else pack_selectors(
                stack[coef_names.index("wet")]),
            "extras": extras, "wet_i": wet_i,
            "dlb_i": dlb[:, rows_i], "dub_i": dub[:, rows_i],
            "coef_2": {name: stack[i][:, rows_2]
                       for i, name in enumerate(coef_names)},
            "diag_i": interior(diag4, diag_fac, stream_diag),
            "src_i": interior(src4, src_fac, stream_src),
        })

    def cn_half(sh, y, c):
        """the Kahan-added CN(dt/2) increment of a shard's interior"""
        return _kahan_add(y, c, cn_band_increment(
            y, sh["dlb_i"], sh["dub_i"], sh["diag_i"], half_cn))

    def tend_i(sh, y_ext2, y_i):
        """the final Heun's tendency of a shard's interior from its 2-row
        extended state"""
        out = transport_tend(sh["coef_2"], y_ext2)[:, :, 2:-2, :]
        if sh["src_i"] is not None:
            out = out + sh["src_i"]
        if couple_np is not None:
            out = out.clone()
            out[:, 0] = out[:, 0] + couple_rows(couple_np, y_i[:, 0],
                                                sh["wet_i"])
        return out

    shape = (t_dim, nz, nlat, nlon)

    def year(y):
        if not (isinstance(y, torch.Tensor) and y.is_floating_point()):
            raise ValueError("y must be a floating-point tensor")
        if tuple(y.shape) != shape:
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {shape}")
        slabs, carries = [], []
        for (block,), sh in zip(shard_grid(mesh, y), shards):
            y_i, c_i = cn_half(sh, block.to(sh["dev"], f32),
                               torch.zeros_like(block, dtype=f32,
                                                device=sh["dev"]))
            slab = torch.zeros((t_dim, nz, rows_ext, nlon), dtype=f32,
                               device=sh["dev"])
            carry = torch.zeros_like(slab)
            slab[:, :, rows_i] = y_i
            carry[:, :, rows_i] = c_i
            slabs.append(slab)
            carries.append(carry)
        for ind in [0] * m_blocks + [1] * bool(r_steps):
            _exchange(slabs, halo, nl_loc)
            _exchange(carries, halo, nl_loc)
            # the shards of one device step together (on a card: one launch)
            for dev, members in on_dev.items():
                outs = steppers[dev][ind].many([
                    (slabs[s], carries[s], shards[s]["stack"],
                     shards[s]["dlb"], shards[s]["dub"], *shards[s]["extras"])
                    for s in members], [shards[s]["sel"] for s in members])
                for s, (slab, carry) in zip(members, outs):
                    slabs[s], carries[s] = slab, carry
        # the final Heun, one 2-row exchange per stage, then CN(dt/2)
        _exchange(slabs, halo, nl_loc, 2)
        ys = [slab[:, :, rows_i] for slab in slabs]
        f1 = [tend_i(sh, slab[:, :, rows_2], y_i)
              for sh, slab, y_i in zip(shards, slabs, ys)]
        mids = [torch.zeros_like(slab) for slab in slabs]
        for mid, y_i, f in zip(mids, ys, f1):
            mid[:, :, rows_i] = y_i + dt_f * f
        _exchange(mids, halo, nl_loc, 2)
        out = []
        for sh, mid, y_i, c_s, f in zip(shards, mids, ys, carries, f1):
            f2 = tend_i(sh, mid[:, :, rows_2], mid[:, :, rows_i])
            y_i, c_i = _kahan_add(y_i, c_s[:, :, rows_i],
                                  (0.5 * dt_f) * (f + f2))
            out.append([cn_half(sh, y_i, c_i)[0]])
        return gather_grid(mesh, out)

    blocks = [blk for blks in steppers.values() for blk in blks
              if blk is not None]
    year.halo = halo
    year.stream_diag = stream_diag
    year.stream_src = stream_src
    year.n_blocks = m_blocks + int(bool(r_steps))
    year.blocks = steppers
    year.smem_bytes = max((getattr(blk, "smem_bytes", 0) for blk in blocks),
                          default=0)
    # B7 launches a year: a block's shards of one card take
    # ceil(shards / max_shards) launches (0 where they run the plain version)
    year.launches = sum(
        (m_blocks * bool(blk_k) + bool(blk_r)) * (
            -(-len(on_dev[dev]) // blk.max_shards)
            if getattr(blk, "max_shards", None) else 0)
        for dev in on_dev
        for blk_k, blk_r in [steppers[dev]]
        for blk in [blk_k or blk_r])
    # per block, each interior boundary moves `halo` rows of the state and
    # of the carry each way; the final Heun's two exchanges move 2 rows of
    # the state each way
    per_row = 4 * t_dim * nz * nlon
    year.halo_copies = (year.n_blocks * 4 + 4) * (n_space - 1)
    year.halo_bytes = ((year.n_blocks * 4 * halo + 4 * 2) * (n_space - 1)
                       * per_row)
    return year


def _region_reduction_arrays_3d(region_mask, grid_weight, *, device, dtype):
    """per-(module, region) reduction operators over a 3D grid:
    (region_cnt, mean_w, onehot, fill) with mean_w and onehot
    (region, nz, nlat, nlon) and fill (nz, nlat, nlon)"""
    region_mask = np.asarray(region_mask)
    region_cnt = int(region_mask.max())
    mean_w = region_mean_weights(region_mask, grid_weight).reshape(
        (region_cnt,) + region_mask.shape
    )
    onehot = np.stack(
        [(region_mask == r + 1).astype(np.float64) for r in range(region_cnt)]
    )
    fill = 1.0 - onehot.sum(axis=0)

    def tensor(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return region_cnt, tensor(mean_w), tensor(onehot), tensor(fill)


def _dot_pure_3d(a, b, rc):
    """per-(module, region) weighted dot products over the 3D volume
    weights; rc holds the reduction operators"""
    prod = torch.sum(a * b, dim=1)  # tracer axis
    return torch.einsum("mzab,rzab->mr", prod, rc["mean_w"])


def _broadcast_pure_3d(scalars, rc):
    """(module, region) scalars -> state-shaped per-region field"""
    field = torch.einsum("mr,rzab->mzab", scalars, rc["onehot"])
    return (field + rc["fill"])[:, None, :, :, :]


def circulation_inputs(circ, adv_type="upwind3"):
    """(coef, kv, dz_r) of circulation `circ` in float64 on the CPU: the
    transport coefficients (ops/transport3d.py::build_transport3d), the
    masked vertical-mixing coupling (zero without VDC) and 1 / dz [1/m]"""
    mask = np.asarray(circ["mask"])
    nz, nlat, nlon = mask.shape
    dz = np.asarray(circ["dz"], np.float64)
    cpu64 = {"device": torch.device("cpu"), "dtype": torch.float64}
    coef = build_transport3d(
        mask, dz, circ["TAREA"], uet=circ.get("UET"), vnt=circ.get("VNT"),
        wtt=circ.get("WTT"), hdiff_e=circ.get("HDIFF_E"),
        hdiff_n=circ.get("HDIFF_N"), adv_type=adv_type, **cpu64,
    )
    if circ.get("VDC") is not None:
        kv, dz_r = vmix_vertical_coeff(circ["VDC"], dz, **cpu64)
        kv = mask_vmix_coeff(kv, mask)
    else:
        kv = torch.zeros((nz - 1, nlat * nlon), **cpu64)
        dz_r = torch.as_tensor(1.0 / (1.0e-2 * dz), **cpu64)
    return coef, kv, dz_r


def _wire_3d_solver_interface(kernel, circ, region_mask):
    """the solver-interface wiring the 3D kernels share, on kernel.device
    in kernel.dtype: the wet mask (kernel._wet, and _wet_np on the host),
    the region mask (the circulation's by default), and the per-(module,
    region) volume-weighted dot and region broadcast; returns the volume
    weights (nz, nlat, nlon), zero on land"""
    mask = np.asarray(circ["mask"])
    wet = (mask > 0).astype(np.float64)
    dz = np.asarray(circ["dz"], np.float64)
    if region_mask is None:
        region_mask = mask
    grid_weight = dz[:, None, None] * np.asarray(circ["TAREA"])[None] * wet
    device, dtype = kernel.device, kernel.dtype
    kernel._wet_np = wet
    kernel._wet = torch.as_tensor(wet, dtype=dtype, device=device)
    kernel._region_mask_np = np.asarray(region_mask)
    (kernel.region_cnt, mean_w, onehot, fill) = _region_reduction_arrays_3d(
        region_mask, grid_weight, device=device, dtype=dtype
    )
    kernel._onehot = onehot
    kernel._reduce_consts = {"mean_w": mean_w, "onehot": onehot, "fill": fill}
    kernel._dot = lambda a, b: _dot_pure_3d(a, b, kernel._reduce_consts)
    kernel._region_broadcast = lambda scalars: _broadcast_pure_3d(
        torch.as_tensor(scalars, dtype=dtype, device=device),
        kernel._reduce_consts,
    )
    return grid_weight


def family_year_inputs(circ, module_specs, adv_type="upwind3"):
    """the year's inputs for a family of modules riding circulation `circ`,
    in float64 on the CPU: (coef, kv, dz_r, diag, src, couple) as
    build_transport3d_year takes them, with the (module*tracer) axis flat;
    couple is block-diagonal over modules, or None"""
    mask = np.asarray(circ["mask"])
    nz, nlat, nlon = mask.shape
    dz = np.asarray(circ["dz"], np.float64)
    coef, kv, dz_r = circulation_inputs(circ, adv_type)

    t_dim = len(module_specs[0])
    if any(len(specs) != t_dim for specs in module_specs):
        raise ValueError("all modules must share the tracer count")
    n_flat = len(module_specs) * t_dim
    nh = nlat * nlon
    wet_h = (mask > 0).astype(np.float64).reshape(nz, nh)
    # cross-tracer d_SF_X_d_Y terms couple only tracers of the same
    # module, so the flat (module*tracer) coupling is block-diagonal
    diag = np.zeros((n_flat, nz, nh))
    src = np.zeros((n_flat, nz, nh))
    couple = np.zeros((n_flat, n_flat))
    any_couple = False
    for m_ind, specs in enumerate(module_specs):
        blk = slice(m_ind * t_dim, (m_ind + 1) * t_dim)
        diag[blk], src[blk], couple_m = assemble_rate_fields(
            specs, wet_h, dz[0], SEC_PER_YEAR
        )
        if couple_m is not None:
            couple[blk, blk] = couple_m
            any_couple = True
    return coef, kv, dz_r, diag, src, (couple if any_couple else None)


class ShardedTransport3dKernel(_ShardedKernelInterface):
    """in-core solver kernel: a family of linear 3D IRF-transport tracer
    modules solved for their cyclostationary state, on one device or on a
    latitude (x longitude) sharded mesh.

    On one device (`device=`, or a mesh of one shard) the year is the IMEX
    integration of ops/transport3d_cuda.py: kernel B4 for a float32 state
    on a CUDA device, the plain PyTorch year otherwise (the CPU, or float64
    on either device).  On a mesh of more than one shard (`mesh=`), F and
    the JVPs run the per-step sharded year
    (build_sharded_transport3d_year), as the JAX kernel does
    (sharded_transport3d.py:1350-1378): the JAX package has no Pallas
    kernel on that route, so on the card it is plain PyTorch by design, in
    the state's dtype.  JVPs are exact, since the family is linear: J v =
    year0(v) - v, with year0 a second year of the same kind with the
    sources zeroed.  The solver state stays whole on the mesh's first
    device between years (only the year runs in blocks on the mesh), so
    the reductions -- per-(module, region) volume-weighted means -- and the
    preconditioner are the same on every mesh.  The preconditioner is the
    column-local vertical block of (delta_t M - I): the vertical-mixing
    tridiagonal, the module's local rates and the same-column part of the
    transport stencil (transport_tridiag_bands of the annual-mean
    circulation), assembled in float64 and solved by PCR along depth.

    state layout: (module_batch, t_dim, nz, nlat, nlon) on `device` (the
    mesh's first device).

    circ: the circulation dict (models/irf_offline/synthetic.py::
    gen_circulation's keys: mask, dz, TAREA, UET, VNT, WTT, HDIFF_E,
    HDIFF_N, VDC), steady or seasonal.
    module_specs: per-module lists of per-tracer rate specs with the
    irf_offline keys (source_per_year, sink_rate_per_year,
    surf_restore_pv_cm_s, surf_restore_target, surf_flux_const_cm_s,
    surf_flux_d); all modules must share the tracer count.
    device: one device (or a one-element sequence); mesh: a
    parallel/mesh.py Mesh with a 'space' axis and optionally 'space_x'.
    Pass one of the two.
    """

    def __init__(self, circ, module_specs, n_steps, *, device=None, mesh=None,
                 dtype=torch.float32, region_mask=None, adv_type="upwind3",
                 t_span=(0.0, SEC_PER_YEAR)):
        if (device is None) == (mesh is None):
            raise ValueError("pass one of device= and mesh=")
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise ValueError(
                    f"{len(device)} devices: pass mesh= (parallel/mesh.py::"
                    "make_mesh) to shard the grid over them")
            device = device[0]
        self.mesh = mesh
        n_shards = 1 if mesh is None else (
            mesh.shape["space"] * mesh.shape.get("space_x", 1))
        sharded = n_shards > 1
        self.device = resolve_device(device if mesh is None
                                     else mesh.first_device)
        self.dtype = dtype
        self.n_steps = n_steps
        # a float32 state on one CUDA device runs kernel B4 for F and JVPs
        self.use_kernel = (not sharded and self.device.type == "cuda"
                           and dtype == torch.float32)

        mask = np.asarray(circ["mask"])
        nz, nlat, nlon = mask.shape
        self.grid_shape = (nz, nlat, nlon)
        self.module_batch = len(module_specs)
        self.t_dim = t_dim = len(module_specs[0])
        n_flat = self.module_batch * t_dim
        nh = nlat * nlon
        coef64, kv64, dz_r64, diag, src, couple = family_year_inputs(
            circ, module_specs, adv_type
        )

        # one copy of the coefficients on the device serves both years; the
        # sharded year cuts its own blocks from the float64 ones
        coef = {key: None if arr is None else arr.to(self.device, dtype)
                for key, arr in coef64.items()}
        if sharded:
            coef = coef64
            build = functools.partial(build_sharded_transport3d_year, mesh)
        elif self.use_kernel:
            build = functools.partial(build_transport3d_year,
                                      device=self.device)
        else:
            build = build_transport3d_year_plain
        self._year = build(coef, kv64, dz_r64, diag, src, t_span, n_steps,
                           couple)
        self._year0 = build(coef, kv64, dz_r64, diag, np.zeros_like(src),
                            t_span, n_steps, couple)
        flat_shape = (n_flat, nz, nlat, nlon)
        self._comp_fcn = lambda x: (
            self._year(x.reshape(flat_shape)).reshape(x.shape) - x
        )
        self._jvp = lambda v: (
            self._year0(v.reshape(flat_shape)).reshape(v.shape) - v
        )

        _wire_3d_solver_interface(self, circ, region_mask)

        # column-local preconditioner: the vertical-line block of the
        # (delta_t * M - I) matrix -- vmix tridiagonal + the module's local
        # linear rates + the same-column tridiagonal part of the transport
        # stencil -- assembled in float64 and solved exactly by PCR along
        # depth.  The bands do not depend on the state: built once here.
        delta_t = t_span[1] - t_span[0]
        # a seasonal circulation contributes its annual mean
        kv_np = kv64.numpy()
        if kv_np.ndim == 3:
            kv_np = kv_np.mean(axis=0)
        dz_r_np = dz_r64.numpy()
        up = kv_np * dz_r_np[:-1, None]          # coupling to k+1, (nz-1, nh)
        lo = kv_np * dz_r_np[1:, None]           # coupling to k-1
        pad = np.zeros((1, nh))
        lo_t, diag_t, up_t = (
            b.numpy().reshape(nz, nh)
            for b in transport_tridiag_bands(mean_transport_coef(coef64))
        )
        du_b = delta_t * (np.concatenate([up, pad], axis=0) + up_t)
        dl_b = delta_t * (np.concatenate([pad, lo], axis=0) + lo_t)
        dmain = (
            delta_t
            * (
                -(np.concatenate([up, pad], axis=0)
                  + np.concatenate([pad, lo], axis=0))
                + diag_t
                + diag
            )
            - 1.0
        )                                         # (n_flat, nz, nh)

        def to_cols(arr, lead):
            # (..., nz, nh) -> (..., nlat, nlon, nz) for the PCR solve
            return torch.as_tensor(
                np.moveaxis(arr.reshape(lead + (nz, nlat, nlon)), -3, -1),
                dtype=dtype, device=self.device,
            )

        bands = (to_cols(dl_b, ()),
                 to_cols(dmain, (self.module_batch, t_dim)),
                 to_cols(du_b, ()))
        self._precond_factor = lambda x: bands
        self._precond_apply = _precond_apply

    # -- solver interface ------------------------------------------------------

    def init_iterate(self, fill_value=0.5):
        return (fill_value * self._wet).expand(
            (self.module_batch, self.t_dim) + self.grid_shape
        ).contiguous()

    def jvp(self, x, fcn, v):
        """exact: the family is linear, so J v = year0(v) - v"""
        return self._jvp(v)


def _precond_apply(data, r):
    """solve the column-tridiagonal preconditioner along depth"""
    dl_bands, d_bands, du_bands = data
    r_cols = torch.movedim(r, -3, -1)      # (M, T, nlat, nlon, nz)
    sol = pcr_solve(
        dl_bands.expand(r_cols.shape),
        d_bands.expand(r_cols.shape),
        du_bands.expand(r_cols.shape),
        r_cols,
    )
    return torch.movedim(sol, -1, -3)


def light_lim_3d(dz, nlat, nlon):
    """3D light limitation (nz, nlat, nlon) in numpy float64: 25 m
    e-folding in depth, gaussian in latitude (light_lim_2d's shape on a
    latitude-index coordinate); dz [cm]"""
    dz_m = 1.0e-2 * np.asarray(dz, np.float64)
    depth_mid = np.cumsum(dz_m) - 0.5 * dz_m
    lat_frac = (np.arange(nlat) + 0.5) / nlat
    lat_fac = np.exp(-(((lat_frac - 0.5) / 0.25) ** 2))
    return np.broadcast_to(
        np.exp(-depth_mid / 25.0)[:, None, None] * lat_fac[None, :, None],
        (len(dz_m), nlat, nlon),
    )


class ShardedPhosphorus3dKernel(_ShardedKernelInterface):
    """sharded NONLINEAR solver kernel: the phosphorus cycle (po4, dop,
    pop; py_driver_2d's biogeochemistry) riding the 3D offline
    IRF-transport circulation, on one device or on a latitude (x longitude)
    mesh of torch devices.

    The year is the per-step sharded year (build_sharded_transport3d_year,
    one shard on one device) with the uptake, remineralisation and
    particulate sinking as its column-local local_tend hook; the JVPs are
    exact forward-mode AD through that year (torch.autograd.forward_ad),
    halo exchanges included, plain PyTorch on every device as the JAX
    kernel's jax.jvp is plain XLA.  Sinking crosses only interfaces with
    wet cells on both sides (mass reaching the seafloor stays in the bottom
    wet cell), so the tendency conserves the volume-integrated total P
    exactly.  The preconditioner is the column-local banded
    (tracer-innermost, half-width 3) solve of dt_year * J_col - I --
    vertical mixing (the annual mean of a seasonal circulation), the
    same-column part of the transport stencil, linearised uptake and
    remineralisation, masked sinking -- factored by ops/banded.py (on a
    card the banded_lu kernel, (nlat * nlon, 3 nz, 7) float64), with a
    rank-1 projection that keeps total P on the initial iterate's.  The
    fused GMRES applies `jvp` at every Krylov step (no linearize_target;
    see ShardedPhosphorusKernel).

    circ: the circulation dict (models/irf_offline/synthetic.py::
    gen_circulation's keys); params: the phosphorus parameter dict
    (DEFAULT_PARAMS by default); t_span: the period F integrates over (a
    year by default), in n_steps steps.  device: one device, or mesh: a
    parallel/mesh.py Mesh with a 'space' axis and optionally 'space_x';
    pass one of the two.  state layout: (1, 3, nz, nlat, nlon) on `device`
    (the mesh's first device).
    """

    def __init__(self, circ, params=None, n_steps=365, *, device=None,
                 mesh=None, dtype=torch.float64, region_mask=None,
                 t_span=(0.0, SEC_PER_YEAR)):
        if (device is None) == (mesh is None):
            raise ValueError("pass one of device= and mesh=")
        if mesh is None:
            mesh = make_mesh(1, 1, devices=[device])
        self.mesh = mesh
        self.device = resolve_device(mesh.first_device)
        self.dtype = dtype
        self.n_steps = n_steps
        self.params = p = dict(DEFAULT_PARAMS if params is None else params)
        mask = np.asarray(circ["mask"])
        nz, nlat, nlon = mask.shape
        nh = nlat * nlon
        self.grid_shape = (nz, nlat, nlon)
        self.module_batch, self.t_dim = 1, 3
        wet = (mask > 0).astype(np.float64)
        dz = np.asarray(circ["dz"], np.float64)
        coef, kv, dz_r = circulation_inputs(circ)

        light = light_lim_3d(dz, nlat, nlon) * wet
        # sinking crosses an interface only between two wet cells
        sink_open = wet[:-1] * wet[1:]                   # (nz-1, lat, lon)
        dz_m = 1.0e-2 * dz
        self._depth_mid_m = np.cumsum(dz_m) - 0.5 * dz_m

        def local_tend(_t, y, dl):
            return phosphorus_terms(p, dl["light"], dl["dz_r"], y,
                                    dl["sink_open"])

        zeros3 = np.zeros((3, nz, nh))
        dz_r_np = dz_r.numpy()
        self._year = build_sharded_transport3d_year(
            mesh, coef, kv, dz_r, zeros3, zeros3, t_span, n_steps,
            local_tend=local_tend,
            local_data={"light": light, "sink_open": sink_open,
                        "dz_r": np.broadcast_to(dz_r_np[:, None, None],
                                                mask.shape)},
        )
        flat_shape = (3, nz, nlat, nlon)
        self._comp_fcn = lambda x: (
            self._year(x.reshape(flat_shape)).reshape(x.shape) - x)
        grid_weight = _wire_3d_solver_interface(self, circ, region_mask)

        # the column-local banded block of dt_year * J_col - I, refactored
        # from the iterate once a Newton step
        kv_np = kv.numpy()
        if kv_np.ndim == 3:
            kv_np = kv_np.mean(axis=0)

        def put(arr):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                                   device=self.device)

        pad = np.zeros((1, nh))
        up = put(np.concatenate([kv_np * dz_r_np[:-1, None], pad], 0))
        lo = put(np.concatenate([pad, kv_np * dz_r_np[1:, None]], 0))
        tridiag = tuple(put(b.numpy().reshape(nz, nh))
                        for b in transport_tridiag_bands(
                            mean_transport_coef(coef)))
        light_t = put(light.reshape(nz, nh))
        open_np = sink_open.reshape(nz - 1, nh)
        vel_dz = p["pop_sink_vel"] * dz_r_np[:, None]
        gain = put(vel_dz * np.concatenate([pad, open_np], 0))  # from above
        loss = put(vel_dz * np.concatenate([open_np, pad], 0))
        dt_year = float(t_span[1] - t_span[0])

        def precond_factor(x):
            u1 = phosphorus_uptake_slope(p, light_t, x[0, 0].reshape(nz, nh))
            bands = phosphorus_column_bands(p, up, lo, u1, gain, loss,
                                            transport=tridiag)
            mat = dt_year * bands
            mat[:, :, 3] -= 1.0                      # the -I block
            return banded_lu_factor_blocks(mat)

        w_cons = put(grid_weight)
        s_w = 3.0 * float(grid_weight.sum())

        def precond_apply(lu, r):
            # (1, 3, nz, nlat, nlon) -> per-column tracer-innermost rows
            cols = r[0].reshape(3, nz, nh).permute(2, 1, 0).reshape(nh, 3 * nz)
            sol = banded_lu_solve_blocks(lu, cols)
            sol = sol.reshape(nh, nz, 3).permute(2, 1, 0).reshape(r.shape)
            # rank-1 conservation projection: the same-column part of the
            # transport stencil leaks total-P weight (w^T T = 0 holds for
            # the full stencil only), so enforce w^T z = -w^T r and keep
            # the Newton iterates on the initial total P
            s_z = torch.sum(w_cons * torch.sum(sol[0], dim=0))
            s_r = torch.sum(w_cons * torch.sum(r[0], dim=0))
            return sol + ((-s_r - s_z) / s_w) * self._wet

        self._precond_factor = precond_factor
        self._precond_apply = precond_apply

    # -- solver interface ------------------------------------------------------

    def init_iterate(self):
        """the 2D kernel's depth profiles of po4, dop and pop, wet-masked and
        broadcast over the horizontal"""
        cols = [np.interp(self._depth_mid_m, d, v)
                for d, v in PHOSPHORUS_PROFILES]
        field = np.stack([self._wet_np * c[:, None, None] for c in cols])[None]
        return torch.as_tensor(field, dtype=self.dtype, device=self.device)

    def jvp(self, x, fcn, v):
        """exact forward-mode JVP through the sharded nonlinear 3D year"""
        return phosphorus_jvp(self._comp_fcn, x, v)

    def apply_limiter(self, x, increment):
        """phosphorus tracers are bounded below by zero (the reference's
        lob: 0.0)"""
        return self._apply_limiter_lob0(x, increment)

    def limiter_scalef_jit(self, x, increment):
        return self._limiter_scalef_lob0_jit(x, increment)
