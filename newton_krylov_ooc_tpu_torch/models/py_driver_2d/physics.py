"""py_driver_2d physics as plain PyTorch functions on tensors.

Port of newton_krylov_ooc_tpu/models/py_driver_2d/physics.py: 2D
(depth x ypos) tracer transport with streamfunction-derived non-divergent
advection, Peclet-limited horizontal diffusion, and seasonal boundary-layer
vertical mixing.  Setup-time fields are built in numpy exactly as the JAX
package builds them, then carried onto an explicit device and dtype.  The
tendencies take (..., nz, ny) fields: the leading tracer axis is a written-out
batch, where the JAX package vmaps a single-tracer function.  The mixing
coefficient takes a time of shape () or (B,) (the Radau year's three
collocation stages in one call) and returns (..., nz-1, ny).

The analytic Jacobians come dense (transport_jac) and in row-band storage:
z-major cells with bandwidth ny (transport_bands) or ypos-major cells with
bandwidth nz (transport_bands_ymajor), the narrower of which the banded
Radau year takes.  bldepth_np and vert_mixing_coeff_np are the numpy
twins the history files are written from.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core.spatial_axis import SpatialAxis
from ...ops.banded import dense_to_bands

SEC_PER_YEAR = 365.0 * 86400.0


class Grid2D(NamedTuple):
    """static grid + velocity-field tensors (one device, one dtype)"""

    depth_mid: torch.Tensor       # (nz,)
    depth_edges: torch.Tensor     # (nz+1,)
    dz_r: torch.Tensor            # (nz,)
    dz_mid: torch.Tensor          # (nz-1,)
    dz_mid_r: torch.Tensor        # (nz-1,)
    ypos_mid: torch.Tensor        # (ny,)
    dy_r: torch.Tensor            # (ny,)
    vvel: torch.Tensor            # (nz, ny+1) velocity in ypos direction
    wvel: torch.Tensor            # (nz+1, ny) velocity in depth direction
    stream: torch.Tensor          # (nz+1, ny+1)
    horiz_mix_coeff: torch.Tensor  # (nz, ny-1), divided by delta_mid


def gen_vel_field(depth, ypos, max_abs_vvel):
    """streamfunction and non-divergent velocity field (numpy, setup-time)"""
    depth_norm = (depth.edges - depth.edges.min()) / (
        depth.edges.max() - depth.edges.min()
    )
    stretch = 2.0
    depth_norm = stretch * depth_norm / (1 + (stretch - 1) * depth_norm)
    depth_fcn = (27.0 / 4.0) * depth_norm * (1.0 - depth_norm) ** 2

    ypos_norm = (ypos.edges - ypos.edges.min()) / (
        ypos.edges.max() - ypos.edges.min()
    )
    ypos_fcn = 4.0 * ypos_norm * (1.0 - ypos_norm)

    stream = np.outer(depth_fcn, ypos_fcn)

    # normalize so max |vvel| equals max_abs_vvel (zero disables advection)
    vvel = (stream[1:, :] - stream[:-1, :]) * depth.delta_r[:, np.newaxis]
    if np.abs(vvel).max() > 0.0:
        stream = stream * max_abs_vvel / np.abs(vvel).max()

    vvel = (stream[1:, :] - stream[:-1, :]) * depth.delta_r[:, np.newaxis]
    wvel = (stream[:, 1:] - stream[:, :-1]) * ypos.delta_r
    return stream, vvel, wvel


def comp_horiz_mix_coeff(depth, ypos, vvel, horiz_mix_coeff):
    """horizontal mixing coefficient / delta_mid with grid-Peclet <= 2 (numpy)"""
    if horiz_mix_coeff > 0.0:
        res = np.full((len(depth), len(ypos) - 1), horiz_mix_coeff)
        peclet_p5 = (
            (0.5 / horiz_mix_coeff) * ypos.delta_mid[:] * np.abs(vvel[:, 1:-1])
        )
        res *= np.where(peclet_p5 > 1.0, peclet_p5, 1.0)
        res *= ypos.delta_mid_r
    else:
        # enforce grid Peclet = 2 (zero where vvel is zero)
        res = 0.5 * np.abs(vvel[:, 1:-1])
    return res


def make_grid(depth, ypos, modelinfo, *, device, dtype):
    """build the static Grid2D from SpatialAxis objects + modelinfo"""
    max_abs_vvel = float(modelinfo["max_abs_vvel"])
    horiz_mix = float(modelinfo["horiz_mix_coeff"])
    stream, vvel, wvel = gen_vel_field(depth, ypos, max_abs_vvel)
    hmc = comp_horiz_mix_coeff(depth, ypos, vvel, horiz_mix)

    def put(arr):
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)

    return Grid2D(
        depth_mid=put(depth.mid),
        depth_edges=put(depth.edges),
        dz_r=put(depth.delta_r),
        dz_mid=put(depth.delta_mid),
        dz_mid_r=put(depth.delta_mid_r),
        ypos_mid=put(ypos.mid),
        dy_r=put(ypos.delta_r),
        vvel=put(vvel),
        wvel=put(wvel),
        stream=put(stream),
        horiz_mix_coeff=put(hmc),
    )


def explicit_dt_bound(grid: Grid2D):
    """largest stable step for the EXPLICIT (Heun) lateral half of the IMEX
    split: min over faces of dy^2/(2K) (diffusion) and dy/|v| (advection).
    The implicit Crank-Nicolson vertical half is unconditionally stable, so
    this is the scheme's only step restriction."""
    dy = float(1.0 / grid.dy_r.max().item())  # smallest cell width
    # horiz_mix_coeff is stored as K / dy_mid at interior faces, so the
    # worst diffusive eigenvalue is ~4 * hmc / dy and dt <= dy / (2 * hmc)
    hmc = grid.horiz_mix_coeff.detach().cpu().to(torch.float64).numpy()
    bounds = [np.inf]
    if hmc.size and hmc.max() > 0.0:
        bounds.append(float(dy / (2.0 * hmc.max())))
    vmax = float(grid.vvel.abs().max().item())
    if vmax > 0:
        bounds.append(dy / vmax)
    return min(bounds)


# -- vertical mixing --------------------------------------------------------------

BLD_MIN = 35.0
_BLD_YPOS = np.array([0.4e6, 0.8e6, 1.0e6, 1.2e6, 1.4e6, 1.5e6])
_BLD_MAX = np.array([3000.0, 800.0, 415.0, 325.0, 280.0, BLD_MIN])
_BLD_TFRAC = SEC_PER_YEAR * np.array([0.25, 0.35, 0.65, 0.75])
_BLD_FRAC = np.array([0.0, 1.0, 1.0, 0.0])

VERT_MIX_LOG_SHALLOW = float(np.log(1.0e1))
VERT_MIX_LOG_DEEP = float(np.log(5.0e-4))


def interp(x, xp, fp):
    """piecewise-linear interpolation of the static table (xp, fp) at x,
    extrapolating flat beyond both ends (the jnp.interp/np.interp contract).

    x: tensor or python float; xp increasing.  Written as a sum of clamped
    ramps, so it needs no search or gather.
    """
    xp = [float(v) for v in xp]
    fp = [float(v) for v in fp]
    val = fp[0]
    for k in range(len(xp) - 1):
        ramp = torch.clamp((x - xp[k]) / (xp[k + 1] - xp[k]), 0.0, 1.0)
        val = val + (fp[k + 1] - fp[k]) * ramp
    return val


def bldepth(grid: Grid2D, time):
    """boundary-layer depth per ypos column (..., ny) at time () or (B,)"""
    return _bldepth(grid.ypos_mid, time)


def _bldepth(ypos_mid, time):
    time = torch.as_tensor(time, dtype=ypos_mid.dtype, device=ypos_mid.device)
    bld_max = interp(ypos_mid, _BLD_YPOS, _BLD_MAX)
    frac = interp(time, _BLD_TFRAC, _BLD_FRAC)
    return BLD_MIN + (bld_max - BLD_MIN) * frac[..., None]


def _clamped_ramp_layer_mean(edges, x0, x1, y0, y1):
    """
    per-layer average over [edges[k], edges[k+1]] of the clamped linear ramp
    f(x) = y0 for x<=x0, linear to y1 at x1, y1 beyond -- the closed form of a
    conservative remap of the 2-point piecewise-linear interpolant
    """
    slope = (y1 - y0) / (x1 - x0)

    def antider(x):
        # integral of (clip(x, x0, x1) - x0): quadratic ramp then linear tail
        c = torch.minimum(torch.maximum(x, x0), x1) - x0
        return 0.5 * c * c + (x1 - x0) * torch.clamp(x - x1, min=0.0)

    num = y0 * (edges[1:] - edges[:-1]) + slope * (
        antider(edges[1:]) - antider(edges[:-1])
    )
    return num / (edges[1:] - edges[:-1])


def vert_mixing_coeff(grid: Grid2D, time):
    """
    vertical mixing coefficient at interior depth edges / delta_mid, per ypos
    column -> (nz-1, ny); conservative log-space remap of the boundary-layer
    ramp, Peclet-limited against wvel
    """
    return vert_mixing_coeff_arrays(
        grid.depth_mid, grid.dz_mid, grid.dz_mid_r, grid.ypos_mid, grid.wvel,
        time,
    )


def vert_mixing_coeff_arrays(depth_mid, dz_mid, dz_mid_r, ypos_mid, wvel, time):
    """vert_mixing_coeff from explicit tensors (column-local)

    time: python float, or a tensor of shape () or (B,), of the grid's dtype
    """
    bld = _bldepth(ypos_mid, time)  # (..., ny)
    # remap onto layers of the "depth_edges axis" whose edges are depth.mid,
    # vectorized over ypos columns
    log_coeff = _clamped_ramp_layer_mean(
        depth_mid[:, None],
        bld[..., None, :] - 20.0,
        bld[..., None, :] + 20.0,
        VERT_MIX_LOG_SHALLOW,
        VERT_MIX_LOG_DEEP,
    )
    coeff = torch.exp(log_coeff)  # (nz-1, ny)

    peclet_p5 = 0.5 * dz_mid[:, None] * wvel[1:-1, :].abs() / coeff
    coeff = coeff * torch.where(peclet_p5 > 1.0, peclet_p5, 1.0)
    return coeff * dz_mid_r[:, None]


# -- process tendencies ((..., nz, ny) fields, batched over leading axes) ---------


def _pad_last(x):
    """zero column on both sides of the last axis"""
    zero = x.new_zeros(x.shape[:-1] + (1,))
    return torch.cat([zero, x, zero], dim=-1)


def _pad_depth(x):
    """zero row on both sides of the depth (second-to-last) axis"""
    zero = x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))
    return torch.cat([zero, x, zero], dim=-2)


def advection_tend(grid: Grid2D, v):
    """centered-flux advection tendency"""
    wy = _pad_last(0.5 * (v[..., :, 1:] + v[..., :, :-1]) * grid.vvel[:, 1:-1])
    res = grid.dy_r * (wy[..., :, :-1] - wy[..., :, 1:])

    wz = _pad_depth(0.5 * (v[..., 1:, :] + v[..., :-1, :]) * grid.wvel[1:-1, :])
    return res + grid.dz_r[:, None] * (wz[..., 1:, :] - wz[..., :-1, :])


def horiz_mix_tend(grid: Grid2D, v):
    """horizontal diffusion tendency (zero-flux lateral boundaries)"""
    flux = _pad_last(grid.horiz_mix_coeff * (v[..., :, 1:] - v[..., :, :-1]))
    return grid.dy_r * (flux[..., :, 1:] - flux[..., :, :-1])


def vert_mix_tend(grid: Grid2D, kv, v):
    """vertical diffusion tendency given kv = vert_mixing_coeff(grid, t)"""
    flux = _pad_depth(kv * (v[..., 1:, :] - v[..., :-1, :]))
    return grid.dz_r[:, None] * (flux[..., 1:, :] - flux[..., :-1, :])


def transport_tend(grid: Grid2D, kv, v):
    """sum of all process tendencies for the tracer fields v"""
    return (
        advection_tend(grid, v) + horiz_mix_tend(grid, v)
        + vert_mix_tend(grid, kv, v)
    )


# -- analytic Jacobian assembly ---------------------------------------------------


def lateral_jac_np(grid: Grid2D):
    """time-invariant (ncell, ncell) Jacobian of advection + horizontal mixing,
    assembled in float64 numpy from the same centered-flux stencils as the
    tendencies"""
    nz = grid.depth_mid.shape[0]
    ny = grid.ypos_mid.shape[0]
    n = nz * ny

    def host(t):
        return t.detach().cpu().to(torch.float64).numpy()

    vvel, wvel = host(grid.vvel), host(grid.wvel)
    hmc, dz_r, dy_r = host(grid.horiz_mix_coeff), host(grid.dz_r), host(grid.dy_r)

    jac = np.zeros((n, n))
    cell = np.arange(n).reshape(nz, ny)

    def add(rows, cols, vals):
        np.add.at(jac, (rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1))

    # advection, south faces (flux wy[z, y], present for y >= 1)
    vals = 0.5 * vvel[:, 1:-1] * dy_r[1:]
    add(cell[:, 1:], cell[:, 1:], vals)
    add(cell[:, 1:], cell[:, :-1], vals)
    # advection, north faces (flux wy[z, y+1], present for y <= ny-2)
    vals = -0.5 * vvel[:, 1:-1] * dy_r[:-1]
    add(cell[:, :-1], cell[:, 1:], vals)
    add(cell[:, :-1], cell[:, :-1], vals)
    # advection, deep faces (flux wz[z+1, y], present for z <= nz-2)
    vals = 0.5 * wvel[1:-1, :] * dz_r[:-1, None]
    add(cell[:-1, :], cell[1:, :], vals)
    add(cell[:-1, :], cell[:-1, :], vals)
    # advection, shallow faces (flux wz[z, y], present for z >= 1)
    vals = -0.5 * wvel[1:-1, :] * dz_r[1:, None]
    add(cell[1:, :], cell[1:, :], vals)
    add(cell[1:, :], cell[:-1, :], vals)

    # horizontal mixing: res[z, y] = dy_r[y] * (hflux[z, y+1] - hflux[z, y])
    vals = hmc * dy_r[:-1]  # north-face contribution, rows y <= ny-2
    add(cell[:, :-1], cell[:, 1:], vals)
    add(cell[:, :-1], cell[:, :-1], -vals)
    vals = hmc * dy_r[1:]  # south-face contribution, rows y >= 1
    add(cell[:, 1:], cell[:, :-1], vals)
    add(cell[:, 1:], cell[:, 1:], -vals)
    return jac


def lateral_jac_const(grid: Grid2D):
    """lateral_jac_np on the grid's device and dtype"""
    return torch.as_tensor(lateral_jac_np(grid), dtype=grid.depth_mid.dtype,
                           device=grid.depth_mid.device)


def _vert_jac_indices(nz, ny, device):
    """stencil index tensors on `device` for the vertical-mixing Jacobian
    scatter: rows and columns of d tend[z]/d v[z+1] = dz_r[z] kv[z]
    (z < nz-1) and of d tend[z]/d v[z-1] = dz_r[z] kv[z-1] (z > 0), with
    the kv index of each; built on the device, so a CUDA graph captures
    them"""
    cell = torch.arange(nz * ny, device=device).reshape(nz, ny)
    kv_idx = torch.arange((nz - 1) * ny, device=device).reshape(nz - 1, ny)
    rows_up = cell[:-1, :].reshape(-1)
    cols_up = cell[1:, :].reshape(-1)
    k_up = kv_idx.reshape(-1)
    rows_lo = cell[1:, :].reshape(-1)
    cols_lo = cell[:-1, :].reshape(-1)
    k_lo = kv_idx.reshape(-1)
    return rows_up, cols_up, k_up, rows_lo, cols_lo, k_lo


def vertical_jac(grid: Grid2D, kv):
    """(ncell, ncell) Jacobian of the vertical-mixing tendency for given kv

    Each stencil entry is written once (the diagonal's two terms summed
    first, as the JAX package adds them), by indexed assignment with no
    accumulation, so a CUDA graph captures it.
    """
    nz = grid.depth_mid.shape[0]
    ny = grid.ypos_mid.shape[0]
    n = nz * ny
    device = kv.device
    rows_up, cols_up, k_up, rows_lo, cols_lo, k_lo = _vert_jac_indices(
        nz, ny, device)
    kvf = kv.reshape(-1)
    dz_r_cell = grid.dz_r[:, None].expand(nz, ny).reshape(-1)
    up_vals = dz_r_cell[rows_up] * kvf[k_up]
    lo_vals = dz_r_cell[rows_lo] * kvf[k_lo]

    jac = torch.zeros((n, n), dtype=kv.dtype, device=device)
    jac[rows_up, cols_up] = up_vals
    jac[rows_lo, cols_lo] = lo_vals
    diag = torch.zeros(n, dtype=kv.dtype, device=device)
    diag[rows_up] = diag[rows_up] - up_vals
    diag[rows_lo] = diag[rows_lo] - lo_vals
    jac.diagonal().copy_(diag)
    return jac


def transport_jac(grid: Grid2D, time, lateral=None):
    """(ncell, ncell) Jacobian of the full single-tracer transport tendency;
    lateral: lateral_jac_const(grid), passed in where the caller keeps it"""
    if lateral is None:
        lateral = lateral_jac_const(grid)
    return lateral + vertical_jac(grid, vert_mixing_coeff(grid, time))


def _on_grid(grid, arr):
    return torch.as_tensor(arr, dtype=grid.depth_mid.dtype,
                           device=grid.depth_mid.device)


def lateral_bands_const(grid: Grid2D):
    """row-band storage (ncell, 2*ny+1) of the lateral Jacobian (bw = ny),
    z-major cells, on the grid's device and dtype"""
    ny = grid.ypos_mid.shape[0]
    return _on_grid(grid, dense_to_bands(lateral_jac_np(grid), ny))


def transport_bands(grid: Grid2D, time, lateral=None):
    """row-band (ncell, 2*ny+1) Jacobian of the full transport tendency

    stencil offsets: +-1 (ypos neighbors, lateral), +-ny (depth neighbors,
    vertical mixing), 0 (diagonal).  lateral: lateral_bands_const(grid),
    passed in where the caller keeps it.
    """
    ny = grid.ypos_mid.shape[0]
    bands = (lateral_bands_const(grid) if lateral is None else lateral).clone()
    kv = vert_mixing_coeff(grid, time)  # (nz-1, ny)
    up = (grid.dz_r[:-1, None] * kv).reshape(-1)  # rows z = 0..nz-2
    lo = (grid.dz_r[1:, None] * kv).reshape(-1)   # rows z = 1..nz-1
    bands[:-ny, 2 * ny] += up
    bands[ny:, 0] += lo
    bands[:-ny, ny] += -up
    bands[ny:, ny] += -lo
    return bands


def ymajor_perm(nz, ny):
    """y-major cell index (y*nz + z) -> z-major cell index (z*ny + y)"""
    return (np.arange(ny)[:, None] + np.arange(nz)[None, :] * ny).reshape(-1)


def lateral_bands_const_ymajor(grid: Grid2D):
    """row-band storage (ncell, 2*nz+1) of the lateral Jacobian in
    ypos-major cell order (cell = y*nz + z): lateral neighbors sit at
    offsets +-nz, so the bandwidth is nz instead of ny"""
    nz = grid.depth_mid.shape[0]
    ny = grid.ypos_mid.shape[0]
    perm = ymajor_perm(nz, ny)
    jac = lateral_jac_np(grid)[np.ix_(perm, perm)]
    return _on_grid(grid, dense_to_bands(jac, nz))


def transport_bands_ymajor(grid: Grid2D, time, lateral=None):
    """row-band (ncell, 2*nz+1) transport Jacobian, ypos-major cell order

    stencil offsets: +-1 (depth neighbors, vertical mixing), +-nz (ypos
    neighbors, lateral), 0 (diagonal).  The narrower of the two layouts:
    use when nz < ny (bandwidth min(nz, ny)).  lateral:
    lateral_bands_const_ymajor(grid), passed in where the caller keeps it.
    """
    nz = grid.depth_mid.shape[0]
    ny = grid.ypos_mid.shape[0]
    bands = (lateral_bands_const_ymajor(grid) if lateral is None
             else lateral).clone()
    kv = vert_mixing_coeff(grid, time)  # (nz-1, ny)
    # row (y, z): up couples to z+1 (offset +1), lo to z-1 (offset -1)
    up = (kv * grid.dz_r[:-1, None]).T.reshape(-1)  # (ny*(nz-1),) y-major
    lo = (kv * grid.dz_r[1:, None]).T.reshape(-1)
    rows_up = (torch.arange(ny, device=bands.device)[:, None] * nz
               + torch.arange(nz - 1, device=bands.device)[None, :]).reshape(-1)
    rows_lo = rows_up + 1
    bands[rows_up, nz + 1] += up
    bands[rows_lo, nz - 1] += lo
    bands[rows_up, nz] += -up
    bands[rows_lo, nz] += -lo
    return bands


def block_diag_tracers(blocks):
    """dense block-diagonal assembly of per-tracer (n, n) Jacobians"""
    n = blocks[0].shape[0]
    jac = blocks[0].new_zeros((len(blocks) * n, len(blocks) * n))
    for ind, blk in enumerate(blocks):
        jac[ind * n:(ind + 1) * n, ind * n:(ind + 1) * n] = blk
    return jac


# -- numpy twins for history/stats fields (exact host arithmetic) -----------------


def bldepth_np(ypos, time):
    bld_max = np.interp(ypos.mid, _BLD_YPOS, _BLD_MAX)
    frac = np.interp(time, _BLD_TFRAC, _BLD_FRAC)
    return BLD_MIN + (bld_max - BLD_MIN) * frac


def vert_mixing_coeff_np(depth, ypos, wvel, time):
    """numpy twin of vert_mixing_coeff (per-column conservative remap)"""
    bld = bldepth_np(ypos, time)
    edges_axis = SpatialAxis("depth_edges", depth.mid)
    res = np.empty((len(depth) - 1, len(ypos)))
    cache = {}
    for j, bld_j in enumerate(bld):
        if bld_j not in cache:
            cache[bld_j] = edges_axis.remap_linear_interpolant(
                np.array([bld_j - 20.0, bld_j + 20.0]),
                np.array([VERT_MIX_LOG_SHALLOW, VERT_MIX_LOG_DEEP]),
            )
        res[:, j] = cache[bld_j]
    res = np.exp(res)
    peclet_p5 = 0.5 * depth.delta_mid[:, None] * np.abs(wvel[1:-1, :]) / res
    res *= np.where(peclet_p5 > 1.0, peclet_p5, 1.0)
    return res * depth.delta_mid_r[:, None]
