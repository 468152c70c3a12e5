"""test_problem column physics as plain PyTorch functions.

Port of newton_krylov_ooc_tpu/models/test_problem/physics.py.  The test_problem
model is a 1D depth column: time-varying boundary-layer vertical mixing plus
per-module sources and sinks.  The in-core column kernels (incore.py) use
the grid, the mixing coefficient, the iage piston velocity and the dye pulse;
the file-backed solver's Radau year integrates the tendencies built by
make_*_tend, and its history and preconditioner fields use the numpy (_np)
variants.

The tendencies broadcast over a leading batch axis: tend(time, vals) takes
time of shape () and vals of shape (n,), or time of shape (B,) and vals of
shape (B, n) (ops/radau.py evaluates the three collocation stages in one
call).  They hold no host reads or data-dependent branches, so
forward-mode AD differentiates them and a CUDA graph captures them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..py_driver_2d.physics import interp
from . import constants


class ColumnGrid(NamedTuple):
    """static depth-axis tensors the tendencies use"""

    mid: torch.Tensor          # (nlev,)
    edges_int: torch.Tensor    # (nlev-1,) interior edges
    delta_r: torch.Tensor      # (nlev,)
    delta_mid_r: torch.Tensor  # (nlev-1,)


def column_grid(depth, *, device, dtype=torch.float64):
    """the static grid tensors of a SpatialAxis"""
    def tensor(arr):
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)

    return ColumnGrid(
        mid=tensor(depth.mid),
        edges_int=tensor(depth.edges[1:-1]),
        delta_r=tensor(depth.delta_r),
        delta_mid_r=tensor(depth.delta_mid_r),
    )


def bldepth(time):
    """time-varying boundary layer depth, 50..150 m, annual cycle"""
    frac = 0.5 + 0.5 * torch.cos(
        (2 * math.pi) * (constants.year_per_sec * time - 0.25)
    )
    return 50.0 + 100.0 * frac


def mixing_coeff(grid: ColumnGrid, time):
    """vertical mixing coefficient at interior edges divided by the
    distance between layer midpoints (m/s): the log10 profile ramps from 1
    to 1e-5 m^2/s across bldepth +/- 20 m"""
    bld = bldepth(time)
    frac = torch.clamp((grid.edges_int - (bld - 20.0)) / 40.0, 0.0, 1.0)
    # the JAX ramp 0.0 * (1 - frac) + (-5.0) * frac, whose first term is +0
    res_log10 = (-5.0) * frac
    return 10.0 ** res_log10 * grid.delta_mid_r


def bldepth_np(time):
    """numpy variant (exact host arithmetic for history/stats fields)"""
    frac = 0.5 + 0.5 * np.cos((2 * np.pi) * (constants.year_per_sec * time - 0.25))
    return 50.0 + 100.0 * frac


def mixing_coeff_np(depth, time):
    """numpy variant of mixing_coeff over a SpatialAxis (host path)"""
    bld = bldepth_np(time)
    res_log10 = np.interp(
        depth.edges[1:-1], [bld - 20.0, bld + 20.0], [0.0, -5.0]
    )
    return 10.0 ** res_log10 * depth.delta_mid_r


def po4_uptake_np(depth, po4):
    """numpy variant of po4_uptake (host path)"""
    llim = np.exp((-1.0 / 25.0) * depth.mid)
    return constants.day_per_sec * llim * po4 / (po4 + PO4_HALFSAT)


def po4_s_restore_tau_r_np(depth, po4, uptake, restoring_opt):
    """numpy variant of po4_s_restore_tau_r (host path)"""
    if restoring_opt == 0:
        res = np.zeros_like(po4)
        res[0] = constants.day_per_sec
        return res
    po4_delta = np.maximum(1.0e-3 * np.abs(po4), 1.0e-8)
    return (po4_uptake_np(depth, po4 + po4_delta) - uptake) / po4_delta


def _kvals(grid: ColumnGrid, time):
    """mixing_coeff at each time of a batch: (..., nlev-1) for time (...)"""
    return mixing_coeff(grid, torch.as_tensor(time)[..., None])


def mix_tend(grid: ColumnGrid, kvals, tracer, surf_flux=0.0):
    """flux-form tendency of vertical mixing with a surface-flux BC

    kvals: (..., nlev-1) mixing coefficient / delta_mid at interior edges
    tracer: (..., nlev); surf_flux: downward surface flux (positive into
    the column), a number or a tensor of tracer's leading shape
    """
    interior = kvals * (tracer[..., 1:] - tracer[..., :-1])
    if isinstance(surf_flux, torch.Tensor):
        surf_flux = surf_flux[..., None]
    edge = torch.zeros_like(interior[..., :1])
    flux = torch.cat([edge - surf_flux, interior, edge], dim=-1)
    return (flux[..., 1:] - flux[..., :-1]) * grid.delta_r


# -- iage ----------------------------------------------------------------------

IAGE_PIST_VEL = 24.0 * constants.day_per_sec * 10.0  # piston velocity, m/s


def make_iage_tend(grid: ColumnGrid):
    """iage: +1 yr/yr aging source, surface restoring via piston velocity"""

    def tend(time, vals_flat):
        surf_flux = -IAGE_PIST_VEL * vals_flat[..., 0]
        kvals = _kvals(grid, time)
        return mix_tend(grid, kvals, vals_flat, surf_flux) + constants.year_per_sec

    return tend


# -- dye_decay --------------------------------------------------------------

_DYE_FLUX_TIMES = constants.sec_per_year * np.array([0.1, 0.2, 0.6, 0.7])
_DYE_FLUX_VALS = constants.year_per_sec * np.array([0.0, 2.0, 2.0, 0.0])


def dye_decay_surf_flux(time):
    """pulse surface flux (integral over the year = 1 mol/m^2)"""
    return interp(time, _DYE_FLUX_TIMES, _DYE_FLUX_VALS)


def make_dye_decay_tend(grid: ColumnGrid, decay_rate_per_year):
    """dye_decay_{suff}: pulsed surface input, first-order decay

    decay_rate_per_year: a number, or a tensor (a module family shares one
    integrator and sets its rate in place)
    """

    def tend(time, vals_flat):
        surf_flux = dye_decay_surf_flux(torch.as_tensor(time))
        kvals = _kvals(grid, time)
        decay = decay_rate_per_year * constants.year_per_sec
        return mix_tend(grid, kvals, vals_flat, surf_flux) - decay * vals_flat

    return tend


# -- phosphorus ----------------------------------------------------------------

PO4_HALFSAT = 0.5
SIGMA_DOP = 0.67
REMIN_RATE = 0.01 * constants.day_per_sec  # dop and pop remin, 1%/day
SINK_VEL = constants.day_per_sec  # pop sinking, 1 m/day


def light_lim(grid: ColumnGrid):
    """light limitation with 25 m e-folding decay"""
    return torch.exp((-1.0 / 25.0) * grid.mid)


def po4_uptake(grid: ColumnGrid, po4):
    """Michaelis-Menten uptake with light limitation, max rate 1/day"""
    po4_lim = po4 / (po4 + PO4_HALFSAT)
    return constants.day_per_sec * light_lim(grid) * po4_lim


def po4_s_restore_tau_r(grid: ColumnGrid, po4, uptake, restoring_opt):
    """inverse restoring timescale for the shadow po4 tracer"""
    if restoring_opt == 0:
        surface = torch.arange(po4.shape[-1], device=po4.device) == 0
        return torch.where(surface, constants.day_per_sec, torch.zeros_like(po4))
    # finite-difference d(po4_uptake)/d(po4)
    po4_delta = torch.clamp(1.0e-3 * torch.abs(po4), min=1.0e-8)
    return (po4_uptake(grid, po4 + po4_delta) - uptake) / po4_delta


def sinking_tend(grid: ColumnGrid, tracer):
    """flux-form sinking at 1 m/day, zero flux at surface and bottom"""
    interior = -SINK_VEL * tracer[..., :-1]
    edge = torch.zeros_like(interior[..., :1])
    flux = torch.cat([edge, interior, edge], dim=-1)
    return grid.delta_r * (flux[..., 1:] - flux[..., :-1])


def make_phosphorus_tend(grid: ColumnGrid, restoring_opt):
    """
    phosphorus cycling: po4/dop/pop plus shadow counterparts; uptake computed
    from real po4 drives both triplets; shadow po4 restores toward real po4
    with compensation from dop_s/pop_s so total shadow P is conserved

    Both triplets and all six mixing terms are computed as one batch; each
    element takes the JAX tendency's operations in its order.
    """
    nlev = grid.mid.shape[0]
    # shadow restoring and its compensation: +1, -0.67, -0.33 of rest_term
    rest_coeff = torch.tensor([1.0, -0.67, -0.33], dtype=grid.mid.dtype,
                              device=grid.mid.device)[:, None]

    def tend(time, vals_flat):
        lead = vals_flat.shape[:-1]
        vals = vals_flat.reshape(lead + (2, 3, nlev))  # (real, shadow) triplets
        kvals = _kvals(grid, time)[..., None, None, :]
        po4 = vals[..., 0, 0, :]
        uptake = po4_uptake(grid, po4)[..., None, :]

        remin = REMIN_RATE * vals
        mix = mix_tend(grid, kvals, vals)
        d_po4 = -uptake + remin[..., 1, :] + remin[..., 2, :] + mix[..., 0, :]
        d_dop = SIGMA_DOP * uptake - remin[..., 1, :] + mix[..., 1, :]
        d_pop = (
            (1.0 - SIGMA_DOP) * uptake
            - remin[..., 2, :]
            + mix[..., 2, :]
            + sinking_tend(grid, vals[..., 2, :])
        )
        out = torch.stack([d_po4, d_dop, d_pop], dim=-2)  # (..., 2, 3, nlev)

        tau_r = po4_s_restore_tau_r(grid, po4, uptake[..., 0, :], restoring_opt)
        rest_term = tau_r * (po4 - vals[..., 1, 0, :])
        out = torch.stack([out[..., 0, :, :],
                           out[..., 1, :, :] + rest_coeff * rest_term[..., None, :]],
                          dim=-3)
        return out.reshape(lead + (6 * nlev,))

    return tend
