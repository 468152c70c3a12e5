"""test_problem column physics as plain PyTorch functions.

Port of the parts of newton_krylov_ooc_tpu/models/test_problem/physics.py
that the in-core column kernels (incore.py) use: the depth column's static
arrays, the seasonal boundary-layer mixing coefficient, the iage piston
velocity and the dye_decay pulse.  The Radau-path tendencies and the
phosphorus column are not ported; they serve the file-backed solver.
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
    res_log10 = 0.0 * (1.0 - frac) + (-5.0) * frac
    return 10.0 ** res_log10 * grid.delta_mid_r


IAGE_PIST_VEL = 24.0 * constants.day_per_sec * 10.0  # piston velocity, m/s

_DYE_FLUX_TIMES = constants.sec_per_year * np.array([0.1, 0.2, 0.6, 0.7])
_DYE_FLUX_VALS = constants.year_per_sec * np.array([0.0, 2.0, 2.0, 0.0])


def dye_decay_surf_flux(time):
    """pulse surface flux (integral over the year = 1 mol/m^2)"""
    return interp(time, _DYE_FLUX_TIMES, _DYE_FLUX_VALS)
