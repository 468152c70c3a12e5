"""py_driver_2d phosphorus (po4, dop, pop) as plain PyTorch functions on
tensors.

Port of newton_krylov_ooc_tpu/models/py_driver_2d/phosphorus.py:28-162: the
parameters, the 2D light limitation, the tendency (`build_tend` there) and
its analytic Jacobian (`build_jac` there).  The state is a (3, nz, ny)
tensor of po4, dop and pop.  Michaelis-Menten uptake of po4 under light
limitation feeds dop and pop; both remineralise back to po4; pop sinks
with a zero-flux bottom.  Every term moves phosphorus between tracers or
cells, so the grid-weighted total over the three tracers is conserved.

`explicit_tend` is the IMEX year's explicit half (the JAX in-core kernel's
tendency, models/py_driver_2d/incore.py:349-374): lateral transport plus
the local terms, with vertical mixing left to the Crank-Nicolson half.

Not ported yet (ROADMAP A3.3): the file-backed `phosphorus` tracer module,
`band_info`, `build_jac_bands` and the eigen-regularised out-of-core
preconditioner.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.helpers import eval_expr
from . import physics

DEFAULT_PARAMS = {
    "po4_halfsat": 0.5,
    "max_uptake_rate": 1.0 / (3.0 * 86400.0),
    "sigma": 0.67,
    "dop_remin_rate": 1.0 / (0.5 * 365.0 * 86400.0),
    "pop_remin_rate": 1.0 / (0.5 * 365.0 * 86400.0),
    "pop_sink_vel": 2.0 / 86400.0,
}


def gen_params(modelinfo):
    """tracer-module parameters, with modelinfo overrides"""
    logger = logging.getLogger(__name__)
    params = dict(DEFAULT_PARAMS)
    for key in params:
        if key in modelinfo:
            value = eval_expr(modelinfo[key])
            logger.info("using %s=%s (%e) from modelinfo", key, modelinfo[key], value)
            params[key] = value
    return params


def light_lim_2d(depth, ypos, *, device, dtype):
    """2D light limitation (nz, ny): 25 m e-folding in depth, gaussian in
    ypos; built in numpy as the JAX package builds it"""
    field = np.outer(
        np.exp((-1.0 / 25.0) * depth.mid),
        np.exp(-1.0 * ((ypos.mid - 2.5e6) / 1.5e6) ** 2),
    )
    return torch.as_tensor(field, dtype=dtype, device=device)


def _add_local(grid, params, light_lim, y, d):
    """d (3, nz, ny) plus uptake, remineralisation and sinking at y"""
    p = params
    po4, dop, pop = y[0], y[1], y[2]
    uptake = p["max_uptake_rate"] * light_lim * po4 / (po4 + p["po4_halfsat"])
    dop_remin = p["dop_remin_rate"] * dop
    pop_remin = p["pop_remin_rate"] * pop
    d_po4 = d[0] - uptake + dop_remin + pop_remin
    d_dop = d[1] + p["sigma"] * uptake - dop_remin
    d_pop = d[2] + (1.0 - p["sigma"]) * uptake - pop_remin

    # particulate sinking: the flux leaving row k enters row k+1; nothing
    # leaves through the bottom (zero-flux, mass retained)
    sink = F.pad(p["pop_sink_vel"] * pop[:-1, :], (0, 0, 1, 1))
    d_pop = d_pop + grid.dz_r[:, None] * (sink[:-1, :] - sink[1:, :])
    return torch.stack([d_po4, d_dop, d_pop])


def explicit_tend(grid, params, light_lim, y):
    """the IMEX year's explicit tendency of y (3, nz, ny): advection,
    lateral mixing and the local terms"""
    d = physics.advection_tend(grid, y) + physics.horiz_mix_tend(grid, y)
    return _add_local(grid, params, light_lim, y, d)


def phosphorus_tend(grid, params, light_lim, time, y):
    """full tendency of y (3, nz, ny) at `time`: transport, vertical mixing
    included, and the local terms"""
    kv = physics.vert_mixing_coeff(grid, time)
    return _add_local(grid, params, light_lim, y,
                      physics.transport_tend(grid, kv, y))


def phosphorus_jac(grid, params, light_lim, time, po4):
    """dense (3 ncell, 3 ncell) Jacobian of phosphorus_tend at `time`; it
    depends on the state only through po4 (nz, ny)"""
    p = params
    nz, ny = grid.depth_mid.shape[0], grid.ypos_mid.shape[0]
    n = nz * ny
    jt = physics.transport_jac(grid, time)
    po4 = po4.reshape(-1)
    light = light_lim.reshape(-1)
    uptake_jac = (
        p["max_uptake_rate"] * light * p["po4_halfsat"]
        / (po4 + p["po4_halfsat"]) ** 2
    )
    cell = torch.arange(n, device=jt.device)
    dz_r_flat = grid.dz_r[:, None].expand(nz, ny).reshape(-1)

    def add(mat, rows, cols, vals):
        vals = torch.as_tensor(vals, dtype=mat.dtype, device=mat.device)
        mat.index_put_((rows, cols), vals.expand(rows.shape), accumulate=True)

    # sinking, within the pop block: gain from the layer above, loss to the
    # layer below (the bottom layer keeps its mass)
    upper, lower = cell[:-ny], cell[ny:]
    j_pop = jt.clone()
    add(j_pop, lower, upper, p["pop_sink_vel"] * dz_r_flat[lower])
    add(j_pop, upper, upper, -p["pop_sink_vel"] * dz_r_flat[upper])

    full = physics.block_diag_tracers([jt, jt, j_pop])
    # biogeochemical couplings
    add(full, cell, cell, -uptake_jac)
    add(full, n + cell, cell, p["sigma"] * uptake_jac)
    add(full, 2 * n + cell, cell, (1.0 - p["sigma"]) * uptake_jac)
    add(full, cell, n + cell, p["dop_remin_rate"])
    add(full, n + cell, n + cell, -p["dop_remin_rate"])
    add(full, cell, 2 * n + cell, p["pop_remin_rate"])
    add(full, 2 * n + cell, 2 * n + cell, -p["pop_remin_rate"])
    return full
