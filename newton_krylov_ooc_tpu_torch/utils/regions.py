"""host-side per-region reduction kernels (vectorized numpy).

Regions are decoupled sub-domains of the grid: region_mask holds 1-based region
indices (0 = outside the computational domain).  Solver scalars (norms, limiter
factors, convergence flags) carry a region axis; these kernels compute them.

Capability parity: nk_ooc/utils.py:544-600.  The port's own copy of
newton_krylov_ooc_tpu/utils/regions.py.
"""

from __future__ import annotations

import numpy as np


def min_by_region(region_cnt, region_mask, vals, out=None):
    """per-region minimum of vals (inf where a region is empty)"""
    if out is None:
        out = np.empty(region_cnt)
    elif out.shape != (region_cnt,):
        raise ValueError(f"unexpected out.shape={out.shape}")
    mask_flat = np.asarray(region_mask).reshape(-1)
    vals_flat = np.asarray(vals).reshape(-1)
    for region_ind in range(region_cnt):
        sel = mask_flat == region_ind + 1
        out[region_ind] = vals_flat[sel].min() if sel.any() else np.inf
    return out


def comp_scalef_lob(region_cnt, region_mask, base, increment, lob, out=None):
    """
    largest 0<=scalef<=1 per region such that base + scalef * increment >= lob
    """
    if out is None:
        out = np.empty(region_cnt)
    elif out.shape != (region_cnt,):
        raise ValueError(f"unexpected out.shape={out.shape}")
    if lob is None or (base + increment >= lob).all():
        out[:] = 1.0
        return out
    if (base < lob).any():
        raise ValueError("base < lob")
    scalef_all = np.ones(np.shape(base))
    violation = base + increment < lob
    np.divide(lob - base, increment, out=scalef_all, where=violation)
    return min_by_region(region_cnt, region_mask, scalef_all, out)


def comp_scalef_upb(region_cnt, region_mask, base, increment, upb, out=None):
    """
    largest 0<=scalef<=1 per region such that base + scalef * increment <= upb
    """
    if out is None:
        out = np.empty(region_cnt)
    elif out.shape != (region_cnt,):
        raise ValueError(f"unexpected out.shape={out.shape}")
    if upb is None or (base + increment <= upb).all():
        out[:] = 1.0
        return out
    if (base > upb).any():
        raise ValueError("base > upb")
    scalef_all = np.ones(np.shape(base))
    violation = base + increment > upb
    np.divide(upb - base, increment, out=scalef_all, where=violation)
    return min_by_region(region_cnt, region_mask, scalef_all, out)


def region_mean_weights(region_mask, grid_weight):
    """
    dense (region_cnt, ncells) row-stochastic weight matrix computing per-region
    weighted means; the device path contracts with it in a single matmul
    rather than scipy CSR (reference: nk_ooc/model_config.py:283-315)
    """
    mask_flat = np.asarray(region_mask).reshape(-1)
    weight_flat = np.asarray(grid_weight, dtype=np.float64).reshape(-1)
    region_cnt = int(mask_flat.max()) if mask_flat.size else 0
    mat = np.zeros((region_cnt, mask_flat.size))
    for region_ind in range(region_cnt):
        sel = mask_flat == region_ind + 1
        wsum = weight_flat[sel].sum()
        if wsum > 0.0:
            mat[region_ind, sel] = weight_flat[sel] / wsum
    return mat


def broadcast_region_vals(region_mask, vals, fill_value=1.0):
    """
    scatter per-region scalars onto the grid: result[cell] = vals[region-1] inside
    regions, fill_value outside (reference: tracer_module_state_base.py:502-515)
    """
    region_mask = np.asarray(region_mask)
    res = np.full(region_mask.shape, float(fill_value))
    for region_ind, val in enumerate(np.asarray(vals)):
        res = np.where(region_mask == region_ind + 1, val, res)
    return res
