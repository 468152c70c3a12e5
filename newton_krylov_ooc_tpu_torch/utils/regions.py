"""host-side per-region reduction helpers (numpy).

The port's own copy of the parts of newton_krylov_ooc_tpu/utils/regions.py
that the in-core kernels use.  Regions are decoupled sub-domains of the
grid: region_mask holds 1-based region indices (0 = outside the
computational domain).  Solver scalars (norms, limiter factors, convergence
flags) carry a region axis.
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


def region_mean_weights(region_mask, grid_weight):
    """
    dense (region_cnt, ncells) row-stochastic weight matrix computing
    per-region weighted means; one matmul against it gives every region's
    mean at once
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
