"""host-side per-region reduction helpers (numpy).

The port's own copy of the parts of newton_krylov_ooc_tpu/utils/regions.py
that the in-core kernels use.  Regions are decoupled sub-domains of the
grid: region_mask holds 1-based region indices (0 = outside the
computational domain).  Solver scalars (norms, convergence flags) carry a
region axis.
"""

from __future__ import annotations

import numpy as np


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
