"""carry the irf_offline model's data across from numpy.

The JAX package's ops/transport3d.py::build_transport3d returns a dict of
arrays; given as numpy arrays (`{k: None if v is None else np.asarray(v)}`),
coef_from_numpy turns it into the port's dict, so both packages step the
same coefficients value for value.  The in-core state layout, (module,
tracer, nz, nlat, nlon), is the same in both packages: an in-core npz
checkpoint of the JAX package resumes in the port as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.transport3d import UPWIND3_SELECTOR_KEYS

_REQUIRED = ("wet", "recip_vol")
_FACES = ("t_e", "t_n", "t_t", "cond_e", "cond_n")


def coef_from_numpy(coef, *, device, dtype):
    """the port's transport coefficient dict from a JAX build_transport3d
    dict (numpy arrays or None); keys and shapes carry over unchanged"""
    allowed = set(_REQUIRED) | set(_FACES) | set(UPWIND3_SELECTOR_KEYS)
    unknown = set(coef) - allowed
    missing = set(_REQUIRED) - set(coef)
    if unknown or missing:
        raise ValueError(
            f"transport coefficients: unknown keys {sorted(unknown)}, "
            f"missing {sorted(missing)}"
        )
    return {
        key: None if arr is None else torch.tensor(
            np.asarray(arr), dtype=dtype, device=device
        )
        for key, arr in coef.items()
    }
