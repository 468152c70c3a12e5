"""carry the py_driver_2d grid and states across from numpy.

The grid holds the model's parameters -- velocities, diffusivities and
metric terms -- so feeding both packages the same fields makes their
results comparable value for value.  The JAX package's Grid2D crosses as
`{k: np.asarray(v) for k, v in grid._asdict().items()}`; a state crosses as
one numpy array (e.g. the `x` of a JAX in-core checkpoint).  The phosphorus
kernel's `params` dict and light limitation cross the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .phosphorus import DEFAULT_PARAMS
from .physics import Grid2D


def grid_from_numpy(fields, *, device, dtype) -> Grid2D:
    """Grid2D from a {field name: numpy array} dict holding every field"""
    missing = set(Grid2D._fields) - set(fields)
    extra = set(fields) - set(Grid2D._fields)
    if missing or extra:
        raise ValueError(
            f"grid fields differ from Grid2D: missing {sorted(missing)}, "
            f"unexpected {sorted(extra)}"
        )
    return Grid2D(
        **{
            name: torch.tensor(np.asarray(fields[name]), dtype=dtype,
                               device=device)
            for name in Grid2D._fields
        }
    )


def state_from_numpy(x, *, device, dtype):
    """state tensor (e.g. (2, nz, ny) for iage) from a numpy array"""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(params):
    """phosphorus parameter dict of python floats from the JAX kernel's
    `params` (numbers or 0-d arrays), holding exactly DEFAULT_PARAMS' keys"""
    if set(params) != set(DEFAULT_PARAMS):
        raise ValueError(
            f"phosphorus params {sorted(params)} differ from "
            f"{sorted(DEFAULT_PARAMS)}"
        )
    return {key: float(np.asarray(val)) for key, val in params.items()}


def light_lim_from_numpy(light_lim, *, nz, ny, device, dtype):
    """(nz, ny) light-limitation tensor from the JAX package's
    light_lim_2d(depth, ypos) array (or its flattened copy)"""
    return torch.tensor(np.asarray(light_lim), dtype=dtype,
                        device=device).reshape(nz, ny)
