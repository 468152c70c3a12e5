"""SpatialAxis: 1D stretched-grid axis (edges, midpoints, thicknesses).

The port's own copy of what the in-core models use of
newton_krylov_ooc_tpu/core/spatial_axis.py (numpy only): axis construction
from edges or a defn dict, with the quintic stretching.  The layer
integrals, the conservative remap and the netCDF round trip
(`SpatialAxis.dump`, `spatial_axis_from_file`) come with the file-backed
slice, which needs them and the netCDF layer.
"""

from __future__ import annotations

import numpy as np


class SpatialAxis:
    """1D spatial axis defined by its layer edges"""

    def __init__(self, axisname, edges, units=None, defn_dict_values=None):
        self.axisname = axisname
        self.edges = np.asarray(edges, dtype=np.float64)
        self.units = "m" if units is None else units
        self.defn_dict_values = defn_dict_values

        self.mid = 0.5 * (self.edges[:-1] + self.edges[1:])
        self.delta = np.diff(self.edges)
        self.delta_r = 1.0 / self.delta
        self.delta_mid = np.diff(self.mid)
        self.delta_mid_r = 1.0 / self.delta_mid

    def __len__(self):
        return len(self.mid)


def spatial_axis_from_defn_dict(defn_dict):
    """SpatialAxis from a defn dict (see spatial_axis_defn_dict)"""
    for key in ["axisname", "nlevs", "edge_start", "edge_end"]:
        if defn_dict[key]["value"] is None:
            raise ValueError(f"required value for key {key} not set")
    if (defn_dict["delta_ratio_max"]["value"] is None) == (
        defn_dict["delta_start"]["value"] is None
    ):
        raise ValueError(
            "exactly one of delta_ratio_max and delta_start must have a value"
        )

    axisname = defn_dict["axisname"]["value"]
    edges = _edges_from_defn_dict(defn_dict)
    units = defn_dict["units"]["value"]
    defn_dict_values = "\n".join(
        f"{key}={item['value']}" for key, item in defn_dict.items()
    )
    return SpatialAxis(axisname, edges, units, defn_dict_values)


def _edges_from_defn_dict(defn_dict):
    """
    edge values from a defn dict, using a zero-mean quintic stretching function
    so that adding multiples of it to the layer thicknesses preserves the mean
    thickness
    """
    nlevs = defn_dict["nlevs"]["value"]
    edge_start = defn_dict["edge_start"]["value"]
    edge_end = defn_dict["edge_end"]["value"]

    coord = np.linspace(-1.0, 1.0, nlevs)
    # quintic with f(+-1)=+-1, f'(+-1)=f''(+-1)=0, zero mean
    stretch_fcn = 0.125 * coord * (15 + coord * coord * (3 * coord * coord - 10))

    delta_avg = (edge_end - edge_start) / nlevs

    if defn_dict["delta_ratio_max"]["value"] is not None:
        delta_ratio_max = defn_dict["delta_ratio_max"]["value"]
        if delta_ratio_max <= 0.0:
            raise ValueError("delta_ratio_max must be > 0.0 to ensure delta > 0.0")
        stretch_factor = delta_avg * (delta_ratio_max - 1) / (delta_ratio_max + 1)
    else:
        delta_start = defn_dict["delta_start"]["value"]
        if delta_start <= 0.0:
            raise ValueError("delta_start must be > 0.0")
        stretch_factor = delta_avg - delta_start

    delta = delta_avg + stretch_factor * stretch_fcn

    edges = np.empty(1 + nlevs)
    edges[0] = edge_start
    edges[1:] = edge_start + delta.cumsum()
    return edges


def spatial_axis_defn_dict(axisname="depth", trap_unknown=True, **kwargs):
    """
    defn dict template for axis construction; entries carry type/help metadata
    usable for argparse argument generation
    """
    defn_dict = {
        "axisname": {"type": str, "help": "axis name", "value": axisname},
        "units": {"type": str, "help": "axis units", "value": None},
        "nlevs": {"type": int, "help": "number of layers", "value": None},
        "edge_start": {"type": float, "help": "start of edges", "value": None},
        "edge_end": {"type": float, "help": "end of edges", "value": None},
        "delta_ratio_max": {
            "type": float,
            "help": "maximum ratio of layer thicknesses",
            "value": None,
        },
        "delta_start": {"type": float, "help": "first layer thickness", "value": None},
    }

    if axisname.lower() == "depth":
        defn_dict["units"]["value"] = "m"
        defn_dict["nlevs"]["value"] = 30
        defn_dict["edge_start"]["value"] = 0.0
        defn_dict["edge_end"]["value"] = 900.0
        defn_dict["delta_ratio_max"]["value"] = 5.0

    for key, value in kwargs.items():
        if key in defn_dict:
            defn_dict[key]["value"] = value
        elif trap_unknown:
            raise ValueError(f"unknown key {key}")

    return defn_dict
