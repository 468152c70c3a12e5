"""SpatialAxis: 1D stretched-grid axis (edges, midpoints, thicknesses).

Capability parity with nk_ooc/spatial_axis.py (axis construction from edges /
defn dicts, polynomial stretching, layer integrals, conservative remap of
piecewise-linear interpolants, netCDF round-trip), numpy only.  The port's
own copy of newton_krylov_ooc_tpu/core/spatial_axis.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.ncio import NCFile


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

        self.dump_names = {
            "bounds": f"{axisname}_bounds",
            "edges": f"{axisname}_edges",
            "delta": f"{axisname}_delta",
        }

    def __len__(self):
        return len(self.mid)

    # -- netCDF round-trip -------------------------------------------------

    def dump(self, fname, caller):
        """write axis information to a netCDF file"""
        with NCFile(fname, mode="w") as fptr:
            name = f"{type(self).__module__}.{type(self).__name__}.dump"
            fptr.stamp_history(name, caller)
            if self.defn_dict_values is not None:
                fptr.setncattr("defn_dict_values", self.defn_dict_values)
            fptr.create_dimensions_verify(self.dump_dimensions())
            fptr.create_vars(self.dump_vars_metadata())
            self.dump_write(fptr)

    def dump_dimensions(self):
        return {
            self.axisname: len(self),
            "nbnds": 2,
            self.dump_names["edges"]: len(self) + 1,
        }

    def dump_vars_metadata(self):
        res = {
            self.axisname: {
                "dimensions": (self.axisname,),
                "attrs": {
                    "long_name": f"{self.axisname} layer midpoints",
                    "units": self.units,
                    "bounds": self.dump_names["bounds"],
                },
            },
            self.dump_names["bounds"]: {
                "dimensions": (self.axisname, "nbnds"),
                "attrs": {"long_name": f"{self.axisname} layer bounds"},
            },
            self.dump_names["edges"]: {
                "dimensions": (self.dump_names["edges"],),
                "attrs": {
                    "long_name": f"{self.axisname} layer edges",
                    "units": self.units,
                },
            },
            self.dump_names["delta"]: {
                "dimensions": (self.axisname,),
                "attrs": {
                    "long_name": f"{self.axisname} layer thickness",
                    "units": self.units,
                },
            },
        }
        return res

    def dump_vals_dict(self):
        return {
            self.axisname: self.mid,
            self.dump_names["bounds"]: np.stack((self.edges[:-1], self.edges[1:]), axis=1),
            self.dump_names["edges"]: self.edges,
            self.dump_names["delta"]: self.delta,
        }

    def dump_write(self, fptr):
        for name, vals in self.dump_vals_dict().items():
            fptr.var(name)[:] = vals
        fptr.sync()

    # -- numerics ------------------------------------------------------------

    def int_vals_mid(self, vals, axis):
        """thickness-weighted layer integral of midpoint values along an axis"""
        vals = np.asarray(vals)
        if vals.shape[axis] != len(self):
            raise ValueError(f"length mismatch, {vals.shape[axis]} != {len(self)}")
        ndim = vals.ndim
        pos = axis if axis >= 0 else ndim + axis
        if pos < ndim - 3:
            raise ValueError(f"axis={axis}")
        shape = [1] * ndim
        shape[pos] = len(self)
        return (self.delta.reshape(shape) * vals).sum(axis=pos)

    def remap_linear_interpolant(self, xvals, yvals):
        """
        Conservatively remap the piecewise-linear interpolant through
        (xvals, yvals) onto this axis: per-layer averages of the (endpoint-
        clamped) interpolant.  Vectorized: integrate trapezoid segments over the
        union of layer edges and interior breakpoints, then bin by layer.
        """
        xvals = np.asarray(xvals, dtype=np.float64)
        yvals = np.asarray(yvals, dtype=np.float64)

        interior = xvals[(xvals > self.edges[0]) & (xvals < self.edges[-1])]
        breaks = np.union1d(self.edges, interior)
        ybreaks = np.interp(breaks, xvals, yvals)

        seg_int = 0.5 * (ybreaks[:-1] + ybreaks[1:]) * np.diff(breaks)
        seg_mid = 0.5 * (breaks[:-1] + breaks[1:])
        layer_of_seg = np.searchsorted(self.edges, seg_mid) - 1

        layer_int = np.bincount(layer_of_seg, weights=seg_int, minlength=len(self))
        return layer_int * self.delta_r


def spatial_axis_from_file(fname, axisname, edges_varname=None):
    """SpatialAxis from edge values stored in a netCDF file"""
    if edges_varname is None:
        edges_varname = f"{axisname}_edges"
    with NCFile(fname) as fptr:
        var = fptr.var(edges_varname)
        edges = var[:]
        units = var.attrs.get("units")
        defn_dict_values = fptr.attrs.get("defn_dict_values")
    return SpatialAxis(axisname, edges, units, defn_dict_values)


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
    thickness (same stretching family as the reference,
    nk_ooc/spatial_axis.py:253-290)
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
