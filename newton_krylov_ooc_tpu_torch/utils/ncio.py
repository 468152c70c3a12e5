"""netCDF3 (classic / 64-bit-offset) IO layer.

The reference framework (klindsay28/Newton-Krylov_OOC) stores every vector of its
out-of-core solver in NETCDF3_64BIT_OFFSET files written through the netCDF4-python
library (e.g. nk_ooc/model_state_base.py:93-111).  This framework keeps netCDF only
at the checkpoint/IO edges -- hot data lives in tensors on the device -- so a
thin, dependency-free writer/reader over ``scipy.io.netcdf_file`` is all that is
needed.  The wrapper presents a small netCDF4-like facade (dimensions, variables,
attributes, history provenance) so higher layers read naturally.

File format: version=2 (64-bit offset), matching the reference's on-disk format.

The port's own copy of newton_krylov_ooc_tpu/utils/ncio.py: the port and the
JAX package read and write the same files.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
from scipy.io import netcdf_file

# default fill values per netCDF3 datatype shortname (mirrors the netCDF C library
# defaults used by the reference via netCDF4.default_fillvals)
DEFAULT_FILLVALS = {
    "f8": 9.969209968386869e36,
    "f4": 9.969209968386869e36,
    "i4": -2147483647,
    "i2": -32767,
    "i1": -127,
    "S1": "\x00",
}

_DTYPE_TO_SNAME = {
    np.dtype("float64"): "f8",
    np.dtype("float32"): "f4",
    np.dtype("int32"): "i4",
    np.dtype("int16"): "i2",
    np.dtype("int8"): "i1",
}

_SNAME_TO_DTYPE = {v: k for k, v in _DTYPE_TO_SNAME.items()}


def datatype_sname(dtype) -> str:
    """shortname ('f8', 'i4', ...) for a numpy dtype, usable in DEFAULT_FILLVALS"""
    dtype = np.dtype(dtype)
    # strip byte order
    dtype = dtype.newbyteorder("=")
    if dtype not in _DTYPE_TO_SNAME:
        raise ValueError(f"unsupported datatype {dtype}")
    return _DTYPE_TO_SNAME[dtype]


def _decode(val):
    """decode bytes attributes to str (scipy returns attributes as bytes)"""
    if isinstance(val, bytes):
        return val.decode("utf-8")
    return val


class NCVariable:
    """facade over a scipy netcdf variable"""

    def __init__(self, name, var):
        self.name = name
        self._var = var

    @property
    def dimensions(self):
        return tuple(self._var.dimensions)

    @property
    def shape(self):
        return self._var.shape

    @property
    def datatype(self):
        return self._var.data.dtype.newbyteorder("=")

    @property
    def attrs(self):
        return {
            key: _decode(val)
            for key, val in self._var._attributes.items()  # noqa: SLF001
            if key != "data"
        }

    def getncattr(self, name):
        return _decode(self._var._attributes[name])  # noqa: SLF001

    def setncattr(self, name, value):
        self._var._attributes[name] = value  # noqa: SLF001

    def setncatts(self, attrs):
        for key, val in attrs.items():
            if val is not None:
                self.setncattr(key, val)

    def __getattr__(self, name):
        try:
            return _decode(self._var._attributes[name])  # noqa: SLF001
        except KeyError as exc:
            raise AttributeError(name) from exc

    @property
    def _is_record(self):
        shape = self._var._shape  # noqa: SLF001
        return bool(shape) and not shape[0]

    def __getitem__(self, key):
        vals = np.asarray(self._var.data[key])
        # scipy stores data big-endian; return native order (torch rejects '>f8')
        if vals.dtype.byteorder == ">":
            vals = vals.astype(vals.dtype.newbyteorder("="))
        return vals

    def __setitem__(self, key, vals):
        # record-variable growth is handled here (scipy's own __setitem__
        # mishandles assignments into empty/short record arrays)
        var = self._var
        if self._is_record:
            vals_arr = np.asarray(vals)
            first = key[0] if isinstance(key, tuple) else key
            data = var.data
            cur = 0 if data is None else data.shape[0]
            tail = tuple(var._shape[1:])  # noqa: SLF001
            if isinstance(first, (int, np.integer)):
                need = int(first) + 1
            elif isinstance(first, slice):
                start = first.start or 0
                if first.stop is not None:
                    need = max(cur, first.stop)
                elif vals_arr.ndim == len(var.dimensions):
                    need = max(cur, start + vals_arr.shape[0])
                else:
                    need = cur
            else:
                need = cur
            if need > cur:
                dtype = (
                    data.dtype if data is not None
                    else vals_arr.dtype.newbyteorder(">")
                )
                grown = np.zeros((need,) + tail, dtype)
                if cur:
                    grown[:cur] = data
                var.__dict__["data"] = grown
        var.data[key] = vals

    def __len__(self):
        return self._var.shape[0]


class NCFile:
    """
    facade over scipy.io.netcdf_file with the subset of the netCDF4 API used by
    this framework: dimension/variable creation with verification, attribute
    handling, history provenance, context-manager access
    """

    def __init__(self, fname, mode="r"):
        self.fname = fname
        self.mode = mode
        # mmap=False so data remains valid after close and files can be rewritten
        self._fptr = netcdf_file(fname, mode=mode, version=2, mmap=False)

    # -- dimensions ------------------------------------------------------

    @property
    def dimensions(self):
        return dict(self._fptr.dimensions)

    def dim_len(self, dimname):
        """current length of a dimension (record dim returns current record count)"""
        dimlen = self._fptr.dimensions[dimname]
        if dimlen is None or dimlen == 0:
            # record dimension: report the widest record variable (the facade
            # grows record arrays directly, bypassing scipy's _recs counter)
            n_recs = int(self._fptr._recs)  # noqa: SLF001
            for var in self._fptr.variables.values():
                shape = var._shape  # noqa: SLF001
                if shape and not shape[0] and var.data is not None:
                    n_recs = max(n_recs, var.data.shape[0])
            return n_recs
        return dimlen

    def create_dimension(self, dimname, dimlen):
        """create dimension; None or 0 creates the record (unlimited) dimension"""
        self._fptr.createDimension(dimname, dimlen)

    def create_dimensions_verify(self, dimensions):
        """
        create dimensions from a {name: len} dict; re-creating an existing
        dimension is allowed only if the length matches
        (capability parity: nk_ooc/utils.py:367-382)
        """
        if not isinstance(dimensions, dict):
            raise TypeError(f"dimensions must be a dict, not {type(dimensions)}")
        # netCDF3 requires the record (unlimited) dimension to be defined first
        ordered = sorted(dimensions.items(), key=lambda kv: kv[1] is not None)
        for dimname, dimlen in ordered:
            if dimname in self._fptr.dimensions:
                if self._fptr.dimensions[dimname] != dimlen:
                    raise RuntimeError(
                        f"dimension {dimname} exists with len "
                        f"{self._fptr.dimensions[dimname]} != {dimlen}"
                    )
            else:
                self._fptr.createDimension(dimname, dimlen)

    # -- variables -------------------------------------------------------

    @property
    def variables(self):
        return {name: NCVariable(name, var) for name, var in self._fptr.variables.items()}

    def has_var(self, varname):
        return varname in self._fptr.variables

    def var(self, varname):
        return NCVariable(varname, self._fptr.variables[varname])

    def create_variable(self, varname, datatype, dimensions, attrs=None):
        """create a variable with attributes; returns an NCVariable facade"""
        if isinstance(datatype, str):
            dtype = _SNAME_TO_DTYPE[datatype]
        else:
            dtype = np.dtype(datatype).newbyteorder("=")
        if isinstance(dimensions, str):
            dimensions = (dimensions,)
        var = self._fptr.createVariable(varname, dtype, tuple(dimensions))
        if var.data is None:
            # record variable, never written: scipy leaves data as None, which
            # breaks its own flush path -- seed an empty 0-record array.
            # NOTE: must bypass scipy's attribute magic (netcdf_variable
            # __setattr__ records every assignment as a netCDF attribute!)
            # scipy stores variable data big-endian and writes raw bytes
            var.__dict__["data"] = np.empty((0,) + tuple(
                self._fptr.dimensions[dim] for dim in var.dimensions[1:]
            ), dtype=dtype.newbyteorder(">"))
        elif var.data.size and not var.isrec:
            # zero-fill fixed-shape vars so files are deterministic
            var.data[...] = np.zeros((), dtype=dtype)
        ncvar = NCVariable(varname, var)
        if attrs:
            ncvar.setncatts(attrs)
        return ncvar

    def create_vars(self, vars_metadata):
        """
        create variables from {varname: {datatype, dimensions, attrs}} metadata
        (capability parity: nk_ooc/utils.py:394-414)
        """
        for varname, metadata in vars_metadata.items():
            datatype = metadata.get("datatype", "f8")
            attrs = dict(metadata.get("attrs", {}))
            attrs.pop("_FillValue", None)
            self.create_variable(varname, datatype, metadata["dimensions"], attrs)

    # -- global attributes -----------------------------------------------

    @property
    def attrs(self):
        return {
            key: _decode(val)
            for key, val in self._fptr._attributes.items()  # noqa: SLF001
        }

    def getncattr(self, name):
        return _decode(self._fptr._attributes[name])  # noqa: SLF001

    def setncattr(self, name, value):
        setattr(self._fptr, name, value)

    @property
    def history(self):
        return _decode(getattr(self._fptr, "history", None))

    @history.setter
    def history(self, msg):
        self._fptr.history = msg

    def stamp_history(self, name, caller=None):
        """set a datestamped provenance history attribute (reference behavior:
        nk_ooc/model_state_base.py:99-107)"""
        datestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        msg = f"{datestamp}: created by {name}"
        if caller is not None:
            msg = f"{msg} called from {caller}"
        self._fptr.history = msg

    def prepend_history(self, msg):
        old = self.history
        self._fptr.history = msg if old is None else "\n".join([msg, old])

    # -- lifecycle ---------------------------------------------------------

    def _pad_record_vars(self):
        """
        equalize record counts across record variables before flushing:
        scipy's netCDF3 writer interleaves per-record data and silently writes
        a corrupt file when record variables disagree on record count (e.g. a
        variable defined after records were written).  pad short variables
        with their fill value (or zero).
        """
        if self.mode == "r":
            return
        rec_vars = [
            var
            for var in self._fptr.variables.values()
            if var._shape and not var._shape[0]  # noqa: SLF001
        ]
        if not rec_vars:
            return
        n_recs = max(
            (0 if var.data is None else var.data.shape[0]) for var in rec_vars
        )
        for var in rec_vars:
            cur = 0 if var.data is None else var.data.shape[0]
            if cur < n_recs:
                tail = var.data.shape[1:] if var.data is not None else ()
                dtype = var.data.dtype if var.data is not None else np.float64
                fill = var._attributes.get(  # noqa: SLF001
                    "_FillValue", DEFAULT_FILLVALS.get(datatype_sname(dtype), 0)
                )
                # build explicitly (np.concatenate would strip the big-endian
                # byte order scipy's raw-byte writer relies on)
                grown = np.empty((n_recs,) + tuple(tail), dtype=dtype)
                if cur:
                    grown[:cur] = var.data
                grown[cur:] = fill
                # bypass scipy's attribute magic (see create_variable)
                var.__dict__["data"] = grown
        # bypass netcdf_file.__setattr__ (it records assignments as global attrs)
        self._fptr.__dict__["_recs"] = n_recs

    def sync(self):
        self._pad_record_vars()
        self._fptr.sync()

    def close(self):
        self._pad_record_vars()
        self._fptr.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False


def extract_dimensions(fptr: NCFile, names):
    """
    dict of {dimname: len} that the named dims/vars are defined on
    (capability parity: nk_ooc/utils.py:345-364)
    """
    if isinstance(names, str):
        names = [names]
    if not isinstance(names, (tuple, list)):
        raise TypeError(f"names must be a str, tuple, or list, not {type(names)}")
    res = {}
    for name in names:
        if name in fptr.dimensions:
            res[name] = fptr.dim_len(name)
        elif fptr.has_var(name):
            res.update(extract_dimensions(fptr, list(fptr.var(name).dimensions)))
        else:
            raise ValueError(f"unknown name {name}")
    return res


def metadata_same(fname1, fname2, log=None):
    """True if dimension/variable structure and attributes agree between files"""
    import logging

    logger = log or logging.getLogger(__name__)
    res = True
    with NCFile(fname1) as f1, NCFile(fname2) as f2:
        d1 = {k: f1.dim_len(k) for k in f1.dimensions}
        d2 = {k: f2.dim_len(k) for k in f2.dimensions}
        if d1.keys() != d2.keys():
            logger.info("    dimension name mismatch in %s and %s", fname1, fname2)
            res = False
        for dimname in d1:
            if dimname in d2 and d1[dimname] != d2[dimname]:
                logger.info("    %s length mismatch in %s and %s", dimname, fname1, fname2)
                res = False
        v1 = f1.variables
        v2 = f2.variables
        if v1.keys() != v2.keys():
            logger.info("    variable name mismatch in %s and %s", fname1, fname2)
            res = False
        for varname in v1:
            if varname not in v2:
                continue
            if v1[varname].dimensions != v2[varname].dimensions:
                logger.info("    %s dimension mismatch in %s and %s", varname, fname1, fname2)
                res = False
            a1 = {k: v for k, v in v1[varname].attrs.items() if k != "_FillValue"}
            a2 = {k: v for k, v in v2[varname].attrs.items() if k != "_FillValue"}
            if a1 != a2:
                logger.info("    %s attribute mismatch in %s and %s", varname, fname1, fname2)
                res = False
    return res


def isclose_all_vars(fname1, fname2, rtol, atol, log=None):
    """
    True if all common variables are np.isclose within tolerances; values are
    converted via the units layer when unit attributes differ
    (capability parity: nk_ooc/utils.py:261-342)
    """
    import logging

    from .units import unit_conversion_factor

    logger = log or logging.getLogger(__name__)
    res = True
    with NCFile(fname1) as f1, NCFile(fname2) as f2:
        vars1 = f1.variables
        vars2 = f2.variables
        for varname, var1 in vars1.items():
            if varname not in vars2:
                continue
            var2 = vars2[varname]
            if var1.shape != var2.shape:
                logger.info(
                    "    var1.shape %s != var2.shape %s for %s",
                    var1.shape,
                    var2.shape,
                    varname,
                )
                res = False
                continue
            vals1 = np.asarray(var1[:], dtype=np.float64)
            vals2 = np.asarray(var2[:], dtype=np.float64)
            units1 = var1.attrs.get("units")
            units2 = var2.attrs.get("units")
            if units1 is not None and units2 is not None and units1 != units2:
                if "since" in units1 or "since" in units2:
                    raise ValueError(
                        f"time-like units disagree '{units1}'!='{units2}'"
                    )
                factor = unit_conversion_factor(units1, units2)
                vals1 = factor * vals1
            if not np.isclose(vals1, vals2, rtol=rtol, atol=atol, equal_nan=True).all():
                logger.info("    %s vals not close", varname)
                bad = ~np.isclose(vals1, vals2, rtol=rtol, atol=atol, equal_nan=True)
                for val1, val2 in zip(vals1.reshape(-1)[bad.reshape(-1)][:20],
                                      vals2.reshape(-1)[bad.reshape(-1)][:20]):
                    atol_adj = abs(val1 - val2) - rtol * abs(val2)
                    rtol_adj = (abs(val1 - val2) - atol) / abs(val2) if val2 != 0 else np.inf
                    logger.info(
                        "    %.10e %.10e not close, atol_adj=%e, rtol_adj=%e",
                        val1,
                        val2,
                        atol_adj,
                        rtol_adj,
                    )
                res = False
    return res


def mkdir_exist_okay(path):
    """create directory, tolerating pre-existence"""
    if path:
        os.makedirs(path, exist_ok=True)
