"""solver diagnostics as an append-only netCDF record file.

Each solver (Newton, Krylov) owns one ``<name>_stats.nc`` whose record
dimension is the solver iteration and whose second shared dimension is the
decoupled-region index; every record carries the per-(tracer module, region)
scalars of that iteration (iterate/fcn/increment mean & norm, Armijo
factors, Krylov iteration counts, preconditioned residual norms) plus any
model-specific reduced tracer fields.  Record growth writes fill values
into every record variable first, so a file snapshotted mid-iteration is
always well-formed.

Capability parity with the reference's per-solver stats files
(nk_ooc/stats_file.py, nk_ooc/solver_base.py:71-193); the on-disk layout
(dimension names, coordinate variables, fill conventions) is kept
identical so downstream tooling reads either implementation's files.
The port's own copy of newton_krylov_ooc_tpu/core/stats.py.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from ..utils.ncio import DEFAULT_FILLVALS, NCFile, datatype_sname
from .solver_state import action_step_log_wrap

RECORD_DIM = "iteration"
REGION_DIM = "region"


def _timestamp():
    return datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def _normalize(vars_metadata):
    """yield (name, datatype, dimensions, attrs) for each requested
    variable, defaulting a _FillValue onto record variables so that
    record growth can actively fill them (see _append_record)"""
    for name, md in vars_metadata.items():
        datatype = md.get("datatype", "f8")
        dims = tuple(md["dimensions"])
        attrs = dict(md.get("attrs") or {})
        if RECORD_DIM in dims and "_FillValue" not in attrs:
            sname = (
                datatype
                if isinstance(datatype, str)
                else datatype_sname(datatype)
            )
            attrs["_FillValue"] = DEFAULT_FILLVALS[sname]
        yield name, datatype, dims, attrs


def _append_record(fptr):
    """open record `n`: the coordinate gets its index, every other
    record variable gets its fill value (so readers -- and some ncview
    builds -- never see uninitialized bytes in a live file)"""
    rec = fptr.dim_len(RECORD_DIM)
    for name, var in fptr.variables.items():
        if name == RECORD_DIM:
            var[rec] = rec
        elif var.dimensions and var.dimensions[0] == RECORD_DIM:
            var[rec, ...] = var.attrs["_FillValue"]


class StatsFile:
    """one solver's stats file; all methods reopen/close the file so the
    on-disk state is durable at every return (the OOC resume contract)"""

    def __init__(self, name, workdir, region_cnt, solver_state):
        self._fname = os.path.join(workdir, f"{name}_stats.nc")
        self._bootstrap(
            name=name,
            fname=self._fname,
            region_cnt=region_cnt,
            solver_state=solver_state,
        )

    @property
    def fname(self):
        return self._fname

    @action_step_log_wrap("_create_stats_file {fname}", per_iteration=False)
    def _bootstrap(self, name, fname, region_cnt, solver_state):
        """write the empty file: shared dims + coordinate variables"""
        creator = f"{type(self).__module__}.{type(self).__name__}._bootstrap"
        with NCFile(fname, mode="w") as fptr:
            fptr.history = (
                f"{_timestamp()}: created by {creator} for {name} solver"
            )
            fptr.create_dimensions_verify(
                {RECORD_DIM: None, REGION_DIM: region_cnt}
            )
            # coordinates bypass _normalize: neither carries a _FillValue
            # (the record coordinate is always written on growth)
            fptr.create_variable(
                RECORD_DIM,
                "i4",
                (RECORD_DIM,),
                attrs={"long_name": f"{name} solver iteration"},
            )
            region_var = fptr.create_variable(
                REGION_DIM,
                "i4",
                (REGION_DIM,),
                attrs={
                    "long_name": "region index (0-based)",
                    # the axis attribute only exists so pyferret accepts
                    # the file; nothing in this package reads it
                    "comment": (
                        "the axis attribute lets pyferret open this file; "
                        "it is otherwise unused"
                    ),
                    "axis": "T",
                },
            )
            region_var[:] = np.arange(region_cnt, dtype=np.int32)

    def def_dimensions(self, dimensions):
        with NCFile(self._fname, mode="a") as fptr:
            fptr.create_dimensions_verify(dimensions)

    def def_vars(self, vars_metadata, caller=None):
        """define stats variables (record variables get active-fill
        defaults via _normalize)"""
        with NCFile(self._fname, mode="a") as fptr:
            for name, datatype, dims, attrs in _normalize(vars_metadata):
                fptr.create_variable(name, datatype, dims, attrs)
            if caller is not None:
                fptr.prepend_history(
                    f"{_timestamp()}: {','.join(vars_metadata)} appended "
                    f"by StatsFile.def_vars called by {caller}"
                )

    def put_vars_iteration_invariant(self, name_vals_dict):
        """write variables that do NOT carry the record dimension"""
        self._put(name_vals_dict, record=None)

    def put_vars(self, iteration, name_vals_dict):
        """write record variables at one record index, opening the
        record first if this index is one past the current end"""
        self._put(name_vals_dict, record=iteration)

    def _put(self, name_vals_dict, record):
        if not name_vals_dict:
            return
        with NCFile(self._fname, mode="a") as fptr:
            if record is not None and record == fptr.dim_len(RECORD_DIM):
                _append_record(fptr)
            for name, vals in name_vals_dict.items():
                var = fptr.var(name)
                is_record_var = RECORD_DIM in var.dimensions
                if record is None:
                    if is_record_var:
                        raise RuntimeError(
                            f"iteration is a dimension for {name}"
                        )
                    var[:] = vals
                else:
                    if not is_record_var:
                        raise RuntimeError(
                            f"iteration is not a dimension for {name}"
                        )
                    var[record, ...] = vals
