"""native multi-file time averaging (replaces the reference's NCO `ncra`
subprocess calls, nk_ooc/utils.py:417-485).

Averages record (time-dimensioned) variables across a sequence of netCDF
files, optionally with per-file weights (noleap month lengths); non-record
variables are copied from the first file.  Output carries provenance history.

The port's own copy of newton_krylov_ooc_tpu/utils/ncmean.py.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime

import numpy as np

from .ncio import NCFile


def files_to_mean_file(dir_in, fnames, weights, fname_out, caller):
    """weighted mean of record variables across files; mean written to
    dir_in/fname_out"""
    logger = logging.getLogger(__name__)
    logger.debug("averaging %d files to %s", len(fnames), fname_out)

    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()

    paths = [os.path.join(dir_in, fname) for fname in fnames]
    out_path = os.path.join(dir_in, fname_out)

    with NCFile(paths[0]) as f0:
        dims0 = {name: f0.dim_len(name) for name in f0.dimensions}
        rec_dim = next(
            (name for name, length in f0.dimensions.items() if not length), None
        )
        vars0 = f0.variables
        var_meta = {
            name: (var.datatype, var.dimensions, var.attrs)
            for name, var in vars0.items()
        }
        base_vals = {name: var[:] for name, var in vars0.items()}
        history0 = f0.history

    accum = {}
    for name, (datatype, dimensions, _attrs) in var_meta.items():
        if rec_dim is not None and dimensions and dimensions[0] == rec_dim and (
            np.issubdtype(np.dtype(datatype), np.floating)
        ):
            accum[name] = weights[0] * np.asarray(base_vals[name], np.float64)

    for weight, path in zip(weights[1:], paths[1:]):
        with NCFile(path) as fptr:
            for name in accum:
                accum[name] += weight * np.asarray(fptr.var(name)[:], np.float64)

    with NCFile(out_path, mode="w") as fout:
        datestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        msg = (
            f"{datestamp}: mean of {len(fnames)} files computed by "
            f"{__name__} called from {caller}"
        )
        fout.history = msg if history0 is None else "\n".join([msg, history0])
        for name, length in dims0.items():
            if rec_dim is not None and name == rec_dim:
                fout.create_dimension(name, None)
            else:
                fout.create_dimension(name, length)
        for name, (datatype, dimensions, attrs) in var_meta.items():
            var = fout.create_variable(name, datatype, dimensions, attrs)
            if name in accum:
                vals = accum[name]
                if rec_dim is not None and dimensions[0] == rec_dim:
                    # reduce the record dim to a single mean record
                    if vals.shape[0] > 1:
                        vals = vals.mean(axis=0, keepdims=True)
                    var[0:1, ...] = vals
                else:
                    var[:] = vals
            else:
                vals = base_vals[name]
                if rec_dim is not None and dimensions and dimensions[0] == rec_dim:
                    var[0 : vals.shape[0], ...] = vals
                else:
                    var[:] = vals
    return out_path


def ann_files_to_mean_file(dir_in, fname_fmt, year0, cnt, fname_out, caller):
    """average cnt annual-mean files (fname_fmt has a {year} field)"""
    fnames = [fname_fmt.format(year=year0 + inc) for inc in range(cnt)]
    return files_to_mean_file(dir_in, fnames, np.ones(cnt), fname_out, caller)


def mon_files_to_climatology_file(
    dir_in, fname_fmt, year0, yr_cnt, fname_out, caller, month_dim="month"
):
    """monthly climatology across yr_cnt years of monthly-mean files: each
    calendar month averaged over the years and stacked along a new leading
    `month` dimension (length 12) replacing the record dimension.

    This is the seasonal-circulation input for the irf_offline family --
    the reference's workflow can only ncra-collapse the months into one
    annual mean (nk_ooc/cime_pop/setup_solver.py:100-166); here the
    seasonal cycle survives into the solver.  fname_fmt has {year} and
    {month} fields.  Non-record variables are copied from the first file.
    """
    logger = logging.getLogger(__name__)
    logger.debug(
        "monthly climatology of %d years to %s", yr_cnt, fname_out
    )
    out_path = os.path.join(dir_in, fname_out)

    first = os.path.join(dir_in, fname_fmt.format(year=year0, month=1))
    with NCFile(first) as f0:
        dims0 = {name: f0.dim_len(name) for name in f0.dimensions}
        rec_dim = next(
            (name for name, length in f0.dimensions.items() if not length), None
        )
        var_meta = {
            name: (var.datatype, var.dimensions, var.attrs)
            for name, var in f0.variables.items()
        }
        base_vals = {name: var[:] for name, var in f0.variables.items()}
        history0 = f0.history

    def is_record_float(name):
        datatype, dimensions, _attrs = var_meta[name]
        return (
            rec_dim is not None
            and name != rec_dim  # the record coordinate itself is replaced
            and dimensions
            and dimensions[0] == rec_dim
            and np.issubdtype(np.dtype(datatype), np.floating)
        )

    accum = {
        name: None for name in var_meta if is_record_float(name)
    }
    if not accum:
        raise ValueError(f"{first} has no record-dimensioned float variables")
    if (
        month_dim in dims0
        and month_dim != rec_dim
        and dims0[month_dim] != 12
    ):
        raise ValueError(
            f"{first} already has a {month_dim!r} dimension of length "
            f"{dims0[month_dim]}; pass a different month_dim"
        )
    for month in range(1, 13):
        for yr_inc in range(yr_cnt):
            path = os.path.join(
                dir_in, fname_fmt.format(year=year0 + yr_inc, month=month)
            )
            with NCFile(path) as fptr:
                for name in accum:
                    # collapse any per-file records, average over the years
                    vals = np.asarray(fptr.var(name)[:], np.float64).mean(
                        axis=0
                    ) / yr_cnt
                    if accum[name] is None:
                        accum[name] = np.zeros((12,) + vals.shape)
                    accum[name][month - 1] += vals

    with NCFile(out_path, mode="w") as fout:
        datestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        msg = (
            f"{datestamp}: {yr_cnt}-year monthly climatology computed by "
            f"{__name__} called from {caller}"
        )
        fout.history = msg if history0 is None else "\n".join([msg, history0])
        fout.create_dimension(month_dim, 12)
        for name, length in dims0.items():
            # month_dim was just created at length 12; an input dimension
            # of the same name (whatever its length) must not be re-created
            if name != rec_dim and name != month_dim:
                fout.create_dimension(name, length)
        for name, (datatype, dimensions, attrs) in var_meta.items():
            if name in accum:
                var = fout.create_variable(
                    name, datatype, (month_dim,) + tuple(dimensions[1:]), attrs
                )
                var[:] = accum[name]
            elif rec_dim is None or rec_dim not in dimensions:
                var = fout.create_variable(name, datatype, dimensions, attrs)
                var[:] = base_vals[name]
            # other record vars (the time coordinate, non-float records)
            # are dropped: the month axis replaces them
    return out_path


def mon_files_to_mean_file(dir_in, fname_fmt, year0, month0, cnt, fname_out, caller):
    """average cnt monthly-mean files with noleap month-length weights
    (fname_fmt has {year} and {month} fields; month0 need not be 1)"""
    days_in_month = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    weights = [days_in_month[(month0 - 1 + inc) % 12] for inc in range(cnt)]
    yr_vals = [year0 + (month0 - 1 + inc) // 12 for inc in range(cnt)]
    month_vals = [(month0 - 1 + inc) % 12 + 1 for inc in range(cnt)]
    fnames = [
        fname_fmt.format(year=yr_vals[inc], month=month_vals[inc])
        for inc in range(cnt)
    ]
    return files_to_mean_file(dir_in, fnames, weights, fname_out, caller)
