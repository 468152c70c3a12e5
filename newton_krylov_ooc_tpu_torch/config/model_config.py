"""model configuration: YAML tracer-module / preconditioner-matrix definitions,
parameterized-module ({suff}) expansion, grid/region variables.

Capability parity with nk_ooc/model_config.py.  The user-facing YAML schema is
unchanged.  The per-region mean operator is built as a dense row-stochastic
matrix (contracted in a single matmul) instead of a scipy CSR matrix.  The
port's own copy of newton_krylov_ooc_tpu/config/model_config.py.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import yaml

from ..utils.helpers import fmt_vals
from ..utils.ncio import NCFile
from ..utils.regions import region_mean_weights
from .share import repro_fname


class ModelConfig:
    """holds model configuration: modelinfo, tracer module defs, grid vars"""

    def __init__(self, modelinfo, lvl=logging.DEBUG):
        logger = logging.getLogger(__name__)
        logger.debug("ModelConfig")

        self.modelinfo = modelinfo

        fname = modelinfo["tracer_module_defs_fname"]
        logger.log(lvl, "loading content from %s", repro_fname(modelinfo, fname))
        with open(fname, mode="r") as fptr:
            file_contents = yaml.safe_load(fptr)
        self.tracer_module_defs = file_contents["tracer_module_defs"]
        check_shadow_tracers(self.tracer_module_defs, lvl)
        check_tracer_module_suffs(self.tracer_module_defs)
        check_tracer_module_names(
            modelinfo["tracer_module_names"], self.tracer_module_defs
        )
        self.precond_matrix_defs = file_contents["precond_matrix_defs"]
        propagate_base_matrix_defs_to_all(self.precond_matrix_defs)
        check_precond_matrix_defs(self.precond_matrix_defs)

        modelinfo["tracer_module_names"] = self.tracer_module_expand_all(
            modelinfo["tracer_module_names"]
        )

        self.grid_vars = {
            varname: gen_grid_vars(lvl, modelinfo["grid_vars_fname"], varname)
            for varname in self._resolve_region_mask_varnames(modelinfo)
        }
        self.region_cnt = self._common_region_cnt()

    def _resolve_region_mask_varnames(self, modelinfo):
        """push module-level region_mask_varname down onto each tracer's
        metadata; return the set of distinct mask names in active modules"""
        varnames = set()
        for module_name in modelinfo["tracer_module_names"].split(","):
            module_def = self.tracer_module_defs[module_name]
            module_default = module_def.get("region_mask_varname")
            for tracer_name, tracer_metadata in module_def["tracers"].items():
                if "region_mask_varname" not in tracer_metadata:
                    if module_default is None:
                        raise RuntimeError(
                            f"region_mask_varname not known for {tracer_name} in "
                            f"{module_name}"
                        )
                    tracer_metadata["region_mask_varname"] = module_default
                varnames.add(tracer_metadata["region_mask_varname"])
        return varnames

    def _common_region_cnt(self):
        """the region count shared by all masks (they must agree)"""
        region_cnts = {gv["region_cnt"] for gv in self.grid_vars.values()}
        if len(region_cnts) != 1:
            raise RuntimeError("not all region_masks have the same region_cnt")
        return region_cnts.pop()

    # -- parameterized module expansion --------------------------------------

    def tracer_module_expand_all(self, tracer_module_names):
        """expand 'name_{suff}:001:002' entries into concrete module defs"""
        expanded = []
        for tracer_module_name in tracer_module_names.split(","):
            if ":" not in tracer_module_name:
                expanded.append(tracer_module_name)
                continue
            root, _, suffs = tracer_module_name.partition(":")
            for suff in suffs.split(":"):
                expanded.append(self.tracer_module_expand_one(root, suff))
        return ",".join(expanded)

    def tracer_module_expand_one(self, tracer_module_name_root, suff):
        """instantiate one {suff}-parameterized tracer module definition"""
        fmt = {"suff": suff}
        name_new = tracer_module_name_root.format(**fmt)
        def_root = self.tracer_module_defs[tracer_module_name_root]
        self.tracer_module_defs[name_new] = fmt_vals(def_root, fmt)

        # expand referenced precond matrices whose names are parameterized
        for tracer_metadata in def_root["tracers"].values():
            if "precond_matrix" in tracer_metadata:
                matrix_name = tracer_metadata["precond_matrix"]
                matrix_name_new = matrix_name.format(**fmt)
                if matrix_name_new != matrix_name:
                    self.precond_matrix_defs[matrix_name_new] = fmt_vals(
                        self.precond_matrix_defs[matrix_name], fmt
                    )
        return name_new


def _is_parameterized(name):
    """does the name contain a {suff} placeholder"""
    return name.format(suff="suff") != name


def check_tracer_module_names(tracer_module_names, tracer_module_defs):
    """validate that listed module names exist and suffix usage is consistent"""
    for entry in tracer_module_names.split(","):
        root, _, suffs = entry.partition(":")
        if root not in tracer_module_defs:
            raise ValueError(f"unknown tracer module name {root}")
        wants_suff = _is_parameterized(root)
        if bool(suffs) != wants_suff:
            verb = "expects" if wants_suff else "doesn't expect"
            raise ValueError(f"{root} {verb} suff")


def check_shadow_tracers(tracer_module_defs, lvl):
    """validate shadow-tracer declarations (known names, no double-shadowing)"""
    logger = logging.getLogger(__name__)
    for tracer_module_name, tracer_module_def in tracer_module_defs.items():
        shadowed = []
        for tracer_name, tracer_metadata in tracer_module_def["tracers"].items():
            if "shadows" not in tracer_metadata:
                continue
            target = tracer_metadata["shadows"]
            if target not in tracer_module_def["tracers"]:
                raise ValueError(
                    f"shadows value {target} for {tracer_name} "
                    f"in tracer module {tracer_module_name} not known"
                )
            logger.log(
                lvl,
                "tracer module %s has %s as a shadow for %s",
                tracer_module_name,
                tracer_name,
                target,
            )
            if target in shadowed:
                raise ValueError(
                    f"{target} shadowed multiple times in "
                    f"tracer module {tracer_module_name}"
                )
            shadowed.append(target)


def check_tracer_module_suffs(tracer_module_defs):
    """validate that {suff} usage is consistent between names and metadata"""
    for name, metadata in tracer_module_defs.items():
        name_has_suff = _is_parameterized(name)
        metadata_has_suff = fmt_vals(metadata, {"suff": "suff"}) != metadata
        if name_has_suff != metadata_has_suff:
            raise ValueError(f"{name}: name_has_suff must equal metadata_has_suff")
        if not name_has_suff:
            continue
        for tracer_name in metadata["tracers"]:
            if not _is_parameterized(tracer_name):
                raise ValueError(f"{name}: tracer {tracer_name} must have suff")


def propagate_base_matrix_defs_to_all(matrix_defs):
    """propagate settings from the 'base' matrix def to all other matrix defs"""
    logger = logging.getLogger(__name__)
    if "base" not in matrix_defs:
        return
    for matrix_name, matrix_def in matrix_defs.items():
        if matrix_name != "base":
            logger.debug("propagating matrix def to %s", matrix_name)
            propagate_base_matrix_defs_to_one(matrix_defs["base"], matrix_def)


def _merge_opt_list(base_opts, matrix_opts):
    """append base opts whose first word isn't already present (the first word
    keys an option; a matrix-level opt overrides the base's version of it)"""
    existing_word0 = {opt.split()[0] for opt in matrix_opts}
    matrix_opts.extend(
        opt for opt in base_opts if opt.split()[0] not in existing_word0
    )


def propagate_base_matrix_defs_to_one(base_def, matrix_def):
    """merge one base matrix def into a specific matrix def

    list values merge by first-word key (see _merge_opt_list); dict values
    merge by key; other types are copied only when absent
    """
    for base_key, base_value in base_def.items():
        if base_key not in matrix_def:
            matrix_def[base_key] = copy.deepcopy(base_value)
        elif isinstance(base_value, list):
            _merge_opt_list(base_value, matrix_def[base_key])
        elif isinstance(base_value, dict):
            matrix_value = matrix_def[base_key]
            for key, value in base_value.items():
                matrix_value.setdefault(key, value)
        else:
            raise TypeError(f"base defn type {type(base_value)} not supported")


def check_precond_matrix_defs(precond_matrix_defs):
    """validate precond matrix defs (recognized :time_op suffixes)"""
    logger = logging.getLogger(__name__)
    for precond_matrix_name, precond_matrix_def in precond_matrix_defs.items():
        logger.debug("checking precond_matrix_def for %s", precond_matrix_name)
        for hist_var in precond_matrix_def.get("hist_to_precond_varnames", []):
            _, _, time_op = hist_var.partition(":")
            if time_op not in ["mean", "log_mean", ""]:
                raise ValueError(
                    f"unknown time_op={time_op} in {hist_var} from "
                    f"{precond_matrix_name}"
                )


def gen_grid_vars(lvl, grid_vars_fname, region_mask_varname):
    """grid vars tied to one region mask: the mask itself, per-cell averaging
    weights (located via the mask's cell_measures attribute), the dense
    region-mean operator, and the region count"""
    logger = logging.getLogger(__name__)
    logger.log(
        lvl, "reading grid_vars for %s from %s", region_mask_varname, grid_vars_fname
    )

    res = {}
    with NCFile(grid_vars_fname) as fptr:
        region_mask_var = fptr.var(region_mask_varname)
        res["region_mask"] = np.array(region_mask_var[:])
        cell_measures = region_mask_var.attrs["cell_measures"]
        cell_measures_split = cell_measures.split(":")
        if len(cell_measures_split) != 2:
            raise RuntimeError(
                f"unexpected number of words in {region_mask_varname}:cell_measures"
            )
        grid_weight_varname = cell_measures_split[-1].split()[0]
        res["grid_weight"] = np.array(fptr.var(grid_weight_varname)[:], dtype=np.float64)

    # mask and weight are mutually consistent: both zero where either is
    res["region_mask"] = np.where(res["grid_weight"] == 0.0, 0, res["region_mask"])
    res["grid_weight"] = np.where(res["region_mask"] == 0, 0.0, res["grid_weight"])

    res["region_cnt"] = int(res["region_mask"].max())
    res["region_comp_mean_matrix"] = region_mean_weights(
        res["region_mask"], res["grid_weight"]
    )
    return res
