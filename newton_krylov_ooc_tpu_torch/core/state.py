"""model-state vector space: tracer modules and operations on them.

A model state is an ordered collection of tracer modules; each tracer module is
a stacked (tracer_cnt, *grid_shape) float64 array plus metadata.  The solvers
treat states as abstract vectors: algebra, weighted means/dot-products/norms
reduced per (tracer module, region), modified Gram-Schmidt against file-stored
bases, bounds limiting, shadow tracers, region masking, netCDF dump/load, and
Jacobian-vector products (finite-difference against a second forward run).

Capability parity: nk_ooc/model_state_base.py and
nk_ooc/tracer_module_state_base.py.  The layout differs deliberately: tracers
are stacked into one contiguous array per module (device-transfer friendly, no
xarray), and all per-region reductions contract against a dense row-stochastic
matrix.  The port's own copy of newton_krylov_ooc_tpu/core/state.py; model
and tracer-module classes are looked up in newton_krylov_ooc_tpu_torch.models,
and the step-log strings are the JAX package's, letter for letter (the golden
Newton_state.json files are compared byte for byte).
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np

from ..utils.helpers import attr_common, class_name, dict_update_verify, get_subclasses
from ..utils.ncio import NCFile, extract_dimensions
from ..utils.regions import broadcast_region_vals, comp_scalef_lob, comp_scalef_upb
from .solver_state import action_step_log_wrap

MODELS_PACKAGE = "newton_krylov_ooc_tpu_torch.models"


class TracerModuleState:
    """a collection of tracers solved for as one independent block"""

    # operators take precedence over numpy's
    __array_priority__ = 100

    model_config_obj = None

    def __init__(self, tracer_module_name, fname, model_config_obj):
        logger = logging.getLogger(__name__)
        logger.debug(
            'TracerModuleState, tracer_module_name="%s", fname="%s"',
            tracer_module_name,
            fname,
        )
        TracerModuleState.model_config_obj = model_config_obj

        self.name = tracer_module_name
        self._tracer_module_def = model_config_obj.tracer_module_defs[
            tracer_module_name
        ]
        self.tracer_names = list(self._tracer_module_def["tracers"])
        self.tracer_cnt = len(self.tracer_names)
        self.units = attr_common(self._tracer_module_def["tracers"], "units")
        self._vals = self._load_vals(fname)  # (tracer_cnt, *grid_shape)

    # -- loading / dumping (subclasses provide grid specifics) ---------------

    def grid_dims(self):
        """netCDF dimension names of one tracer's grid; implemented in
        model-specific subclasses"""
        raise NotImplementedError("Method must be implemented in derived class")

    def _load_vals(self, fname):
        """load stacked tracer values from a netCDF file"""
        grid_vars = self.get_grid_vars(self.tracer_names[0])
        grid_shape = grid_vars["region_mask"].shape
        vals = np.empty((self.tracer_cnt, *grid_shape))
        with NCFile(fname) as fptr:
            for ind, tracer_name in enumerate(self.tracer_names):
                dimensions = extract_dimensions(fptr, tracer_name)
                if tuple(dimensions.values()) != grid_shape:
                    raise ValueError(
                        f"unexpected dimension lengths for {tracer_name} in {fname}"
                    )
                vals[ind] = fptr.var(tracer_name)[:]
        return vals

    def dump(self, fptr, action):
        """define or write this module's tracers to an open netCDF file;
        implemented in derived classes (grid metadata differs per model)"""
        raise NotImplementedError("Method must be implemented in derived class")

    # -- metadata ------------------------------------------------------------

    def get_grid_vars(self, tracer_name):
        """grid vars (region_mask, weights, mean operator) for tracer_name"""
        tracer_metadata = self._tracer_module_def["tracers"][tracer_name]
        return self.model_config_obj.grid_vars[tracer_metadata["region_mask_varname"]]

    @property
    def region_cnt(self):
        return self.model_config_obj.region_cnt

    def tracer_index(self, tracer_name):
        try:
            return self.tracer_names.index(tracer_name)
        except ValueError as exc:
            raise KeyError(f"unknown tracer_name={tracer_name}") from exc

    # -- value access ----------------------------------------------------------

    def get_tracer_vals_all(self):
        return self._vals.copy()

    def set_tracer_vals_all(self, vals_all, reseat_vals=False):
        if reseat_vals:
            self._vals = np.array(vals_all, dtype=np.float64)
        else:
            self._vals[:] = vals_all

    def get_tracer_vals(self, tracer_name):
        return self._vals[self.tracer_index(tracer_name)].copy()

    def set_tracer_vals(self, tracer_name, vals):
        self._vals[self.tracer_index(tracer_name)] = vals

    # -- vector algebra ----------------------------------------------------------

    def _like(self, vals):
        res = copy.copy(self)
        res._vals = vals
        return res

    def __neg__(self):
        return self._like(-self._vals)

    def _coerce(self, other):
        """array factor for scalar / per-region / module operands"""
        if isinstance(other, (int, float)):
            return float(other)
        if isinstance(other, np.ndarray) and other.shape == (self.region_cnt,):
            # per-region scalars broadcast onto the grid (fill 1 outside regions)
            region_mask = self.get_grid_vars(self.tracer_names[0])["region_mask"]
            return broadcast_region_vals(region_mask, other)
        return None

    def __add__(self, other):
        if isinstance(other, TracerModuleState):
            return self._like(self._vals + other._vals)
        return NotImplemented

    def __iadd__(self, other):
        if isinstance(other, TracerModuleState):
            self._vals += other._vals
            return self
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, TracerModuleState):
            return self._like(self._vals - other._vals)
        return NotImplemented

    def __isub__(self, other):
        if isinstance(other, TracerModuleState):
            self._vals -= other._vals
            return self
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, TracerModuleState):
            return self._like(self._vals * other._vals)
        factor = self._coerce(other)
        if factor is None:
            return NotImplemented
        return self._like(self._vals * factor)

    __rmul__ = __mul__

    def __imul__(self, other):
        if isinstance(other, TracerModuleState):
            self._vals *= other._vals
            return self
        factor = self._coerce(other)
        if factor is None:
            return NotImplemented
        self._vals *= factor
        return self

    def __truediv__(self, other):
        if isinstance(other, TracerModuleState):
            return self._like(self._vals / other._vals)
        if isinstance(other, (int, float)):
            return self._like(self._vals * (1.0 / other))
        factor = self._coerce(other)
        if factor is None:
            return NotImplemented
        return self._like(self._vals / factor)

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)):
            return self._like(other / self._vals)
        factor = self._coerce(other)
        if factor is None:
            return NotImplemented
        return self._like(factor / self._vals)

    def __itruediv__(self, other):
        if isinstance(other, TracerModuleState):
            self._vals /= other._vals
            return self
        if isinstance(other, (int, float)):
            self._vals *= 1.0 / other
            return self
        factor = self._coerce(other)
        if factor is None:
            return NotImplemented
        self._vals /= factor
        return self

    # -- reductions -----------------------------------------------------------

    def mean(self):
        """per-region weighted mean, summed over tracers -> (region_cnt,)"""
        matrix = self.get_grid_vars(self.tracer_names[0])["region_comp_mean_matrix"]
        return matrix @ self._vals.sum(axis=0).reshape(-1)

    def dot_prod(self, other):
        """per-region weighted dot product with other -> (region_cnt,)"""
        matrix = self.get_grid_vars(self.tracer_names[0])["region_comp_mean_matrix"]
        prod = (self._vals * other._vals).sum(axis=0)
        return matrix @ prod.reshape(-1)

    # -- bounds limiting ---------------------------------------------------------

    def has_bounds(self):
        if "bounds" in self._tracer_module_def:
            return True
        return any(
            "bounds" in md for md in self._tracer_module_def["tracers"].values()
        )

    def get_bounds(self, tracer_name):
        """(lob, upb) for tracer_name; either may be None"""
        lob, upb = None, None
        for metadata in (
            self._tracer_module_def,
            self._tracer_module_def["tracers"][tracer_name],
        ):
            if "bounds" in metadata:
                lob = metadata["bounds"].get("lob", lob)
                upb = metadata["bounds"].get("upb", upb)
        return lob, upb

    def apply_limiter(self, base):
        """
        scale self (in place, per region) by the largest factor in [0, 1] such
        that base + scalef * self stays within the module's tracer bounds;
        returns the per-region factors
        """
        if not self.has_bounds():
            return 1.0

        scalef = np.ones(self.region_cnt)
        scalef_tracer = np.ones(self.region_cnt)
        for tracer_name in self.tracer_names:
            region_mask = self.get_grid_vars(tracer_name)["region_mask"]
            lob, upb = self.get_bounds(tracer_name)
            base_vals = base.get_tracer_vals(tracer_name)
            inc_vals = self.get_tracer_vals(tracer_name)
            if lob is not None:
                comp_scalef_lob(
                    self.region_cnt, region_mask, base_vals, inc_vals, lob,
                    out=scalef_tracer,
                )
                np.minimum(scalef, scalef_tracer, out=scalef)
            if upb is not None:
                comp_scalef_upb(
                    self.region_cnt, region_mask, base_vals, inc_vals, upb,
                    out=scalef_tracer,
                )
                np.minimum(scalef, scalef_tracer, out=scalef)

        if (scalef < 1.0).any():
            self.log_vals("applying scalef", scalef)
            self *= scalef
        return scalef

    # -- shadow / extra tracers -----------------------------------------------

    def shadow_tracers_on(self):
        return any(
            "shadows" in md for md in self._tracer_module_def["tracers"].values()
        )

    def copy_shadow_tracers_to_real_tracers(self):
        for tracer_name, metadata in self._tracer_module_def["tracers"].items():
            if "shadows" in metadata:
                self.set_tracer_vals(
                    metadata["shadows"], self.get_tracer_vals(tracer_name)
                )

    def copy_real_tracers_to_shadow_tracers(self):
        for tracer_name, metadata in self._tracer_module_def["tracers"].items():
            if "shadows" in metadata:
                self.set_tracer_vals(
                    tracer_name, self.get_tracer_vals(metadata["shadows"])
                )

    def extra_tracer_names(self):
        """tracers not being solved for (the shadowed real tracers)"""
        return [
            metadata["shadows"]
            for metadata in self._tracer_module_def["tracers"].values()
            if "shadows" in metadata
        ]

    def zero_extra_tracers(self):
        for tracer_name in self.extra_tracer_names():
            self.set_tracer_vals(tracer_name, 0.0)
        return self

    def apply_region_mask(self):
        """zero tracer values outside the computational domain"""
        for ind, tracer_name in enumerate(self.tracer_names):
            region_mask = self.get_grid_vars(tracer_name)["region_mask"]
            self._vals[ind] = np.where(region_mask != 0, self._vals[ind], 0.0)

    def broadcast_region_vals(self, vals, tracer_name, fill_value=1.0):
        region_mask = self.get_grid_vars(tracer_name)["region_mask"]
        return broadcast_region_vals(region_mask, vals, fill_value)

    # -- preconditioner metadata ---------------------------------------------

    def precond_matrix_list(self):
        res = []
        for metadata in self._tracer_module_def["tracers"].values():
            if "precond_matrix" in metadata:
                name = metadata["precond_matrix"]
                if name not in res:
                    res.append(name)
        return res

    def append_tracer_names_per_precond_matrix(self, res):
        for tracer_name, metadata in self._tracer_module_def["tracers"].items():
            if "precond_matrix" in metadata:
                res.setdefault(metadata["precond_matrix"], []).append(tracer_name)

    # -- stats / hist hooks (model-specific subclasses override) --------------

    def stats_dimensions(self, fptr):
        raise NotImplementedError("Method must be implemented in derived class")

    def stats_vars_metadata(self, fptr_hist):
        raise NotImplementedError("Method must be implemented in derived class")

    def stats_vars_vals_iteration_invariant(self, fptr_hist):
        raise NotImplementedError("Method must be implemented in derived class")

    def stats_vars_vals(self, fptr_hist):
        raise NotImplementedError("Method must be implemented in derived class")

    def stats_vars_tracer_like(self):
        return list(self._tracer_module_def["tracers"])

    # -- logging ------------------------------------------------------------

    def log_vals(self, msg, vals):
        """write per-module scalar diagnostics to the log"""
        logger = logging.getLogger(__name__)
        vals = np.asarray(vals)
        if vals.ndim >= 1 and vals.shape[-1] == 1:
            self.log_vals(msg, vals[..., 0])
            return
        if vals.ndim == 0:
            logger.info("%s[%s]=%e", msg, self.name, vals)
        elif vals.ndim == 1:
            for j, val in enumerate(vals):
                logger.info("%s[%s,%d]=%e", msg, self.name, j, val)
        elif vals.ndim == 2:
            for i in range(vals.shape[0]):
                for j in range(vals.shape[1]):
                    logger.info("%s[%s,%d,%d]=%e", msg, self.name, i, j, vals[i, j])
        else:
            raise ValueError(f"vals.ndim={vals.ndim} not handled")


class ModelState:
    """state space of a model: an ordered collection of tracer modules"""

    __array_priority__ = 100

    model_config_obj = None

    def __init__(self, fname):
        logger = logging.getLogger(__name__)
        logger.debug('ModelState, fname="%s"', fname)

        if self.model_config_obj is None:
            raise RuntimeError(
                "self.model_config_obj is None, it should be set in derived class"
            )

        modelinfo = self.model_config_obj.modelinfo
        tracer_module_names = modelinfo["tracer_module_names"].split(",")
        tracer_module_defs = self.model_config_obj.tracer_module_defs

        self.tracer_modules = []
        for tracer_module_name in tracer_module_names:
            tracer_module_def = tracer_module_defs[tracer_module_name]
            tms_class = get_tracer_module_state_class(
                modelinfo["model_name"], tracer_module_name, tracer_module_def
            )
            logger.debug(
                "using class %s from %s for tracer module %s",
                tms_class.__name__,
                tms_class.__module__,
                tracer_module_name,
            )
            self.tracer_modules.append(
                self._create_tracer_module(tms_class, tracer_module_name, fname)
            )

    def _create_tracer_module(self, tms_class, tracer_module_name, fname):
        """instantiate one tracer module; model subclasses pass extra context
        (grid axes etc.) by overriding this hook"""
        return tms_class(tracer_module_name, fname, self.model_config_obj)

    # -- model hooks (implemented by model subclasses) ------------------------

    def comp_fcn(self, res_fname, solver_state, hist_fname=None):
        """evaluate the function being solved with Newton's method"""
        raise NotImplementedError("Method must be implemented in derived class")

    def apply_precond_jacobian(self, precond_fname, res_fname, solver_state):
        """apply the preconditioner of the Jacobian of comp_fcn to self"""
        raise NotImplementedError("Method must be implemented in derived class")

    # -- structural helpers -------------------------------------------------

    @property
    def region_cnt(self):
        return self.model_config_obj.region_cnt

    def _map(self, fcn):
        """new ModelState with fcn applied to each tracer module"""
        res = copy.copy(self)
        res.tracer_modules = [fcn(tm) for tm in self.tracer_modules]
        return res

    def _zip(self, fcn, other):
        res = copy.copy(self)
        res.tracer_modules = [
            fcn(tm_a, tm_b)
            for tm_a, tm_b in zip(self.tracer_modules, other.tracer_modules)
        ]
        return res

    @staticmethod
    def _per_module_factor(other, ind):
        """slice a per-module operand (leading axis = module index)"""
        return other[ind, ...]

    # -- vector algebra ------------------------------------------------------

    def __neg__(self):
        return self._map(lambda tm: -tm)

    def __add__(self, other):
        if isinstance(other, ModelState):
            return self._zip(lambda a, b: a + b, other)
        return NotImplemented

    __radd__ = __add__

    def __iadd__(self, other):
        if isinstance(other, ModelState):
            for ind, tm in enumerate(other.tracer_modules):
                self.tracer_modules[ind] += tm
            return self
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, ModelState):
            return self._zip(lambda a, b: a - b, other)
        return NotImplemented

    def __isub__(self, other):
        if isinstance(other, ModelState):
            for ind, tm in enumerate(other.tracer_modules):
                self.tracer_modules[ind] -= tm
            return self
        return NotImplemented

    def _factored(self, other, op):
        res = copy.copy(self)
        if isinstance(other, float):
            res.tracer_modules = [op(tm, other) for tm in self.tracer_modules]
        elif isinstance(other, np.ndarray) and other.shape[0] == len(
            self.tracer_modules
        ):
            res.tracer_modules = [
                op(tm, self._per_module_factor(other, ind))
                for ind, tm in enumerate(self.tracer_modules)
            ]
        elif isinstance(other, ModelState):
            res.tracer_modules = [
                op(tm_a, tm_b)
                for tm_a, tm_b in zip(self.tracer_modules, other.tracer_modules)
            ]
        else:
            return NotImplemented
        return res

    def __mul__(self, other):
        return self._factored(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __imul__(self, other):
        res = self._factored(other, lambda a, b: a.__imul__(b))
        if res is NotImplemented:
            return NotImplemented
        self.tracer_modules = res.tracer_modules
        return self

    def __truediv__(self, other):
        return self._factored(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        res = copy.copy(self)
        if isinstance(other, float):
            res.tracer_modules = [other / tm for tm in self.tracer_modules]
        elif isinstance(other, np.ndarray) and other.shape[0] == len(
            self.tracer_modules
        ):
            res.tracer_modules = [
                self._per_module_factor(other, ind) / tm
                for ind, tm in enumerate(self.tracer_modules)
            ]
        else:
            return NotImplemented
        return res

    def __itruediv__(self, other):
        res = self._factored(other, lambda a, b: a.__itruediv__(b))
        if res is NotImplemented:
            return NotImplemented
        self.tracer_modules = res.tracer_modules
        return self

    # -- reductions ------------------------------------------------------------

    def mean(self):
        """(module_cnt, region_cnt) weighted means"""
        return np.stack([tm.mean() for tm in self.tracer_modules])

    def dot_prod(self, other):
        """(module_cnt, region_cnt) weighted dot products"""
        return np.stack(
            [
                tm.dot_prod(tm_o)
                for tm, tm_o in zip(self.tracer_modules, other.tracer_modules)
            ]
        )

    def norm(self):
        """(module_cnt, region_cnt) weighted l2 norms"""
        return np.sqrt(self.dot_prod(self))

    def mod_gram_schmidt(self, basis_cnt, fname_fcn, quantity):
        """
        in-place modified Gram-Schmidt projection against file-stored basis
        vectors; returns (module_cnt, basis_cnt, region_cnt) coefficients
        """
        h_val = np.empty((len(self.tracer_modules), basis_cnt, self.region_cnt))
        for i_val in range(basis_cnt):
            basis_i = type(self)(fname_fcn(quantity, i_val))
            h_val[:, i_val, :] = self.dot_prod(basis_i)
            self -= h_val[:, i_val, :] * basis_i
        return h_val

    # -- limiting / shadow / masking ------------------------------------------

    def apply_limiter(self, base):
        """per-module bounds limiting; returns (module_cnt, region_cnt) factors"""
        scalef = np.empty((len(self.tracer_modules), self.region_cnt))
        for ind, tm in enumerate(self.tracer_modules):
            scalef[ind, :] = tm.apply_limiter(base.tracer_modules[ind])
        return scalef

    def shadow_tracers_on(self):
        return any(tm.shadow_tracers_on() for tm in self.tracer_modules)

    def copy_shadow_tracers_to_real_tracers(self):
        for tm in self.tracer_modules:
            tm.copy_shadow_tracers_to_real_tracers()
        return self

    def copy_real_tracers_to_shadow_tracers(self):
        for tm in self.tracer_modules:
            tm.copy_real_tracers_to_shadow_tracers()
        return self

    def zero_extra_tracers(self):
        for tm in self.tracer_modules:
            tm.zero_extra_tracers()
        return self

    def apply_region_mask(self):
        for tm in self.tracer_modules:
            tm.apply_region_mask()
        return self

    def get_tracer_vals(self, tracer_name):
        for tm in self.tracer_modules:
            try:
                return tm.get_tracer_vals(tracer_name)
            except KeyError:
                pass
        raise KeyError(f"unknown tracer_name={tracer_name}")

    def set_tracer_vals(self, tracer_name, vals):
        for tm in self.tracer_modules:
            try:
                tm.set_tracer_vals(tracer_name, vals)
                return
            except KeyError:
                pass
        raise KeyError(f"unknown tracer_name={tracer_name}")

    # -- IO -------------------------------------------------------------------

    def dump(self, fname, caller=None):
        """dump to a netCDF file (no-op returning self when fname is None)"""
        logger = logging.getLogger(__name__)
        logger.debug('fname="%s"', fname)
        if fname is None:
            return self
        if caller is None:
            raise ValueError("caller unknown")
        with NCFile(fname, mode="w") as fptr:
            fptr.stamp_history(f"{class_name(self)}.dump", caller)
            for action in ["define", "write"]:
                for tm in self.tracer_modules:
                    tm.dump(fptr, action)
        return self

    def comp_fcn_postprocess(self, res_fname, caller):
        """postprocessing common to all comp_fcn hooks: zero extra tracers,
        apply the region mask, dump"""
        fcn_name = f"{class_name(self)}.comp_fcn_postprocess"
        return (
            self.zero_extra_tracers()
            .apply_region_mask()
            .dump(res_fname, f"{fcn_name} called from {caller}")
        )

    # -- Jacobian-vector product -------------------------------------------------

    def comp_jacobian_fcn_state_prod(self, fcn, direction, res_fname, solver_state):
        """
        product of the Jacobian of comp_fcn at self with unit vector direction,
        via one-sided finite difference (sigma = 1e-4 * ||self||); a second
        forward model run evaluates the perturbed state
        """
        logger = logging.getLogger(__name__)
        logger.debug('res_fname="%s"', res_fname)

        fcn_complete_step = f"comp_jacobian_fcn_state_prod complete for {res_fname}"
        if solver_state is not None and solver_state.step_logged(fcn_complete_step):
            logger.debug('"%s" logged, returning result', fcn_complete_step)
            return type(self)(res_fname)
        logger.debug('"%s" not logged, proceeding', fcn_complete_step)

        sigma = 1.0e-4 * self.norm()
        sigma = np.where(sigma == 0.0, 1.0, sigma)

        perturb_ms = self + sigma * direction
        perturb_fcn_fname = (
            None
            if solver_state is None
            else os.path.join(
                solver_state.get_workdir(),
                f"perturb_fcn_{os.path.basename(res_fname)}",
            )
        )
        perturb_fcn = perturb_ms.comp_fcn(perturb_fcn_fname, solver_state)

        caller = f"{class_name(self)}.comp_jacobian_fcn_state_prod"
        res = ((perturb_fcn - fcn) / sigma).dump(res_fname, caller)

        if solver_state is not None:
            solver_state.log_step(fcn_complete_step)
        return res

    # -- preconditioner-input generation ----------------------------------------

    def precond_matrix_list(self):
        res = []
        for tm in self.tracer_modules:
            res.extend(tm.precond_matrix_list())
        return res

    def tracer_names_per_precond_matrix(self):
        res: dict = {}
        for tm in self.tracer_modules:
            tm.append_tracer_names_per_precond_matrix(res)
        return res

    def hist_vars_for_precond_list(self):
        """hist vars (with :time_op suffixes) the preconditioner needs"""
        res = []
        precond_matrix_defs = self.model_config_obj.precond_matrix_defs
        for matrix_name in self.precond_matrix_list() + ["base"]:
            for varname in precond_matrix_defs[matrix_name][
                "hist_to_precond_varnames"
            ]:
                if varname not in res:
                    res.append(varname)
        return res

    @action_step_log_wrap(
        step="ModelStateBase.gen_precond_jacobian {precond_fname}", per_iteration=False
    )
    def gen_precond_jacobian(self, hist_fname, precond_fname, solver_state):
        """extract (time-reduced) hist vars into the preconditioner input file"""
        logger = logging.getLogger(__name__)
        logger.debug(
            'hist_fname="%s", precond_fname="%s"', hist_fname, precond_fname
        )

        hist_vars = self.hist_vars_for_precond_list()

        with NCFile(hist_fname) as fptr_in, NCFile(precond_fname, mode="w") as fptr_out:
            fptr_out.stamp_history(f"{class_name(self)}.gen_precond_jacobian")
            hist_history = fptr_in.history
            if hist_history is not None:
                fptr_out.history = "\n".join([fptr_out.history, hist_history])

            # dimensions + coordinate vars needed by the extracted vars
            coord_metadata = {}
            for hist_var in hist_vars:
                hist_varname, _, time_op = hist_var.partition(":")
                dimensions = _precond_dimensions_for_hist_var(
                    fptr_in, hist_varname, time_op
                )
                fptr_out.create_dimensions_verify(dimensions)
                for dimname in dimensions:
                    if fptr_in.has_var(dimname) and dimname not in coord_metadata:
                        coord_var = fptr_in.var(dimname)
                        coord_metadata[dimname] = {
                            "datatype": coord_var.datatype,
                            "dimensions": coord_var.dimensions,
                            "attrs": coord_var.attrs,
                        }
            fptr_out.create_vars(coord_metadata)
            for dimname in coord_metadata:
                fptr_out.var(dimname)[:] = fptr_in.var(dimname)[:]

            for hist_var in hist_vars:
                hist_varname, _, time_op = hist_var.partition(":")
                if hist_varname in fptr_out.dimensions:
                    continue  # coordinate vars handled above
                var_in = fptr_in.var(hist_varname)
                dimensions = _precond_dimensions_for_hist_var(
                    fptr_in, hist_varname, time_op
                )
                attrs = var_in.attrs
                # drop cell_methods referencing a time dim absent from the result
                if "cell_methods" in attrs:
                    if "time:" in attrs["cell_methods"] and "time" not in dimensions:
                        attrs = {
                            k: v for k, v in attrs.items() if k != "cell_methods"
                        }

                vals = var_in[:]
                if time_op == "mean":
                    precond_varname = f"{hist_varname}_mean"
                    attrs = dict(attrs)
                    attrs["long_name"] += ", mean over time dim"
                    vals = vals.mean(axis=0)
                elif time_op == "log_mean":
                    precond_varname = f"{hist_varname}_log_mean"
                    attrs = dict(attrs)
                    attrs["long_name"] += ", log mean over time dim"
                    vals = np.exp(np.log(vals).mean(axis=0))
                else:
                    precond_varname = hist_varname
                    if vals.ndim == len(dimensions) + 1:
                        vals = vals[0, ...]  # singleton time dim dropped

                var_out = fptr_out.create_variable(
                    precond_varname, var_in.datatype, tuple(dimensions), attrs
                )
                var_out[:] = vals

    # -- stats hooks -----------------------------------------------------------

    @action_step_log_wrap(step="ModelStateBase.def_stats_vars", per_iteration=False)
    def def_stats_vars(self, stats_file, hist_fname, solver_state):
        """define model-specific stats variables"""
        dimensions: dict = {}
        vars_metadata: dict = {}
        with NCFile(hist_fname) as fptr_hist:
            for tm in self.tracer_modules:
                dict_update_verify(dimensions, tm.stats_dimensions(fptr_hist))
                dict_update_verify(vars_metadata, tm.stats_vars_metadata(fptr_hist))
        stats_file.def_dimensions(dimensions)
        stats_file.def_vars(vars_metadata)

    @action_step_log_wrap(
        step="ModelStateBase.put_stats_vars_iteration_invariant", per_iteration=False
    )
    def put_stats_vars_iteration_invariant(self, stats_file, hist_fname, solver_state):
        name_vals: dict = {}
        with NCFile(hist_fname) as fptr_hist:
            for tm in self.tracer_modules:
                dict_update_verify(
                    name_vals, tm.stats_vars_vals_iteration_invariant(fptr_hist)
                )
        stats_file.put_vars_iteration_invariant(name_vals)

    @action_step_log_wrap(step="ModelStateBase.put_stats_vars")
    def put_stats_vars(self, stats_file, hist_fname, solver_state):
        name_vals: dict = {}
        with NCFile(hist_fname) as fptr_hist:
            for tm in self.tracer_modules:
                dict_update_verify(name_vals, tm.stats_vars_vals(fptr_hist))
        stats_file.put_vars(solver_state.get_iteration(), name_vals)

    # -- logging ------------------------------------------------------------

    def log_vals(self, msg, vals):
        for ind, tm in enumerate(self.tracer_modules):
            if isinstance(msg, list):
                for msg_ind, submsg in enumerate(msg):
                    tm.log_vals(submsg, vals[msg_ind, ind, ...])
            else:
                tm.log_vals(msg, vals[ind, ...])

    def log(self, msg=None):
        msg_full = (
            ["mean", "norm"] if msg is None else [f"{msg},mean", f"{msg},norm"]
        )
        self.log_vals(msg_full, np.stack((self.mean(), self.norm())))


def _precond_dimensions_for_hist_var(fptr_hist, hist_varname, time_op):
    """dimensions of hist_varname's representation in the precond file"""
    dimensions = extract_dimensions(fptr_hist, hist_varname)
    if time_op in ("mean", "log_mean"):
        del dimensions["time"]
    if dimensions.get("time", None) == 1:
        del dimensions["time"]
    return dimensions


def lin_comb(res_type, coeff, fname_fcn, quantity):
    """linear combination of file-stored ModelStates:
    sum_j coeff[..., j, :] * state_j"""
    res = coeff[..., 0, :] * res_type(fname_fcn(quantity, 0))
    for j_val in range(1, coeff.shape[-2]):
        res += coeff[..., j_val, :] * res_type(fname_fcn(quantity, j_val))
    return res


def get_model_state_class(model_name, lvl=logging.DEBUG):
    """model-specific ModelState subclass, discovered from
    newton_krylov_ooc_tpu_torch.models.<model_name>.model_state"""
    logger = logging.getLogger(__name__)
    model_state_class = ModelState
    mod_name = f"{MODELS_PACKAGE}.{model_name}.model_state"
    subclasses = get_subclasses(mod_name, model_state_class)
    if subclasses:
        model_state_class = subclasses[0]
    logger.log(
        lvl,
        "using class %s from %s for model state",
        model_state_class.__name__,
        model_state_class.__module__,
    )
    return model_state_class


def get_tracer_module_state_class(model_name, tracer_module_name, tracer_module_def):
    """tracer-module-specific TracerModuleState subclass: the model's generic
    subclass, further specialized by a module named after the tracer module
    (or its py_mod_name)"""
    tms_class = TracerModuleState

    mod_name = f"{MODELS_PACKAGE}.{model_name}.tracer_module_state"
    subclasses = get_subclasses(mod_name, tms_class)
    if subclasses:
        tms_class = subclasses[0]

    py_mod_name = tracer_module_def.get("py_mod_name", tracer_module_name)
    mod_name = f"{MODELS_PACKAGE}.{model_name}.{py_mod_name}"
    subclasses = get_subclasses(mod_name, tms_class)
    if subclasses:
        tms_class = subclasses[0]

    return tms_class
