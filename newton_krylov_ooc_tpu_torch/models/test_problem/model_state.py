"""test_problem model state: comp_fcn integrates each tracer module one model
year with the port's Radau IIA(5) integrator (ops/radau.py; the reference's
scipy Radau at atol=rtol=1e-12, nk_ooc/test_problem/model_state.py:80-99).

The port of newton_krylov_ooc_tpu/models/test_problem/model_state.py.
F(X) = state after one year - X.  Integrations run through one Radau5 per
(module family, hist mode, dtype, device), whose CUDA graph is captured at
its first year and replayed after; module parameters (e.g. dye decay rates)
live in a tensor the tendency reads, so parameterized families share one
integrator.  float64 is the default (modelinfo's comp_fcn_dtype=float32
selects float32); both run on modelinfo's device, the card unless the caller
asks for the CPU (setup_solver's and nk_driver's --device).  Without a card,
"cuda" raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import copy
import logging
import subprocess
import time

import numpy as np
import torch

from ...core.spatial_axis import spatial_axis_from_file
from ...core.state import ModelState as ModelStateBase
from ...ops.compute import resolve_device
from ...ops.radau import Radau5
from ...utils.helpers import class_name, strtobool
from ...utils.ncio import NCFile
from . import constants, physics

HIST_TIME_SAMPLES = 101


class ModelState(ModelStateBase):
    """test_problem model state"""

    __array_priority__ = 100

    time_range = (0.0, constants.sec_per_year)
    depth = None
    _integrate_cache = {}

    def __init__(self, fname):
        if ModelState.model_config_obj is None:
            raise RuntimeError("ModelState.model_config_obj is None")
        # the depth axis is shared across all instances (incl. deep copies)
        if ModelState.depth is None:
            self._set_class_vars(self.model_config_obj.modelinfo)
        super().__init__(fname)

    @staticmethod
    def _set_class_vars(modelinfo):
        ModelState.depth = spatial_axis_from_file(
            fname=modelinfo["grid_vars_fname"],
            axisname=modelinfo["depth_axisname"],
        )

    def _create_tracer_module(self, tms_class, tracer_module_name, fname):
        return tms_class(
            tracer_module_name, fname, self.model_config_obj, depth=self.depth
        )

    # -- integration machinery ----------------------------------------------

    def _dtype_and_device(self):
        modelinfo = self.model_config_obj.modelinfo
        dtype_name = modelinfo.get("comp_fcn_dtype") or "float64"
        dtypes = {"float64": torch.float64, "float32": torch.float32}
        if dtype_name not in dtypes:
            raise ValueError(f"unknown comp_fcn_dtype {dtype_name}")
        return dtypes[dtype_name], resolve_device(modelinfo.get("device") or "cuda")

    def _integrator(self, tracer_module, n_time):
        """(Radau5, params tensor) of a tracer module family's year"""
        dtype, device = self._dtype_and_device()
        static_args = tracer_module.tend_static_args()
        key = (type(tracer_module), len(self.depth), static_args, n_time, dtype,
               device, self.time_range)
        if key not in ModelState._integrate_cache:
            t0, t1 = self.time_range
            grid = physics.column_grid(self.depth, device=device, dtype=dtype)
            params = torch.zeros(len(tracer_module.tend_params()), dtype=dtype,
                                 device=device)
            fun = type(tracer_module).build_tend(grid, static_args, params)
            tol = 1.0e-12 if dtype == torch.float64 else 1.0e-6
            solver = Radau5(
                fun,
                tracer_module.tracer_cnt * len(self.depth),
                (t0, t1),
                np.linspace(t0, t1, n_time),
                dtype=dtype,
                device=device,
                rtol=tol,
                atol=tol,
            )
            ModelState._integrate_cache[key] = (solver, params)
        return ModelState._integrate_cache[key]

    def _run_module(self, tracer_module, n_time):
        """integrate one tracer module; returns (ntime, tracer_cnt*nlev) array"""
        logger = logging.getLogger(__name__)
        solver, params = self._integrator(tracer_module, n_time)
        y0 = tracer_module.get_tracer_vals_all().reshape(-1)
        start = time.perf_counter()
        params.copy_(torch.as_tensor(tracer_module.tend_params(), dtype=params.dtype))
        ys, info = solver.integrate(torch.as_tensor(y0, dtype=solver.dtype))
        ys = ys.cpu().numpy().astype(np.float64)
        seconds = time.perf_counter() - start
        if not info["success"]:
            raise RuntimeError(
                f"Radau integration failed for tracer module {tracer_module.name}"
            )
        logger.info(
            "radau year: module=%s device=%s attempts=%d nfev=%d nlu=%d "
            "seconds=%.6f", tracer_module.name, solver.device, info["n_attempts"],
            info["nfev"], info["nlu"], seconds,
        )
        return ys

    # -- comp_fcn -----------------------------------------------------------------

    def comp_fcn(self, res_fname, solver_state, hist_fname=None):
        """evaluate F(X): one-year integration, per tracer module"""
        logger = logging.getLogger(__name__)
        logger.debug('res_fname="%s", hist_fname="%s"', res_fname, hist_fname)

        if solver_state is not None:
            fcn_complete_step = f"comp_fcn complete for {res_fname}"
            if solver_state.step_logged(fcn_complete_step):
                logger.debug('"%s" logged, returning result', fcn_complete_step)
                return type(self)(res_fname)
            logger.debug('"%s" not logged, proceeding', fcn_complete_step)

        n_time = HIST_TIME_SAMPLES if hist_fname is not None else 2
        t_eval = np.linspace(self.time_range[0], self.time_range[1], n_time)

        res_ms = copy.copy(self)
        res_ms.tracer_modules = [copy.copy(tm) for tm in self.tracer_modules]

        fptr_hist = self._hist_open(hist_fname)
        self._hist_def_vars_tracer_module_independent(fptr_hist)

        for ind, tracer_module in enumerate(res_ms.tracer_modules):
            self._hist_def_vars(tracer_module, fptr_hist)
            y0 = tracer_module.get_tracer_vals_all().reshape(-1)
            ys = self._run_module(tracer_module, n_time)
            if ind == 0:
                self._hist_write_tracer_module_independent(t_eval, fptr_hist)
            if fptr_hist is not None:
                shape = (tracer_module.tracer_cnt, len(self.depth), n_time)
                tracer_module.write_hist_vars(fptr_hist, ys.T.reshape(shape))
                fptr_hist.sync()
            shape = (tracer_module.tracer_cnt, len(self.depth))
            tracer_module.set_tracer_vals_all(
                (ys[-1] - y0).reshape(shape), reseat_vals=True
            )

        if fptr_hist is not None:
            fptr_hist.close()

        caller = f"{class_name(self)}.comp_fcn"
        res_ms.comp_fcn_postprocess(res_fname, caller)

        if solver_state is not None:
            solver_state.log_step(fcn_complete_step)
            modelinfo = self.model_config_obj.modelinfo
            if strtobool(modelinfo["reinvoke"]):
                cmd = [modelinfo["invoker_script_fname"], "--resume"]
                logger.info('cmd="%s"', " ".join(cmd))
                # Popen, not run: the re-invoked solver outlives this process
                subprocess.Popen(cmd)
                raise SystemExit

        return res_ms

    # -- history file -----------------------------------------------------------

    def _hist_open(self, hist_fname):
        if hist_fname is None:
            return None
        fptr_hist = NCFile(hist_fname, mode="w")
        fptr_hist.stamp_history(f"{__name__}._gen_hist")
        dimensions = {"time": None}
        dimensions.update(self.depth.dump_dimensions())
        fptr_hist.create_dimensions_verify(dimensions)
        return fptr_hist

    def _hist_def_vars_tracer_module_independent(self, fptr_hist):
        if fptr_hist is None:
            return
        hist_vars_metadata = {
            "time": {
                "dimensions": ("time",),
                "attrs": {
                    "long_name": "time",
                    "units": "seconds since 0001-01-01",
                    "calendar": "noleap",
                },
            },
        }
        hist_vars_metadata.update(self.depth.dump_vars_metadata())
        hist_vars_metadata["bldepth"] = {
            "dimensions": ("time",),
            "attrs": {"long_name": "boundary layer depth", "units": "m"},
        }
        hist_vars_metadata["mixing_coeff"] = {
            "dimensions": ("time", self.depth.dump_names["edges"]),
            "attrs": {
                "long_name": "vertical mixing coefficient",
                "units": "m^2 / s",
            },
        }
        for varname, metadata in hist_vars_metadata.items():
            if varname != "time" and "time" in metadata["dimensions"]:
                metadata["attrs"]["cell_methods"] = "time: point"
        fptr_hist.create_vars(hist_vars_metadata)
        fptr_hist.sync()

    @staticmethod
    def _hist_def_vars(tracer_module, fptr_hist):
        if fptr_hist is None:
            return
        hist_vars_metadata = tracer_module.hist_vars_metadata()
        for metadata in hist_vars_metadata.values():
            if "time" in metadata["dimensions"]:
                metadata["attrs"]["cell_methods"] = "time: point"
        fptr_hist.create_vars(hist_vars_metadata)
        fptr_hist.sync()

    def _hist_write_tracer_module_independent(self, t_eval, fptr_hist):
        if fptr_hist is None:
            return
        fptr_hist.var("time")[:] = t_eval
        self.depth.dump_write(fptr_hist)

        nlev = len(self.depth)
        bld = np.empty(len(t_eval))
        mix = np.empty((len(t_eval), nlev + 1))
        for tind, time in enumerate(t_eval):
            bld[tind] = physics.bldepth_np(time)
            interior = (
                physics.mixing_coeff_np(self.depth, time) * self.depth.delta_mid
            )
            mix[tind, 1:-1] = interior
            # endpoints mirror the first/last interior edge (no missing values)
            mix[tind, 0] = interior[0]
            mix[tind, -1] = interior[-1]
        fptr_hist.var("bldepth")[:] = bld
        fptr_hist.var("mixing_coeff")[:] = mix
        fptr_hist.sync()

    # -- preconditioner ------------------------------------------------------------

    def apply_precond_jacobian(self, precond_fname, res_fname, solver_state):
        """apply per-module preconditioners built from time-mean hist fields"""
        logger = logging.getLogger(__name__)
        logger.debug('precond_fname="%s", res_fname="%s"', precond_fname, res_fname)

        if solver_state is not None:
            fcn_complete_step = f"apply_precond_jacobian complete for {res_fname}"
            if solver_state.step_logged(fcn_complete_step):
                logger.debug('"%s" logged, returning result', fcn_complete_step)
                return type(self)(res_fname)
            logger.debug('"%s" not logged, proceeding', fcn_complete_step)

        res_ms = copy.deepcopy(self)

        arg_to_hist_dict = {
            "mca": "mixing_coeff_log_mean",
            "po4_s_restore_tau_r": "po4_s_restore_tau_r_mean",
        }

        with NCFile(precond_fname) as fptr:
            for ind, tracer_module in enumerate(self.tracer_modules):
                kwargs = {}
                for arg in tracer_module.precond_hist_args:
                    hist_var = fptr.var(arg_to_hist_dict[arg])
                    vals = hist_var[:]
                    if f"{self.depth.axisname}_edges" in hist_var.dimensions:
                        vals = vals[1:-1]
                    kwargs[arg] = vals
                tracer_module.apply_precond_jacobian(
                    self.time_range, res_ms.tracer_modules[ind], **kwargs
                )

        # dump BEFORE logging completion: the step log is a write-ahead log,
        # so the result file must be durable when the step reads as done
        caller = f"{class_name(self)}.apply_precond_jacobian"
        res = res_ms.dump(res_fname, caller)
        if solver_state is not None:
            solver_state.log_step(fcn_complete_step)
        return res
