"""irf_offline model state: 3D offline tracer transport, one model year per
function evaluation.

The port of newton_krylov_ooc_tpu/models/irf_offline/model_state.py.  The
POP-convention circulation fields (the IRF mean file) drive an IMEX year
(ops/transport3d.py's stencils for advection and lateral diffusion,
Crank-Nicolson vertical mixing, Heun for the rest, ops/imex.py's
splitting): the per-step year of parallel/sharded_transport3d.py on one
shard, whose interior steps replay a CUDA graph of one step on a card.  The
JAX package's year is plain XLA with no Pallas call, so plain PyTorch is its
counterpart.  F runs in float64 (modelinfo's comp_fcn_dtype=float32 selects
float32) on modelinfo's device: the card unless the caller asks for the CPU
(setup_solver's and nk_driver's --device); without a card "cuda" raises.
Each year logs an `irf_offline year:` line with its steps and seconds.

The preconditioner applies the linearised rate operator matrix-free:
BiCGSTAB (ops/sparse.py) on delta_t * M - I, preconditioned by the exact
inverse of its vertical-line block (a PCR solve a column), per tracer or,
for a module with cross-tracer gas exchange, jointly.
"""

from __future__ import annotations

import copy
import logging
import subprocess
import time

import numpy as np
import torch

from ...core.state import ModelState as ModelStateBase
from ...ops.compute import resolve_device
from ...ops.sparse import bicgstab
from ...ops.tridiag import pcr_solve
from ...ops.transport3d import (
    assemble_rate_fields,
    build_transport3d,
    mask_vmix_coeff,
    mean_transport_coef,
    transport_tend,
    transport_tridiag_bands,
    vmix_vertical_coeff,
)
from ...parallel.mesh import make_mesh
from ...parallel.sharded_transport3d import build_sharded_transport3d_year
from ...utils.helpers import class_name, strtobool
from ...utils.ncio import NCFile
from .tracer_module_state import SEC_PER_YEAR

HIST_TIME_SAMPLES = 13  # monthly-ish snapshots plus the year ends
CPU64 = {"device": torch.device("cpu"), "dtype": torch.float64}


class ModelState(ModelStateBase):
    """offline IRF-transport model state"""

    __array_priority__ = 100

    time_range = (0.0, SEC_PER_YEAR)
    _circ = None
    _circ_key = None
    # each module's segment years, kept with their captured step graphs
    _years = {}

    def __init__(self, fname):
        if ModelState.model_config_obj is None:
            raise RuntimeError("ModelState.model_config_obj is None")
        if ModelState._circ_key != id(self.model_config_obj):
            self._set_class_vars(self.model_config_obj.modelinfo)
            ModelState._circ_key = id(self.model_config_obj)
        super().__init__(fname)

    @staticmethod
    def reset_class_state():
        """forget the config and circulation kept on the class, as before a
        workdir was configured"""
        ModelState.model_config_obj = None
        ModelState._circ = ModelState._circ_key = None
        ModelState._years = {}

    # -- circulation ----------------------------------------------------------

    @staticmethod
    def _set_class_vars(modelinfo):
        """load the circulation (IRF mean) file and build its operators
        (float64 on the CPU; each year moves them to its device)"""
        logger = logging.getLogger(__name__)
        irf_fname = modelinfo["irf_fname"]
        logger.debug('irf_fname="%s"', irf_fname)

        with NCFile(modelinfo["grid_vars_fname"]) as fptr:
            mask = np.asarray(fptr.var("region_mask")[:])

        fields = {}
        with NCFile(irf_fname) as fptr:
            for name in ["dz", "TAREA", "UET", "VNT", "WTT", "HDIFF_E",
                         "HDIFF_N", "VDC"]:
                fields[name] = (
                    np.asarray(fptr.var(name)[:]) if fptr.has_var(name) else None
                )
        if fields["dz"] is None or fields["TAREA"] is None:
            raise ValueError(f"{irf_fname} lacks dz/TAREA")

        adv_type = modelinfo.get("circ_adv_type") or "upwind3"
        coef = build_transport3d(
            mask,
            fields["dz"],
            fields["TAREA"],
            uet=fields["UET"],
            vnt=fields["VNT"],
            wtt=fields["WTT"],
            hdiff_e=fields["HDIFF_E"],
            hdiff_n=fields["HDIFF_N"],
            adv_type=adv_type,
            **CPU64,
        )
        nz, nlat, nlon = mask.shape
        if fields["VDC"] is not None:
            kv, dz_r = vmix_vertical_coeff(fields["VDC"], fields["dz"], **CPU64)
            kv = mask_vmix_coeff(kv, mask)
        else:
            kv = torch.zeros((nz - 1, nlat * nlon), **CPU64)
            dz_r = torch.as_tensor(1.0 / (1.0e-2 * fields["dz"]), **CPU64)

        wet = (mask > 0).astype(np.float64)
        depth_edges = np.concatenate([[0.0], np.cumsum(fields["dz"])])
        ModelState._years = {}
        ModelState._circ = {
            "shape": (nz, nlat, nlon),
            "mask": mask,
            "wet": wet,
            "dz": fields["dz"],
            "depth_mid_cm": 0.5 * (depth_edges[:-1] + depth_edges[1:]),
            "tarea": fields["TAREA"],
            "horiz_weights": fields["TAREA"] * wet[0],
            "coef": coef,
            "kv": kv,
            "dz_r": dz_r,
            "steps_per_year": int(modelinfo["steps_per_year"]),
        }

    def _create_tracer_module(self, tms_class, tracer_module_name, fname):
        circ = ModelState._circ
        return tms_class(
            tracer_module_name,
            fname,
            self.model_config_obj,
            grid_shape=circ["shape"],
            depth_mid_cm=circ["depth_mid_cm"],
        )

    def _dtype_and_device(self):
        modelinfo = self.model_config_obj.modelinfo
        dtype_name = modelinfo.get("comp_fcn_dtype") or "float64"
        dtypes = {"float64": torch.float64, "float32": torch.float32}
        if dtype_name not in dtypes:
            raise ValueError(f"unknown comp_fcn_dtype {dtype_name}")
        return dtypes[dtype_name], resolve_device(modelinfo.get("device") or "cuda")

    # -- rate fields from the module spec -------------------------------------

    def _module_rates(self, tracer_module):
        """(diag, src, couple): per-tracer implicit linear rates [1/s],
        explicit sources [tracer/s] (each (tracer_cnt, nz, nlat*nlon)), and
        the cross-tracer surface-flux coupling matrix (tracer_cnt,
        tracer_cnt) [1/s at the surface layer] or None when the module has
        no off-diagonal gas-exchange terms (the reference's d_SF_X_d_Y
        mechanism); numpy float64"""
        circ = ModelState._circ
        nz, nlat, nlon = circ["shape"]
        wet = circ["wet"].reshape(nz, nlat * nlon)
        return assemble_rate_fields(
            tracer_module.rate_specs(), wet, circ["dz"][0], SEC_PER_YEAR
        )

    # -- year integration ------------------------------------------------------

    def _integrate_module(self, tracer_module, n_time):
        """(n_time, tracer_cnt, nz, nh) float64 snapshots over the year, in
        n_time - 1 segments of ceil(steps_per_year / (n_time - 1)) steps"""
        logger = logging.getLogger(__name__)
        circ = ModelState._circ
        dtype, device = self._dtype_and_device()
        nz, nlat, nlon = circ["shape"]
        y = tracer_module.get_tracer_vals_all().reshape(-1, nz, nlat * nlon)

        t0, t1 = self.time_range
        n_seg = n_time - 1
        seg_steps = max(1, int(np.ceil(circ["steps_per_year"] / n_seg)))
        snaps = [y.copy()]
        start = time.perf_counter()
        y_dev = torch.as_tensor(y, dtype=dtype, device=device).reshape(
            -1, nz, nlat, nlon)
        for seg in range(n_seg):
            seg_span = (t0 + (t1 - t0) * seg / n_seg,
                        t0 + (t1 - t0) * (seg + 1) / n_seg)
            y_dev = self._segment_year(tracer_module, seg_span, seg_steps,
                                       device)(y_dev)
            snaps.append(y_dev.reshape(y.shape).cpu().numpy().astype(np.float64))
        seconds = time.perf_counter() - start
        logger.info("irf_offline year: module=%s device=%s steps=%d "
                    "seconds=%.6f", tracer_module.name, device,
                    seg_steps * n_seg, seconds)
        if not np.isfinite(snaps[-1]).all():
            raise RuntimeError(
                f"year integration diverged for tracer module "
                f"{tracer_module.name}; raise steps_per_year"
            )
        return np.stack(snaps)

    def _segment_year(self, tracer_module, seg_span, seg_steps, device):
        """the year of one hist segment of a tracer module, built once (its
        step graph captured at its first call on a card and kept)"""
        key = (tracer_module.name, seg_span, seg_steps, device)
        if key not in ModelState._years:
            diag, src, couple = self._module_rates(tracer_module)
            circ = ModelState._circ
            ModelState._years[key] = build_sharded_transport3d_year(
                make_mesh(1, 1, devices=[device]), circ["coef"], circ["kv"],
                circ["dz_r"], diag, src, seg_span, seg_steps, couple)
        return ModelState._years[key]

    # -- comp_fcn --------------------------------------------------------------

    def comp_fcn(self, res_fname, solver_state, hist_fname=None):
        logger = logging.getLogger(__name__)
        logger.debug('res_fname="%s", hist_fname="%s"', res_fname, hist_fname)

        if solver_state is not None:
            fcn_complete_step = f"comp_fcn complete for {res_fname}"
            if solver_state.step_logged(fcn_complete_step):
                logger.debug('"%s" logged, returning result', fcn_complete_step)
                return type(self)(res_fname)
            logger.debug('"%s" not logged, proceeding', fcn_complete_step)

        circ = ModelState._circ
        nz, nlat, nlon = circ["shape"]
        n_time = HIST_TIME_SAMPLES if hist_fname is not None else 2
        t_eval = np.linspace(self.time_range[0], self.time_range[1], n_time)

        res_ms = copy.copy(self)
        res_ms.tracer_modules = [copy.copy(tm) for tm in self.tracer_modules]

        fptr_hist = self._hist_open(hist_fname)
        for ind, tracer_module in enumerate(res_ms.tracer_modules):
            if fptr_hist is not None:
                metadata = tracer_module.hist_vars_metadata()
                for md in metadata.values():
                    if "time" in md["dimensions"]:
                        md["attrs"]["cell_methods"] = "time: point"
                fptr_hist.create_vars(metadata)
            y0 = tracer_module.get_tracer_vals_all().reshape(-1, nz, nlat * nlon)
            snaps = self._integrate_module(tracer_module, n_time)
            if ind == 0 and fptr_hist is not None:
                fptr_hist.var("time")[:] = t_eval
                fptr_hist.var("dz")[:] = circ["dz"]
                fptr_hist.sync()
            if fptr_hist is not None:
                tracer_module.write_hist_vars(
                    fptr_hist,
                    np.moveaxis(snaps, 0, 1).reshape(
                        (-1, n_time, nz, nlat, nlon)
                    ),
                    circ["horiz_weights"],
                )
                fptr_hist.sync()
            tracer_module.set_tracer_vals_all(
                (snaps[-1] - y0).reshape((-1, nz, nlat, nlon)),
                reseat_vals=True,
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

    def _hist_open(self, hist_fname):
        if hist_fname is None:
            return None
        circ = ModelState._circ
        nz, nlat, nlon = circ["shape"]
        fptr_hist = NCFile(hist_fname, mode="w")
        fptr_hist.stamp_history(f"{__name__}._gen_hist")
        fptr_hist.create_dimensions_verify(
            {"time": None, "z_t": nz, "nlat": nlat, "nlon": nlon}
        )
        fptr_hist.create_vars(
            {
                "time": {
                    "dimensions": ("time",),
                    "attrs": {
                        "long_name": "time",
                        "units": "seconds since 0001-01-01",
                        "calendar": "noleap",
                    },
                },
                "dz": {
                    "dimensions": ("z_t",),
                    "attrs": {"long_name": "layer thickness", "units": "cm"},
                },
            }
        )
        return fptr_hist

    # -- preconditioner --------------------------------------------------------

    def _rate_operator_parts(self, tracer_module, dtype, device):
        """operands of a module's linearised year-rate operator, on device
        in dtype: (coef, kv, dz_r, diag, couple or None, wet_surf); a
        seasonal circulation contributes its ANNUAL MEAN (the reference's
        ncra-averaged operator) -- the preconditioner is an approximate
        inverse, so the time variation need not be carried there"""
        circ = ModelState._circ
        diag, _src, couple = self._module_rates(tracer_module)
        kv = circ["kv"]
        if kv.ndim == 3:
            kv = kv.mean(dim=0)

        def put(arr):
            return torch.as_tensor(arr).to(device=device, dtype=dtype)

        coef = {key: None if arr is None else put(arr)
                for key, arr in mean_transport_coef(circ["coef"]).items()}
        return (
            coef,
            put(kv),
            put(circ["dz_r"]),
            put(diag),
            None if couple is None else put(couple),
            put(circ["wet"][0].reshape(-1)),
        )

    def apply_precond_jacobian(self, precond_fname, res_fname, solver_state):
        """matrix-free solve of (delta_t * M - I) z = r per tracer module,
        M the linearised rate operator; the result is the correction z - r
        (the same contract as the cime_pop adapter's external solve)"""
        logger = logging.getLogger(__name__)
        logger.debug('precond_fname="%s", res_fname="%s"', precond_fname, res_fname)

        if solver_state is not None:
            fcn_complete_step = f"apply_precond_jacobian complete for {res_fname}"
            if solver_state.step_logged(fcn_complete_step):
                logger.debug('"%s" logged, returning result', fcn_complete_step)
                return type(self)(res_fname)
            logger.debug('"%s" not logged, proceeding', fcn_complete_step)

        circ = ModelState._circ
        nz, nlat, nlon = circ["shape"]
        dtype, device = self._dtype_and_device()

        res_ms = copy.copy(self)
        res_ms.tracer_modules = [copy.copy(tm) for tm in self.tracer_modules]
        for tracer_module in res_ms.tracer_modules:
            operands = self._rate_operator_parts(tracer_module, dtype, device)
            rhs = tracer_module.get_tracer_vals_all().reshape(
                -1, nz, nlat * nlon
            )
            sol, ok, iters = _precond_solve(
                torch.as_tensor(rhs, dtype=dtype, device=device), *operands,
                shape=(nz, nlat, nlon)
            )
            logger.info("irf_offline precond: module=%s bicgstab_iterations=%s",
                        tracer_module.name, iters)
            if not ok:
                raise RuntimeError(
                    f"preconditioner BiCGSTAB failed to converge for "
                    f"tracer module {tracer_module.name}"
                )
            tracer_module.set_tracer_vals_all(
                sol.cpu().numpy().astype(np.float64).reshape(
                    (-1, nz, nlat, nlon)),
                reseat_vals=True,
            )

        res_ms -= self

        # dump BEFORE logging completion: the step log is a write-ahead log,
        # so the result file must be durable when the step reads as done
        res = res_ms.dump(res_fname, f"{class_name(self)}.apply_precond_jacobian")
        if solver_state is not None:
            solver_state.log_step(fcn_complete_step)
        return res


def _precond_solve(rhs, coef, kv, dz_r, diag, couple, wet_surf, shape):
    """solve (delta_t * M - I) z = r for each tracer of rhs (tracer_cnt,
    nz, nh); returns (z, converged, [BiCGSTAB iterations of each solve])

    BiCGSTAB preconditioned by the EXACT inverse of the vertical-line block
    of delta_t * M - I: per-column vmix + local-rate tridiagonal PLUS the
    same-column tridiagonal part of the transport stencil
    (ops/transport3d.py::transport_tridiag_bands) -- a PCR solve, so both
    the stiff direction and the O(delta_t * rate) diagonal mass of the
    lateral transport leave the Krylov iteration, which damps only the
    strictly lateral couplings.

    couple (tracer_cnt, tracer_cnt) surface gas-exchange coupling, or None:
    when present the tracers form ONE linear system (solved jointly, with
    the same per-tracer vertical-block preconditioner) instead of
    independent ones.
    """
    nz, nlat, nlon = shape
    nh = nlat * nlon
    delta_t = SEC_PER_YEAR

    # vertical-line bands of delta_t * (V + tridiag(T)) - I, (nz, nh)
    up = kv * dz_r[:-1, None]
    lo = kv * dz_r[1:, None]
    pad = kv.new_zeros((1, nh))
    lo_t, diag_t, up_t = (
        b.reshape(nz, nh) for b in transport_tridiag_bands(coef)
    )
    du = delta_t * (torch.cat([up, pad], dim=0) + up_t)
    dl = delta_t * (torch.cat([pad, lo], dim=0) + lo_t)
    dmain = delta_t * (-(torch.cat([up, pad], dim=0)
                         + torch.cat([pad, lo], dim=0))
                       + diag_t + diag) - 1.0

    def vert_solve(v3, dm):
        """the vertical-block inverse of (..., nz, nh) right-hand sides"""
        return pcr_solve(dl.T.expand(dm.shape[:-2] + (nh, nz)),
                         dm.transpose(-1, -2),
                         du.T.expand(dm.shape[:-2] + (nh, nz)),
                         v3.transpose(-1, -2)).transpose(-1, -2)

    if couple is None:
        sols, oks, iters = [], [], []
        for r, d, dm in zip(rhs, diag, dmain):
            def matvec(v, d=d):
                v2 = v.reshape(nz, nh)
                out = delta_t * _rate_single(v2, coef, kv, dz_r, d, shape) - v2
                return out.reshape(-1)

            x, ok, k = bicgstab(
                matvec, r.reshape(-1),
                precond=lambda v, dm=dm: vert_solve(v.reshape(nz, nh),
                                                    dm).reshape(-1),
                rtol=1.0e-10, max_iter=50 * nh,
            )
            sols.append(x.reshape(nz, nh))
            oks.append(bool(ok))
            iters.append(k)
        return torch.stack(sols), all(oks), iters

    # coupled: one system over all tracers of the module
    def matvec_joint(v):
        v3 = v.reshape(rhs.shape)
        out = torch.stack([_rate_single(vv, coef, kv, dz_r, d, shape)
                           for vv, d in zip(v3, diag)])
        out[:, 0, :] += wet_surf * (couple @ v3[:, 0, :])
        return (delta_t * out - v3).reshape(-1)

    x, ok, k = bicgstab(
        matvec_joint, rhs.reshape(-1),
        precond=lambda v: vert_solve(v.reshape(rhs.shape), dmain).reshape(-1),
        rtol=1.0e-10, max_iter=50 * nh * rhs.shape[0],
    )
    return x.reshape(rhs.shape), bool(ok), [k]


def _rate_single(v2, coef, kv, dz_r, diag2, shape):
    """linearised rate operator M v for one tracer; v2, diag2 (nz, nh)"""
    nz, nlat, nlon = shape
    tend = transport_tend(coef, v2.reshape(nz, nlat, nlon)).reshape(nz, -1)
    flux = kv * (v2[1:, :] - v2[:-1, :])
    pad = v2.new_zeros((1, v2.shape[-1]))
    vmix = dz_r[:, None] * (
        torch.cat([flux, pad], dim=0) - torch.cat([pad, flux], dim=0)
    )
    return tend + vmix + diag2 * v2
