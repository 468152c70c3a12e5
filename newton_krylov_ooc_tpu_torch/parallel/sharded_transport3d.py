"""the in-core kernel of the 3D offline IRF-transport family, on one device.

Port of newton_krylov_ooc_tpu/parallel/sharded_transport3d.py::
ShardedTransport3dKernel with its reduction helpers
(_region_reduction_arrays_3d, _dot_pure_3d, _broadcast_pure_3d).  The JAX
kernel runs on a device mesh; this one takes `device=` where the JAX kernel
takes a 1-device mesh.  The latitude-sharded years, their halo exchanges
and the multi-device meshes are ROADMAP A5.3.

The TPU path splits a family that overflows one core's VMEM into
per-module kernels (transport3d_pallas.py's VmemBudgetError,
megakernel_fits_vmem).  Hopper's kernel keeps its state in device memory,
so the whole family batch runs in one year call and that split has no
counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.compute import resolve_device
from ..ops.tridiag import pcr_solve
from ..ops.transport3d import (
    assemble_rate_fields,
    build_transport3d,
    mask_vmix_coeff,
    mean_transport_coef,
    transport_tridiag_bands,
    vmix_vertical_coeff,
)
from ..ops.transport3d_cuda import (
    SEC_PER_YEAR,
    build_transport3d_year,
    build_transport3d_year_plain,
)
from ..utils.regions import region_mean_weights
from .sharded_year import _ShardedKernelInterface


def _region_reduction_arrays_3d(region_mask, grid_weight, *, device, dtype):
    """per-(module, region) reduction operators over a 3D grid:
    (region_cnt, mean_w, onehot, fill) with mean_w and onehot
    (region, nz, nlat, nlon) and fill (nz, nlat, nlon)"""
    region_mask = np.asarray(region_mask)
    region_cnt = int(region_mask.max())
    mean_w = region_mean_weights(region_mask, grid_weight).reshape(
        (region_cnt,) + region_mask.shape
    )
    onehot = np.stack(
        [(region_mask == r + 1).astype(np.float64) for r in range(region_cnt)]
    )
    fill = 1.0 - onehot.sum(axis=0)

    def tensor(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return region_cnt, tensor(mean_w), tensor(onehot), tensor(fill)


def _dot_pure_3d(a, b, rc):
    """per-(module, region) weighted dot products over the 3D volume
    weights; rc holds the reduction operators"""
    prod = torch.sum(a * b, dim=1)  # tracer axis
    return torch.einsum("mzab,rzab->mr", prod, rc["mean_w"])


def _broadcast_pure_3d(scalars, rc):
    """(module, region) scalars -> state-shaped per-region field"""
    field = torch.einsum("mr,rzab->mzab", scalars, rc["onehot"])
    return (field + rc["fill"])[:, None, :, :, :]


def family_year_inputs(circ, module_specs, adv_type="upwind3"):
    """the year's inputs for a family of modules riding circulation `circ`,
    in float64 on the CPU: (coef, kv, dz_r, diag, src, couple) as
    build_transport3d_year takes them, with the (module*tracer) axis flat;
    couple is block-diagonal over modules, or None"""
    mask = np.asarray(circ["mask"])
    nz, nlat, nlon = mask.shape
    dz = np.asarray(circ["dz"], np.float64)
    cpu64 = {"device": torch.device("cpu"), "dtype": torch.float64}
    coef = build_transport3d(
        mask, dz, circ["TAREA"], uet=circ.get("UET"), vnt=circ.get("VNT"),
        wtt=circ.get("WTT"), hdiff_e=circ.get("HDIFF_E"),
        hdiff_n=circ.get("HDIFF_N"), adv_type=adv_type, **cpu64,
    )
    if circ.get("VDC") is not None:
        kv, dz_r = vmix_vertical_coeff(circ["VDC"], dz, **cpu64)
        kv = mask_vmix_coeff(kv, mask)
    else:
        kv = torch.zeros((nz - 1, nlat * nlon), **cpu64)
        dz_r = torch.as_tensor(1.0 / (1.0e-2 * dz), **cpu64)

    t_dim = len(module_specs[0])
    if any(len(specs) != t_dim for specs in module_specs):
        raise ValueError("all modules must share the tracer count")
    n_flat = len(module_specs) * t_dim
    nh = nlat * nlon
    wet_h = (mask > 0).astype(np.float64).reshape(nz, nh)
    # cross-tracer d_SF_X_d_Y terms couple only tracers of the same
    # module, so the flat (module*tracer) coupling is block-diagonal
    diag = np.zeros((n_flat, nz, nh))
    src = np.zeros((n_flat, nz, nh))
    couple = np.zeros((n_flat, n_flat))
    any_couple = False
    for m_ind, specs in enumerate(module_specs):
        blk = slice(m_ind * t_dim, (m_ind + 1) * t_dim)
        diag[blk], src[blk], couple_m = assemble_rate_fields(
            specs, wet_h, dz[0], SEC_PER_YEAR
        )
        if couple_m is not None:
            couple[blk, blk] = couple_m
            any_couple = True
    return coef, kv, dz_r, diag, src, (couple if any_couple else None)


class ShardedTransport3dKernel(_ShardedKernelInterface):
    """in-core solver kernel: a family of linear 3D IRF-transport tracer
    modules solved for their cyclostationary state on one device.

    The year is the IMEX integration of ops/transport3d_cuda.py: kernel B4
    for a float32 state on a CUDA device, the plain PyTorch year otherwise
    (the CPU, or float64 on either device).  JVPs are exact, since the
    family is linear: J v = year0(v) - v, with year0 a second year of the
    same kind with the sources zeroed, so they stay on the kernel too.
    Reductions are per-(module, region) volume-weighted means.  The
    preconditioner is the column-local vertical block of (delta_t M - I):
    the vertical-mixing tridiagonal, the module's local rates and the
    same-column part of the transport stencil (transport_tridiag_bands of
    the annual-mean circulation), assembled in float64 and solved by PCR
    along depth.

    state layout: (module_batch, t_dim, nz, nlat, nlon) on `device`.

    circ: the circulation dict (models/irf_offline/synthetic.py::
    gen_circulation's keys: mask, dz, TAREA, UET, VNT, WTT, HDIFF_E,
    HDIFF_N, VDC), steady or seasonal.
    module_specs: per-module lists of per-tracer rate specs with the
    irf_offline keys (source_per_year, sink_rate_per_year,
    surf_restore_pv_cm_s, surf_restore_target, surf_flux_const_cm_s,
    surf_flux_d); all modules must share the tracer count.
    device: a device, or a sequence of devices; more than one device is
    the sharded kernel of ROADMAP A5.3 and raises NotImplementedError.
    """

    def __init__(self, circ, module_specs, n_steps, *, device,
                 dtype=torch.float32, region_mask=None, adv_type="upwind3",
                 t_span=(0.0, SEC_PER_YEAR)):
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    f"{len(device)} devices: the latitude-sharded 3D year is "
                    "ROADMAP item A5.3, not ported yet; pass one device"
                )
            device = device[0]
        self.device = resolve_device(device)
        self.dtype = dtype
        self.n_steps = n_steps
        # a float32 state on a CUDA device runs kernel B4 for F and JVPs
        self.use_kernel = self.device.type == "cuda" and dtype == torch.float32

        mask = np.asarray(circ["mask"])
        nz, nlat, nlon = mask.shape
        self.grid_shape = (nz, nlat, nlon)
        wet = (mask > 0).astype(np.float64)
        dz = np.asarray(circ["dz"], np.float64)
        self.module_batch = len(module_specs)
        self.t_dim = t_dim = len(module_specs[0])
        n_flat = self.module_batch * t_dim
        nh = nlat * nlon
        coef64, kv64, dz_r64, diag, src, couple = family_year_inputs(
            circ, module_specs, adv_type
        )

        # one copy of the coefficients on the device serves both years
        coef = {key: None if arr is None else arr.to(self.device, dtype)
                for key, arr in coef64.items()}
        if self.use_kernel:
            build = functools.partial(build_transport3d_year,
                                      device=self.device)
        else:
            build = build_transport3d_year_plain
        self._year = build(coef, kv64, dz_r64, diag, src, t_span, n_steps,
                           couple)
        self._year0 = build(coef, kv64, dz_r64, diag, np.zeros_like(src),
                            t_span, n_steps, couple)
        flat_shape = (n_flat, nz, nlat, nlon)
        self._comp_fcn = lambda x: (
            self._year(x.reshape(flat_shape)).reshape(x.shape) - x
        )
        self._jvp = lambda v: (
            self._year0(v.reshape(flat_shape)).reshape(v.shape) - v
        )

        if region_mask is None:
            region_mask = mask
        grid_weight = dz[:, None, None] * np.asarray(circ["TAREA"])[None] * wet
        self._wet = torch.as_tensor(wet, dtype=dtype, device=self.device)
        (self.region_cnt, mean_w, onehot, fill) = _region_reduction_arrays_3d(
            region_mask, grid_weight, device=self.device, dtype=dtype
        )
        self._reduce_consts = {"mean_w": mean_w, "onehot": onehot,
                               "fill": fill}
        self._dot = lambda a, b: _dot_pure_3d(a, b, self._reduce_consts)
        self._region_broadcast = lambda scalars: _broadcast_pure_3d(
            torch.as_tensor(np.asarray(scalars), dtype=dtype,
                            device=self.device),
            self._reduce_consts,
        )

        # column-local preconditioner: the vertical-line block of the
        # (delta_t * M - I) matrix -- vmix tridiagonal + the module's local
        # linear rates + the same-column tridiagonal part of the transport
        # stencil -- assembled in float64 and solved exactly by PCR along
        # depth.  The bands do not depend on the state: built once here.
        delta_t = t_span[1] - t_span[0]
        # a seasonal circulation contributes its annual mean
        kv_np = kv64.numpy()
        if kv_np.ndim == 3:
            kv_np = kv_np.mean(axis=0)
        dz_r_np = dz_r64.numpy()
        up = kv_np * dz_r_np[:-1, None]          # coupling to k+1, (nz-1, nh)
        lo = kv_np * dz_r_np[1:, None]           # coupling to k-1
        pad = np.zeros((1, nh))
        lo_t, diag_t, up_t = (
            b.numpy().reshape(nz, nh)
            for b in transport_tridiag_bands(mean_transport_coef(coef64))
        )
        du_b = delta_t * (np.concatenate([up, pad], axis=0) + up_t)
        dl_b = delta_t * (np.concatenate([pad, lo], axis=0) + lo_t)
        dmain = (
            delta_t
            * (
                -(np.concatenate([up, pad], axis=0)
                  + np.concatenate([pad, lo], axis=0))
                + diag_t
                + diag
            )
            - 1.0
        )                                         # (n_flat, nz, nh)

        def to_cols(arr, lead):
            # (..., nz, nh) -> (..., nlat, nlon, nz) for the PCR solve
            return torch.as_tensor(
                np.moveaxis(arr.reshape(lead + (nz, nlat, nlon)), -3, -1),
                dtype=dtype, device=self.device,
            )

        bands = (to_cols(dl_b, ()),
                 to_cols(dmain, (self.module_batch, t_dim)),
                 to_cols(du_b, ()))
        self._precond_factor = lambda x: bands
        self._precond_apply = _precond_apply

    # -- solver interface ------------------------------------------------------

    def init_iterate(self, fill_value=0.5):
        return (fill_value * self._wet).expand(
            (self.module_batch, self.t_dim) + self.grid_shape
        ).contiguous()

    def jvp(self, x, fcn, v):
        """exact: the family is linear, so J v = year0(v) - v"""
        return self._jvp(v)


def _precond_apply(data, r):
    """solve the column-tridiagonal preconditioner along depth"""
    dl_bands, d_bands, du_bands = data
    r_cols = torch.movedim(r, -3, -1)      # (M, T, nlat, nlon, nz)
    sol = pcr_solve(
        dl_bands.expand(r_cols.shape),
        d_bands.expand(r_cols.shape),
        du_bands.expand(r_cols.shape),
        r_cols,
    )
    return torch.movedim(sol, -1, -3)
