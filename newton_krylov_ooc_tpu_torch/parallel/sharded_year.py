"""the sharded py_driver_2d year and the module-family solver kernels.

Port of newton_krylov_ooc_tpu/parallel/sharded_year.py.  The year runs
with the ypos dimension split over a mesh's 'space' axis and a batch of
parameterized modules split over 'module' (parallel/mesh.py), the same
decomposition as the JAX package's shard_map:

  * the implicit vertical solves are column-local and run inside a shard;
  * the lateral stencils need one ypos halo column a side per explicit
    stage, sliced from the neighbour's block and moved with .to(device)
    when the devices differ -- zeros at the physical edges, where the face
    arrays are zero too, so the boundary shards need no special case;
  * the blocked year (build_sharded_year_blocked, the JAX package's
    build_sharded_year_pallas) runs k interior steps at a time on each
    shard's window extended by 2k halo columns a side; on a card, kernel B3
    (ops/imex_block_cuda.py) runs every shard of the card and the whole
    interior in one launch, its halos moving through device memory.

State layout: the solver's state is one (module_batch, T, nz, ny) tensor on
the mesh's first device.  Between years the reductions and the
preconditioner act on that whole tensor; only the year runs in blocks on
the mesh, its blocks staying on their devices for the whole year with only
halos moving between them.  Keeping the state sharded across the solve, on
more than one card and more than one process, is ROADMAP A5.1; the numbers
are the same either way.

_ShardedKernelInterface holds the solver hooks every family kernel shares,
the 3D kernel of parallel/sharded_transport3d.py included.  Not ported
here: ShardedPhosphorusKernel and the per-step year's column-local
`local_tend` hook that it alone uses (ROADMAP A5.2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.py_driver_2d import physics
from ..models.py_driver_2d.iage import SURF_SLOW_FACTOR, surf_restore_rate
from ..models.py_driver_2d.incore import _warn_if_explicit_unstable
from ..ops.banded import banded_lu_factor_blocks, banded_lu_solve_blocks
from ..ops.imex import _kahan_add, cn_vertical_increment
from ..ops.imex_block_cuda import (
    SlabRun,
    _consts_on,
    pack_block_consts,
    plain_block,
)
from ..ops.tridiag import pcr_solve
from ..utils.regions import comp_scalef_lob, region_mean_weights
from .mesh import gather_state, shard_state

CPU = torch.device("cpu")


class ShardedYearData:
    """per-shard static arrays for the decomposed year (numpy, stacked on a
    leading 'space' axis) and the grid they come from (CPU tensors)"""

    def __init__(self, depth, ypos, modelinfo, n_space, dtype=torch.float64):
        nz, ny = len(depth), len(ypos)
        if ny % n_space != 0:
            raise ValueError(
                f"ypos size {ny} does not split over {n_space} shards"
            )
        ny_loc = ny // n_space
        self.nz, self.ny, self.n_space, self.ny_loc = nz, ny, n_space, ny_loc
        self.dtype = dtype

        grid = physics.make_grid(depth, ypos, modelinfo, device=CPU,
                                 dtype=dtype)
        self.grid = grid

        vvel = grid.vvel.numpy()             # (nz, ny+1) at ypos faces
        hmc = grid.horiz_mix_coeff.numpy()   # (nz, ny-1) interior faces
        # effective face arrays with zero flux at the physical boundaries
        vfaces_g = vvel.copy()
        vfaces_g[:, 0] = 0.0
        vfaces_g[:, -1] = 0.0
        hfaces_g = np.zeros((nz, ny + 1), vvel.dtype)
        hfaces_g[:, 1:-1] = hmc

        # shard s covers global columns [s*ny_loc, (s+1)*ny_loc) and the
        # ny_loc+1 faces bounding them
        self.vfaces = np.stack(
            [vfaces_g[:, s * ny_loc:s * ny_loc + ny_loc + 1]
             for s in range(n_space)]
        )
        self.hfaces = np.stack(
            [hfaces_g[:, s * ny_loc:s * ny_loc + ny_loc + 1]
             for s in range(n_space)]
        )
        wvel = grid.wvel.numpy()
        self.dy_r = grid.dy_r.numpy().reshape(n_space, ny_loc)
        self.wvel = np.stack(
            [wvel[:, s * ny_loc:(s + 1) * ny_loc] for s in range(n_space)]
        )
        self.ypos_mid = grid.ypos_mid.numpy().reshape(n_space, ny_loc)

        # depth-axis arrays, the same on every shard
        self.depth_mid = grid.depth_mid.numpy()
        self.dz_r = grid.dz_r.numpy()
        self.dz_mid = grid.dz_mid.numpy()
        self.dz_mid_r = grid.dz_mid_r.numpy()


# neighbour slices the host moved for the blocked and per-step years' halos
# in this process (each `width` columns of one shard's neighbour, and each
# ghost slab the blocked year's kernel route fills); callers reset it to 0
# to count a run's
halo_copies = 0


def _halo_cat(blocks, mi, sj, width):
    """blocks[mi][sj] with `width` columns of each ypos neighbour on either
    side (moved to its device), zeros past the mesh's edges"""
    global halo_copies
    v = blocks[mi][sj]
    row = blocks[mi]
    edge = v.shape[:-1] + (width,)
    left = (row[sj - 1][..., -width:].to(v.device) if sj > 0
            else v.new_zeros(edge))
    right = (row[sj + 1][..., :width].to(v.device) if sj < len(row) - 1
             else v.new_zeros(edge))
    halo_copies += (sj > 0) + (sj < len(row) - 1)
    return torch.cat([left, v, right], dim=-1)


def _by_shard(mesh, fn):
    """[[fn(mi, sj, device) for each space block] for each module block]"""
    return [[fn(mi, sj, mesh.devices[mi][sj])
             for sj in range(mesh.shape["space"])]
            for mi in range(mesh.shape["module"])]


def _unzip(pairs):
    """a mesh-shaped list of pairs -> the mesh-shaped lists of each half"""
    return ([[p[0] for p in row] for row in pairs],
            [[p[1] for p in row] for row in pairs])


def build_sharded_year(mesh, data: ShardedYearData, diag, aging, t_span,
                       n_steps):
    """the per-step sharded year: ops/imex.py::imex_year on every shard,
    with one halo column a side from its ypos neighbours at every explicit
    stage, in data.dtype (float64 included).

    mesh: parallel/mesh.py Mesh (n_module may be 1)
    data: ShardedYearData for the grid, split over the mesh's space axis
    diag: (module_batch, tracer, nz, ny) stiff local linear rates, folded
        into the implicit solve
    aging: (module_batch, tracer, nz or 1, 1) explicit sources (per-module
        aging rates, or depth profiles); zeros for the tangent year
    Returns year(y) for y (module_batch, tracer, nz, ny) on any device; the
    result lies on the mesh's first device.
    """
    n_module, n_space = mesh.shape["module"], mesh.shape["space"]
    if n_space != data.n_space:
        raise ValueError(f"data splits ypos over {data.n_space} shards, the "
                         f"mesh over {n_space}")
    dtype = data.dtype
    diag = np.asarray(diag)
    aging = np.asarray(aging)
    b_dim = diag.shape[0]
    if b_dim % n_module:
        raise ValueError(f"module batch {b_dim} does not split over "
                         f"{n_module} mesh blocks")
    b_loc, nyl = b_dim // n_module, data.ny_loc

    def setup(mi, sj, dev):
        def put(arr):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                                   device=dev)

        rows = slice(mi * b_loc, (mi + 1) * b_loc)
        zero_t = torch.zeros((), dtype=dtype, device=dev)
        return {
            "diag": put(diag[rows, ..., sj * nyl:(sj + 1) * nyl]),
            "aging": put(aging[rows]),
            "vfaces": put(data.vfaces[sj]),
            "hfaces": put(data.hfaces[sj]),
            "dy_r": put(data.dy_r[sj]),
            "wvel": put(data.wvel[sj]),
            "ypos_mid": put(data.ypos_mid[sj]),
            "dz_r": put(data.dz_r),
            "depth_mid": put(data.depth_mid),
            "dz_mid": put(data.dz_mid),
            "dz_mid_r": put(data.dz_mid_r),
            "t0": zero_t + t_span[0],
            "dt": zero_t + (t_span[1] - t_span[0]) / n_steps,
        }

    shards = _by_shard(mesh, setup)

    def explicit_tend(sh, y, v_ext):
        favg = 0.5 * (v_ext[..., 1:] + v_ext[..., :-1])
        wy = favg * sh["vfaces"]                      # (..., nz, nyl+1)
        res = sh["dy_r"] * (wy[..., :-1] - wy[..., 1:])
        dflux = sh["hfaces"] * (v_ext[..., 1:] - v_ext[..., :-1])
        res = res + sh["dy_r"] * (dflux[..., 1:] - dflux[..., :-1])
        # vertical advection: column-local centered flux
        wz_int = 0.5 * (y[..., 1:, :] + y[..., :-1, :]) * sh["wvel"][1:-1, :]
        zero = y.new_zeros(y.shape[:-2] + (1, y.shape[-1]))
        wz = torch.cat([zero, wz_int, zero], dim=-2)
        res = res + sh["dz_r"][:, None] * (wz[..., 1:, :] - wz[..., :-1, :])
        return res + sh["aging"]

    def tend_all(ys):
        return _by_shard(mesh, lambda mi, sj, dev: explicit_tend(
            shards[mi][sj], ys[mi][sj], _halo_cat(ys, mi, sj, 1)))

    def cn_incr(sh, t, y, h):
        kv = physics.vert_mixing_coeff_arrays(
            sh["depth_mid"], sh["dz_mid"], sh["dz_mid_r"], sh["ypos_mid"],
            sh["wvel"], t)
        return cn_vertical_increment(kv, sh["diag"], sh["dz_r"], y, h)

    def year(y0):
        ys = shard_state(mesh, y0.to(dtype))
        zero_c = _by_shard(mesh, lambda mi, sj, dev: torch.zeros_like(
            ys[mi][sj]))

        def each(fn):
            return _by_shard(mesh, lambda mi, sj, dev: fn(shards[mi][sj],
                                                          mi, sj))

        def heun(ys, cs):
            # Heun (explicit trapezoid) for the non-stiff terms
            f1 = tend_all(ys)
            stage = each(lambda sh, mi, sj: ys[mi][sj] + sh["dt"] * f1[mi][sj])
            f2 = tend_all(stage)
            return _unzip(each(lambda sh, mi, sj: _kahan_add(
                ys[mi][sj], cs[mi][sj],
                0.5 * sh["dt"] * (f1[mi][sj] + f2[mi][sj]))))

        def cn_all(ys, cs, t_of, h_of):
            return _unzip(each(lambda sh, mi, sj: _kahan_add(
                ys[mi][sj], cs[mi][sj],
                cn_incr(sh, t_of(sh), ys[mi][sj], h_of(sh)))))

        # Strang splitting with merged interior half-steps, as imex_year:
        #   CNh(t0) H(t0) CNf(t1) H(t1) ... CNf(t_{n-1}) H(t_{n-1}) CNh(t_n)
        ys, cs = cn_all(ys, zero_c, lambda sh: sh["t0"],
                        lambda sh: 0.5 * sh["dt"])
        for ind in range(n_steps - 1):
            ys, cs = heun(ys, cs)
            ys, cs = cn_all(ys, cs, lambda sh: sh["t0"] + ind * sh["dt"]
                            + sh["dt"], lambda sh: sh["dt"])
        ys, cs = heun(ys, cs)
        ys, _ = cn_all(ys, cs,
                       lambda sh: sh["t0"] + (n_steps - 1) * sh["dt"]
                       + sh["dt"], lambda sh: 0.5 * sh["dt"])
        return gather_state(mesh, ys)

    return year


def _vertical_product_precond(kernel, tracer_diag, t_dim):
    """(factor_fn, apply_fn) for the column-local implicit-Euler-product
    vertical preconditioner composed with the ADI lateral sweep.

    M_vert = I - prod_i (I - dt T(t_i)) with T the vertical tridiagonal
    (mixing + the module's local linear rates) -- the reference's
    implicit-Euler-product preconditioner restricted to the column-local
    part, so it is mesh-shape-independent.  The product of three
    tridiagonals is 7-banded per column; it is factored once per Newton
    iteration with the pivot-free banded LU (ops/banded.py), batched over
    (tracer, column) blocks.  apply_fn first runs the (I - dt L_y)^{-1}
    lateral sweep (ops/tridiag.py::pcr_solve along ypos; without it GMRES
    must resolve the weakly damped lateral modes itself)."""
    nz, ny = kernel.nz, kernel.ny
    dtype, device = kernel.dtype, kernel.device
    grid = kernel.grid
    tracer_diag = torch.as_tensor(np.asarray(tracer_diag), dtype=dtype,
                                  device=device)               # (T, nz, ny)

    def factor():
        dz_r = grid.dz_r
        time_n = 3
        dt = kernel.year / time_n
        eye = torch.eye(nz, dtype=dtype, device=device)
        prod = eye.expand(t_dim, ny, nz, nz)
        rows = torch.arange(nz, device=device)
        zero = torch.zeros((1, ny), dtype=dtype, device=device)
        for i in range(time_n):
            kv = physics.vert_mixing_coeff(grid, (i + 0.5) * dt)  # (nz-1, ny)
            du = torch.cat([kv * dz_r[:-1, None], zero], dim=0)  # (nz, ny)
            dl = torch.cat([zero, kv * dz_r[1:, None]], dim=0)
            dmain = -(du + dl) + tracer_diag                      # (T, nz, ny)
            t_mat = torch.zeros((t_dim, ny, nz, nz), dtype=dtype,
                                device=device)
            t_mat[:, :, rows, rows] = dmain.transpose(-1, -2)
            t_mat[:, :, rows[1:], rows[:-1]] = dl.T[None, :, 1:]
            t_mat[:, :, rows[:-1], rows[1:]] = du.T[None, :, :-1]
            prod = prod @ (eye - dt * t_mat)
        m_mat = eye - prod                                      # (T, ny, nz, nz)
        bw = min(time_n, nz - 1)
        bands = torch.zeros((t_dim, ny, nz, 2 * bw + 1), dtype=dtype,
                            device=device)
        for d in range(2 * bw + 1):
            off = d - bw
            band_rows = torch.arange(max(0, -off), min(nz, nz - off),
                                     device=device)
            bands[:, :, band_rows, d] = torch.diagonal(
                m_mat, offset=off, dim1=-2, dim2=-1)
        return banded_lu_factor_blocks(bands.reshape(t_dim * ny, nz, -1))

    def apply(lu, r):
        # lateral sweep along ypos (the last axis)
        r_lat = pcr_solve(
            kernel._lat_dl.expand(r.shape), kernel._lat_d.expand(r.shape),
            kernel._lat_du.expand(r.shape), r,
        )
        # vertical product solve per (tracer, column) block along depth
        rb = r_lat.transpose(-1, -2).reshape(r.shape[0], t_dim * ny, nz)
        sol = banded_lu_solve_blocks(lu, rb)
        sol = sol.reshape(r.shape[0], t_dim, ny, nz).transpose(-1, -2)
        return sol - r

    return factor, apply


def _region_reduction_arrays(region_mask, grid_weight, nz, ny, *, dtype,
                             device):
    """per-(module, region) reduction operators on the state's device:
    (region_cnt, mean_w (R, nz, ny), onehot (R, nz, ny), fill (nz, ny))"""
    region_cnt = int(np.asarray(region_mask).max())
    mean_w = region_mean_weights(region_mask, grid_weight).reshape(
        region_cnt, nz, ny
    )
    onehot = np.stack(
        [
            (np.asarray(region_mask) == r + 1).astype(np.float64)
            for r in range(region_cnt)
        ]
    )
    fill = 1.0 - onehot.sum(axis=0)

    def tensor(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return region_cnt, tensor(mean_w), tensor(onehot), tensor(fill)


def _lateral_tridiag_arrays(data: ShardedYearData, ypos, dt_lat, *, dtype,
                            device):
    """(I - dt L_y) tridiagonal coefficients (nz, ny) along ypos for the ADI
    lateral preconditioner sweep"""
    n_space = data.n_space
    vf = np.asarray(data.vfaces, np.float64)
    hf = np.asarray(data.hfaces, np.float64)
    vf_glob = np.concatenate(
        [vf[s, :, :-1] for s in range(n_space)] + [vf[-1, :, -1:]], axis=1
    )
    hf_glob = np.concatenate(
        [hf[s, :, :-1] for s in range(n_space)] + [hf[-1, :, -1:]], axis=1
    )
    ca_g = 0.5 * vf_glob + hf_glob
    cb_g = 0.5 * vf_glob - hf_glob
    dy_r = np.asarray(ypos.delta_r, np.float64)[None, :]
    lat_dl = dy_r * ca_g[:, :-1]
    lat_d = dy_r * (cb_g[:, :-1] - ca_g[:, 1:])
    lat_du = -dy_r * cb_g[:, 1:]

    def tensor(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return (tensor(-dt_lat * lat_dl), tensor(1.0 - dt_lat * lat_d),
            tensor(-dt_lat * lat_du))


class _ShardedKernelInterface:
    """solver-interface methods shared by the family kernels.

    Subclass __init__ sets module_batch, region_cnt, dtype and device, the
    maps _comp_fcn, _dot and _region_broadcast (_init_reductions sets the
    last two from a region mask), and _precond_factor (or None) and
    _precond_apply; the interface then serves NewtonKrylovInCore
    identically for every kernel."""

    def _init_reductions(self, region_mask, grid_weight, nz, ny, dtype):
        """region-weighted dots and broadcasts over (module, tracer, nz, ny)
        states on self.device"""
        if region_mask is None:
            region_mask = np.ones((nz, ny), np.int32)
        if grid_weight is None:
            grid_weight = np.outer(self.depth.delta, self.ypos.delta)
        self._region_mask_np = np.asarray(region_mask)
        (self.region_cnt, self._mean_w, self._onehot,
         self._region_fill) = _region_reduction_arrays(
            region_mask, grid_weight, nz, ny, dtype=dtype, device=self.device)

        def dot(a, b):
            # (B, T, nz, ny) x (R, nz, ny) -> (B, R): per-module, per-region
            # weighted dot products, the tracer axis summed
            prod = torch.sum(a * b, dim=1)
            return torch.einsum("bzy,rzy->br", prod, self._mean_w)

        def region_broadcast(scalars):
            scalars = torch.as_tensor(scalars, dtype=dtype,
                                      device=self.device)
            field = torch.einsum("br,rzy->bzy", scalars, self._onehot)
            return (field + self._region_fill)[:, None, :, :]

        self._dot = dot
        self._region_broadcast = region_broadcast

    def comp_fcn(self, x):
        return self._comp_fcn(x)

    def dot(self, a, b):
        return self._dot(a, b)

    def norm(self, v):
        return torch.sqrt(self._dot(v, v))

    @staticmethod
    def add(a, b):
        return a + b

    def scale(self, v, factor):
        """scale by a scalar or by per-(module, region) factors"""
        if isinstance(factor, torch.Tensor):
            factor = factor.detach().cpu().numpy()
        factor = np.asarray(factor)
        if factor.ndim == 0:
            return v * float(factor)
        return v * self._region_broadcast(factor)

    def region_broadcast(self, scalars):
        """(module, region) scalars (a numpy array, or a tensor that stays on
        its device) -> a field broadcastable over the state, 1 outside every
        region"""
        return self._region_broadcast(scalars)

    def apply_limiter(self, x, increment):
        """no bounds on these tracers; factors are 1"""
        return np.ones((self.module_batch, self.region_cnt))

    def _limiter_scalef_lob0_jit(self, x, increment, lob=0.0):
        """_apply_limiter_lob0's twin on the device: the largest
        per-(module, region) factor keeping x + scalef * increment >= lob in
        every tracer.  Undershoots of the bound are clamped out of the base
        as on the host; a state far outside the bound cannot raise here,
        so the solve's Armijo and convergence flags show the divergence
        instead."""
        base = torch.clamp(x, min=lob)
        violation = base + increment < lob
        denom = torch.where(violation, increment, -torch.ones_like(increment))
        scalef_cell = torch.where(violation, (lob - base) / denom, 1.0)
        per_cell = scalef_cell.amin(dim=1)                 # (M, *spatial)
        masked = torch.where(self._onehot[None] > 0, per_cell[:, None],
                             torch.inf)                     # (M, R, *spatial)
        scalef = masked.amin(dim=tuple(range(2, masked.ndim)))
        return torch.clamp(scalef, max=1.0).to(self.dtype)

    def _finish_linear_family_setup(self, ypos, region_mask, grid_weight,
                                    tracer_diag_pc, t_dim):
        """shared wiring tail for LINEAR family kernels (self._year and
        self._year0 already built): region reductions, the ADI +
        vertical-product preconditioner, and the F and JVP maps"""
        self.grid = physics.Grid2D(*(f.to(self.device)
                                     for f in self.data.grid))
        self._init_reductions(region_mask, grid_weight, self.nz, self.ny,
                              self.dtype)
        self._lat_dl, self._lat_d, self._lat_du = _lateral_tridiag_arrays(
            self.data, ypos, self.year, dtype=self.dtype, device=self.device
        )
        factor, apply = _vertical_product_precond(self, tracer_diag_pc, t_dim)
        self._precond_factor = lambda x: factor()
        self._precond_apply = apply
        self._comp_fcn = lambda y: self._year(y) - y
        self._jvp = lambda v: self._year0(v) - v

    def _apply_limiter_lob0(self, x, increment):
        """shared zero-lower-bound limiter: the largest per-(module=1,
        region) scale factor keeping x + scalef * increment >= 0 across
        every tracer (requires self._region_mask_np)"""
        x_np = self._clamp_lob_base(_host(x)[0])
        inc_np = _host(increment)[0]
        scalef = np.ones((1, self.region_cnt))
        for t_ind in range(x_np.shape[0]):
            comp = comp_scalef_lob(
                self.region_cnt, self._region_mask_np, x_np[t_ind],
                inc_np[t_ind], 0.0,
            )
            scalef[0] = np.minimum(scalef[0], comp)
        return scalef

    def _clamp_lob_base(self, x_np, lob=0.0, tol=1.0e-5):
        """clamp ulp/tolerance-level undershoots of the lower bound out of
        a limiter base (unlimited post-Newton fixed-point updates can sit
        slightly below the bound), but reject genuinely infeasible states
        loudly -- silently clamping a diverged iterate would let the next
        function evaluation hit the model's singularities"""
        undershoot = float(lob - x_np.min())
        scale = max(float(np.abs(x_np).max()), 1.0)
        if undershoot > tol * scale:
            raise RuntimeError(
                f"iterate violates the lower bound {lob} by {undershoot:.3e}"
                f" (tolerance {tol * scale:.3e}); the solve has left the "
                "feasible region"
            )
        return np.maximum(x_np, lob)

    def lin_comb(self, basis, coeff):
        res = self.scale(basis[0], coeff[0])
        for j in range(1, len(basis)):
            res = res + self.scale(basis[j], coeff[j])
        return res

    def precond_setup(self, x):
        factor = getattr(self, "_precond_factor", None)
        return None if factor is None else factor(x)

    def precond_apply(self, data, r):
        return self._precond_apply(data, r)


def _host(t):
    """a tensor (or array) as a numpy array of its own dtype"""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class _FamilyKernel(_ShardedKernelInterface):
    """the setup the linear family kernels share: mesh, axes, year data and
    the module batch's split over the mesh"""

    def __init__(self, mesh, depth, ypos, modelinfo, module_batch, dtype,
                 use_kernel):
        if dtype is None:
            dtype = torch.float32 if use_kernel else torch.float64
        if use_kernel and dtype != torch.float32:
            raise ValueError("use_kernel requires float32")
        n_module, n_space = mesh.shape["module"], mesh.shape["space"]
        self.mesh = mesh
        self.device = mesh.first_device
        self.depth, self.ypos, self.modelinfo = depth, ypos, modelinfo
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.data = ShardedYearData(depth, ypos, modelinfo, n_space, dtype)
        self.nz, self.ny = self.data.nz, self.data.ny
        self.module_batch = module_batch
        if module_batch % n_module != 0:
            raise ValueError(
                f"module batch {module_batch} does not split over "
                f"{n_module} mesh blocks"
            )
        self.year = physics.SEC_PER_YEAR

    def _build_years(self, diag, src_step, src_blocked, n_steps, block_steps):
        """self._year and self._year0 (sources zeroed): the blocked year of
        kernel B3 with use_kernel, else the per-step year"""
        t_span = (0.0, self.year)
        self.n_steps = n_steps
        if self.use_kernel:
            args = (self.mesh, self.depth, self.ypos, self.modelinfo, diag)
            self._year, self._year0 = (
                build_sharded_year_blocked(*args, src, t_span, n_steps,
                                           block_steps=block_steps)
                for src in (src_blocked, np.zeros_like(src_blocked)))
        else:
            self._year, self._year0 = (
                build_sharded_year(self.mesh, self.data, diag, src, t_span,
                                   n_steps)
                for src in (src_step, np.zeros_like(src_step)))

    def _field(self, column, t_dim):
        """a (module_batch, t_dim, nz, ny) state of one depth column"""
        field = np.broadcast_to(column[None, None, :, None],
                                (self.module_batch, t_dim, self.nz, self.ny))
        return torch.as_tensor(np.ascontiguousarray(field), dtype=self.dtype,
                               device=self.device)

    def jvp(self, x, fcn, v):
        """exact: the family is linear, so J v = year0(v) - v"""
        return self._jvp(v)


class ShardedIageKernel(_FamilyKernel):
    """in-core solver kernel over a (module, space) mesh: a batch of
    parameterized iage-family modules (per-module aging rates), the sharded
    IMEX year, exact linear-model JVPs, and a column-local vertical-implicit
    preconditioner with an ADI lateral sweep.

    use_kernel (the JAX kernel's use_pallas) with block_steps: the blocked
    year, k = block_steps interior steps a block, float32; on CUDA devices
    every F and every JVP runs kernel B3, on the CPU its plain version.
    Otherwise the per-step year runs, in any dtype (float64 by default).

    state layout: (module_batch, 2 tracers, nz, ny) on the mesh's first
    device.
    """

    def __init__(self, mesh, depth, ypos, modelinfo, module_rates,
                 dtype=None, n_steps=365, use_kernel=False, block_steps=8,
                 region_mask=None, grid_weight=None):
        super().__init__(mesh, depth, ypos, modelinfo, len(module_rates),
                         dtype, use_kernel)
        self.module_rates = np.asarray(module_rates, np.float64)
        nz, ny = self.nz, self.ny
        rate = surf_restore_rate(depth)
        diag = np.zeros((self.module_batch, 2, nz, ny))
        diag[:, 0, 0, :] = -rate
        diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
        aging = np.asarray(module_rates, np.float64).reshape(-1, 1, 1, 1)
        aging = np.broadcast_to(aging, (self.module_batch, 2, 1, 1))
        # the blocked year takes (module_batch, tracer) rates
        rates_bt = np.broadcast_to(
            np.asarray(module_rates, np.float32).reshape(-1, 1),
            (self.module_batch, 2),
        )
        self._build_years(diag, aging, rates_bt, n_steps, block_steps)
        # the precond's tracer diag is module-invariant (restoring depends
        # only on the tracer)
        self._finish_linear_family_setup(ypos, region_mask, grid_weight,
                                         diag[0], 2)

    def init_iterate(self):
        return self._field(np.interp(self.depth.mid, [55.0, 200.0],
                                     [0.0, 2.0]), 2)


class ShardedForcedFamilyKernel(_FamilyKernel):
    """sharded solver kernel for a forced_{suff}-style module family:
    one tracer per module, surface restoring toward per-module constant
    targets plus per-module first-order decay (the py_driver_2d forced
    module's surf_restore_opt=const / sms_opt=decay configuration) --
    linear, so the source-free year map supplies exact JVPs.  use_kernel
    and block_steps as ShardedIageKernel's; the surface-only restoring
    source rides the blocked year as a per-channel depth profile.

    state layout: (module_batch, 1, nz, ny) on the mesh's first device.
    """

    def __init__(self, mesh, depth, ypos, modelinfo, restore_rate,
                 restore_targets, decay_rates, dtype=None, n_steps=365,
                 region_mask=None, grid_weight=None, use_kernel=False,
                 block_steps=8):
        restore_targets = np.asarray(restore_targets, np.float64)
        decay_rates = np.asarray(decay_rates, np.float64)
        if len(decay_rates) != len(restore_targets):
            raise ValueError("per-module targets and decay rates must pair")
        super().__init__(mesh, depth, ypos, modelinfo, len(restore_targets),
                         dtype, use_kernel)
        nz, ny = self.nz, self.ny

        # implicit local rates: surface restoring + everywhere decay
        diag = np.zeros((self.module_batch, 1, nz, ny))
        diag[:, 0, 0, :] = -float(restore_rate)
        diag -= decay_rates[:, None, None, None]
        # source: the restoring target enters as a surface-layer inflow
        # (z-dependent only, so it broadcasts over the ypos axis)
        source = np.zeros((self.module_batch, 1, nz, 1))
        source[:, 0, 0, 0] = float(restore_rate) * restore_targets
        self._build_years(diag, source,
                          source[:, :, :, 0].astype(np.float32), n_steps,
                          block_steps)

        # the tracer diag varies per module (decay rates); precondition with
        # the family's mean decay -- preconditioners only need to be close
        diag_pc = np.zeros((1, nz, ny))
        diag_pc[0, 0, :] = -float(restore_rate)
        diag_pc -= float(decay_rates.mean())
        self._finish_linear_family_setup(ypos, region_mask, grid_weight,
                                         diag_pc, 1)

    def init_iterate(self):
        """positive interior start (a zero iterate sits exactly on the
        lower bound, where the limiter zeroes any increment with a negative
        component)"""
        return self._field(np.interp(self.data.depth_mid, [50.0, 400.0],
                                     [0.9, 0.1]), 1)

    def apply_limiter(self, x, increment):
        """forced tracers are bounded below by zero (the reference's
        lob: 0.0 for the forced module family)"""
        x_np = self._clamp_lob_base(_host(x))
        inc_np = _host(increment)
        scalef = np.ones((self.module_batch, self.region_cnt))
        for b in range(self.module_batch):
            comp_scalef_lob(
                self.region_cnt, self._region_mask_np, x_np[b, 0],
                inc_np[b, 0], 0.0, out=scalef[b],
            )
        return scalef

    def limiter_scalef_jit(self, x, increment):
        return self._limiter_scalef_lob0_jit(x, increment)


class Slab(NamedTuple):
    """one slab of a launch group of the blocked year's kernel route: the
    shard whose window constants it reads, the shard whose columns a ghost
    slab mirrors (None for the shard itself), its side of `shard` (0 the
    shard, -1 a ghost to its left, +1 to its right) and its neighbour slabs
    in the group (-1: closed)"""
    shard: tuple
    source: tuple
    side: int
    left: int
    right: int


def slab_layout(keys):
    """the launch groups of a blocked year: keys[mi][sj] is shard (mi, sj)'s
    group key (by default its device: every shard of a card in one launch).
    Returns [(key, [Slab, ...]), ...] in the order the keys first appear,
    each group's shards in mesh order; a shard whose ypos neighbour lies in
    another group gets a ghost slab on that side, which the host fills
    from the neighbour before every block of k steps."""
    order = []
    for row in keys:
        for key in row:
            if key not in order:
                order.append(key)
    groups = []
    for key in order:
        slabs, index = [], {}
        for mi, row in enumerate(keys):
            for sj, k in enumerate(row):
                if k != key:
                    continue
                if sj > 0 and row[sj - 1] != key:
                    slabs.append([(mi, sj), (mi, sj - 1), -1, -1, None])
                index[(mi, sj)] = len(slabs)
                slabs.append([(mi, sj), None, 0, None, None])
                if sj < len(row) - 1 and row[sj + 1] != key:
                    slabs.append([(mi, sj), (mi, sj + 1), 1, None, -1])
        for q, slab in enumerate(slabs):
            (mi, sj), _, side, left, right = slab
            if side == -1:
                slab[4] = index[(mi, sj)]
            elif side == 1:
                slab[3] = index[(mi, sj)]
            else:
                slab[3] = (q - 1 if sj > 0 and keys[mi][sj - 1] != key
                           else index.get((mi, sj - 1), -1))
                slab[4] = (q + 1 if sj < len(keys[mi]) - 1
                           and keys[mi][sj + 1] != key
                           else index.get((mi, sj + 1), -1))
        groups.append((key, [Slab(*slab) for slab in slabs]))
    return groups


def _blocked_aging(aging, b_dim, tr_dim, nz_dim):
    """the blocked year's source as (B, T) rates or (B, T, nz) profiles"""
    if aging.shape in ((b_dim, tr_dim), (b_dim * tr_dim,)):
        return aging.reshape(b_dim, tr_dim)
    if aging.shape == (b_dim, tr_dim, 1, 1):
        # the per-step builder's documented aging shape
        return aging.reshape(b_dim, tr_dim)
    if aging.shape == (b_dim, tr_dim, nz_dim):
        return aging  # per-channel depth profiles
    raise ValueError(
        f"aging shape {aging.shape} is neither (module_batch, tracer) "
        f"= ({b_dim}, {tr_dim}) [uniform rates, (B, T, 1, 1) also "
        f"accepted] nor (module_batch, tracer, nz) = "
        f"({b_dim}, {tr_dim}, {nz_dim}) [depth profiles]"
    )


def _kernel_interior(groups, shards, mesh, dims, dt, k, t_block, n_inner):
    """interior(ys, cs) -> (ys, cs): the blocked year's n_inner interior
    steps through kernel B3, one SlabRun a launch group (slab_layout); ys,
    cs: mesh-shaped lists of (C, nz, nyl) shard states after the leading
    half step.  One group without ghost slabs (every shard on one card)
    runs them in one launch; otherwise every block of k steps is a launch
    a group, after the host fills the ghost slabs from the states at the
    block's start."""
    c_dim, nz, nyl, h = dims
    runs = []
    for _, slabs in groups:
        specs = []
        for sl in slabs:
            w, xoff = {0: (nyl, h), -1: (h, 0), 1: (h, h + nyl)}[sl.side]
            specs.append(dict(consts=shards[sl.shard[0]][sl.shard[1]]["consts"],
                              w=w, xoff=xoff, left=sl.left, right=sl.right))
        dev = mesh.devices[slabs[0].shard[0]][slabs[0].shard[1]]
        run = SlabRun(specs, c_dim, nz, dt, k, dev)
        runs.append((run, slabs, torch.as_tensor(t_block, device=dev)))
    # where each shard's state lies: (group, slab)
    home = {sl.shard: (g, q) for g, (_, slabs, _) in enumerate(runs)
            for q, sl in enumerate(slabs) if sl.side == 0}
    whole = len(runs) == 1 and all(sl.side == 0 for sl in runs[0][1])

    def interior(ys, cs):
        global halo_copies
        for (mi, sj), (g, q) in home.items():
            runs[g][0].y[q][0].copy_(ys[mi][sj])
            runs[g][0].c[q][0].copy_(cs[mi][sj])
        bufs = [0] * len(runs)
        if whole and n_inner:
            bufs[0] = runs[0][0].launch(0, n_inner, 0, runs[0][2])
        elif n_inner:
            for g0 in range(0, n_inner, k):
                for g, (run, slabs, _) in enumerate(runs):
                    for q, sl in enumerate(slabs):
                        if sl.source is None:
                            continue
                        gs, qs = home[sl.source]
                        src = runs[gs][0]
                        cols = (slice(nyl - h, nyl) if sl.side < 0
                                else slice(0, h))
                        run.y[q][bufs[g]].copy_(src.y[qs][bufs[gs]][..., cols])
                        run.c[q][bufs[g]].copy_(src.c[qs][bufs[gs]][..., cols])
                        halo_copies += 2
                for g, (run, _, t_dev) in enumerate(runs):
                    bufs[g] = run.launch(g0, min(k, n_inner - g0), bufs[g],
                                         t_dev)
        ys = [[runs[home[(mi, sj)][0]][0].y[home[(mi, sj)][1]][
            bufs[home[(mi, sj)][0]]] for sj in range(len(row))]
            for mi, row in enumerate(ys)]
        cs = [[runs[home[(mi, sj)][0]][0].c[home[(mi, sj)][1]][
            bufs[home[(mi, sj)][0]]] for sj in range(len(row))]
            for mi, row in enumerate(cs)]
        return ys, cs

    return interior


def _build_blocked(mesh, depth, ypos, modelinfo, diag, aging, t_span,
                   n_steps, block_steps, kernel, group_of=None):
    """the blocked sharded year: its interior through kernel B3 (kernel,
    on CUDA devices) or through B3's plain step block with host halo
    exchanges; its CN half steps solve in float64.  group_of(mi, sj,
    device): the kernel's launch group of a shard (by default its device)"""
    n_module, n_space = mesh.shape["module"], mesh.shape["space"]
    nz, ny = len(depth), len(ypos)
    diag = np.asarray(diag, np.float32)
    aging = np.asarray(aging, np.float32)
    b_dim, tr_dim, nz_dim = diag.shape[0], diag.shape[1], diag.shape[2]
    aging = _blocked_aging(aging, b_dim, tr_dim, nz_dim)
    module_batch, t_dim = aging.shape[:2]
    if module_batch % n_module != 0 or ny % n_space != 0:
        raise ValueError("batch/grid do not split over the mesh")
    b_loc = module_batch // n_module
    nyl = ny // n_space
    c_dim = b_loc * t_dim
    k = int(block_steps)
    h = 2 * k
    if nyl < 1 or h < 1:
        raise ValueError("degenerate decomposition")
    if h > nyl:
        raise ValueError(
            f"halo depth 2*block_steps={h} exceeds the shard width "
            f"{nyl}; the slab exchange is single-neighbor -- use "
            f"block_steps <= {nyl // 2} (or fewer spatial shards)"
        )
    nx = nyl + 2 * h

    f32 = torch.float32
    t0 = float(t_span[0])
    dt = float((t_span[1] - t_span[0]) / n_steps)
    n_inner = int(n_steps) - 1
    m_blocks, r_steps = divmod(n_inner, k)

    # the whole grid as one shard's data: its face arrays are global
    data = ShardedYearData(depth, ypos, modelinfo, 1, f32)
    # the warning counts steps a year; a shorter span takes fewer
    _warn_if_explicit_unstable(
        data.grid, n_steps * physics.SEC_PER_YEAR / (t_span[1] - t_span[0]))
    vfaces_g, hfaces_g = data.vfaces[0], data.hfaces[0]
    wvel_g, dy_r_g = data.wvel[0], data.dy_r[0]
    ypos_mid_g = data.ypos_mid[0].astype(np.float64)
    bld_max_g = np.interp(ypos_mid_g, physics._BLD_YPOS, physics._BLD_MAX)
    dz_r, dz_mid, dz_mid_r = data.dz_r, data.dz_mid, data.dz_mid_r
    depth_mid = data.depth_mid

    def face_at(faces, idx):
        """face array sampled at global indices; zero outside the domain"""
        out = np.zeros((faces.shape[0], len(idx)), np.float32)
        inside = (idx >= 0) & (idx <= ny)
        out[:, inside] = faces[:, idx[inside]]
        return out

    # block start times in float32, as the JAX package computes them
    t_starts = (t0 + dt * k * np.arange(m_blocks)).astype(np.float32)
    t_rest = np.float32(t0 + dt * k * m_blocks)
    t_last = t0 + (n_steps - 1) * dt
    shape = (c_dim, nz, nx)
    on_card = [[dev.type == "cuda" for dev in row] for row in mesh.devices]
    if kernel and any(map(any, on_card)) and not all(map(all, on_card)):
        raise ValueError("the blocked year's mesh lies on the CPU or on CUDA "
                         "devices, not on both")
    kernel = kernel and all(map(all, on_card))

    def setup(mi, sj, dev):
        rows = slice(mi * b_loc, (mi + 1) * b_loc)
        diag_mb = diag[rows].reshape(c_dim, nz, ny)
        src_mb = aging[rows].reshape((c_dim,) + aging.shape[2:])
        c0 = sj * nyl
        cols = np.clip(np.arange(c0 - h, c0 + nyl + h), 0, ny - 1)
        faces_idx = np.arange(c0 - h, c0 + nyl + h + 1)
        consts = pack_block_consts(
            face_at(vfaces_g, faces_idx), face_at(hfaces_g, faces_idx),
            wvel_g[:, cols], diag_mb[:, :, cols], src_mb, bld_max_g[cols],
            dy_r_g[cols], dz_r, dz_mid, dz_mid_r, depth_mid,
        )

        def put(arr):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=f32,
                                   device=dev)

        vfo = vfaces_g[:, c0:c0 + nyl + 1]
        hfo = hfaces_g[:, c0:c0 + nyl + 1]
        src = put(src_mb)
        host = not kernel
        return {
            "consts": _consts_on(consts, dev) if kernel else None,
            "blk_k": (plain_block(consts, shape, dt, k, device=dev)
                      if m_blocks and host else None),
            "blk_r": (plain_block(consts, shape, dt, r_steps, device=dev)
                      if r_steps and host else None),
            "diag": put(diag_mb[:, :, c0:c0 + nyl]),
            # (C, 1, 1) uniform rates or (C, nz, 1) depth profiles
            "src": src[:, None, None] if src.dim() == 1 else src[:, :, None],
            "ca": put(0.5 * vfo + hfo),
            "cb": put(0.5 * vfo - hfo),
            "wv_int": put(wvel_g[1:-1, c0:c0 + nyl]),
            "wvel": put(wvel_g[:, c0:c0 + nyl]),
            "dy_r": put(dy_r_g[c0:c0 + nyl]),
            "ypos_mid": put(ypos_mid_g[c0:c0 + nyl]),
            "dz_r": put(dz_r),
            "dz_mid": put(dz_mid),
            "dz_mid_r": put(dz_mid_r),
            "depth_mid": put(depth_mid),
        }

    shards = _by_shard(mesh, setup)

    def kv_own(sh, t):
        return physics.vert_mixing_coeff_arrays(
            sh["depth_mid"], sh["dz_mid"], sh["dz_mid_r"], sh["ypos_mid"],
            sh["wvel"], t)

    def cn_half(sh, y, c, t):
        # in float64, as the step blocks solve their columns
        f64 = torch.float64
        return _kahan_add(y, c, cn_vertical_increment(
            kv_own(sh, t).to(f64), sh["diag"].to(f64), sh["dz_r"].to(f64),
            y.to(f64), 0.5 * dt).float())

    def tend1(sh, y_ext):
        g = sh["ca"] * y_ext[..., :-1] + sh["cb"] * y_ext[..., 1:]
        res = sh["dy_r"] * (g[..., :-1] - g[..., 1:])
        wz_int = 0.5 * (y_ext[:, 1:, 1:-1] + y_ext[:, :-1, 1:-1]) * sh["wv_int"]
        zero_row = y_ext.new_zeros((c_dim, 1, nyl))
        wz = torch.cat([zero_row, wz_int, zero_row], dim=1)
        res = res + sh["dz_r"][:, None] * (wz[:, 1:] - wz[:, :-1])
        return res + sh["src"]

    def each(fn):
        return _by_shard(mesh, lambda mi, sj, dev: fn(shards[mi][sj], mi, sj))

    def run_blocks(ys, cs, name, t_start):
        # every window is cut from the states before any block runs
        ext = each(lambda sh, mi, sj: (_halo_cat(ys, mi, sj, h),
                                       _halo_cat(cs, mi, sj, h)))
        return _unzip(each(lambda sh, mi, sj: [
            arr[..., h:-h] for arr in sh[name](*ext[mi][sj], t_start)]))

    def host_interior(ys, cs):
        for tb in t_starts:
            ys, cs = run_blocks(ys, cs, "blk_k", tb)
        if r_steps:
            ys, cs = run_blocks(ys, cs, "blk_r", t_rest)
        return ys, cs

    interior = host_interior
    if kernel:
        keys = [[(group_of or (lambda mi, sj, dev: dev))(mi, sj, dev)
                 for sj, dev in enumerate(row)]
                for mi, row in enumerate(mesh.devices)]
        interior = _kernel_interior(
            slab_layout(keys), shards, mesh, (c_dim, nz, nyl, h), dt, k,
            np.append(t_starts, t_rest).astype(np.float32), n_inner)

    def year(y0):
        blocks = shard_state(mesh, y0.to(f32))
        ys = [[blk.reshape(c_dim, nz, nyl) for blk in row] for row in blocks]
        # leading CN half-step (column-local)
        ys, cs = _unzip(each(lambda sh, mi, sj: cn_half(
            sh, ys[mi][sj], torch.zeros_like(ys[mi][sj]), t0)))
        ys, cs = interior(ys, cs)
        # final Heun (one halo column a side) and trailing CN half-step
        f1 = each(lambda sh, mi, sj: tend1(sh, _halo_cat(ys, mi, sj, 1)))
        y_mid = each(lambda sh, mi, sj: ys[mi][sj] + dt * f1[mi][sj])
        f2 = each(lambda sh, mi, sj: tend1(sh, _halo_cat(y_mid, mi, sj, 1)))
        ys, cs = _unzip(each(lambda sh, mi, sj: _kahan_add(
            ys[mi][sj], cs[mi][sj], 0.5 * dt * (f1[mi][sj] + f2[mi][sj]))))
        ys, _ = _unzip(each(lambda sh, mi, sj: cn_half(
            sh, ys[mi][sj], cs[mi][sj], t_last + dt)))
        return gather_state(mesh, [[y.reshape(b_loc, t_dim, nz, nyl)
                                    for y in row] for row in ys])

    return year


def build_sharded_year_blocked(mesh, depth, ypos, modelinfo, diag, aging,
                               t_span, n_steps, block_steps=8):
    """the blocked sharded year (the JAX package's
    build_sharded_year_pallas): blocks of k = block_steps interior steps
    between halo exchanges, float32.

    The per-step year (build_sharded_year) pays a dozen small operations a
    step; this one runs blocks of k interior steps on every shard's window
    extended by 2k ghost columns a side.  Each Heun stage pair consumes two
    ghost columns, so a depth-2k halo sustains exactly k steps; owned
    columns see the same operations on the same values whatever the mesh's
    shape.  On CUDA devices the interior runs through kernel B3
    (ops/imex_block_cuda.py::SlabRun, csrc/iage_block.cu): the shards of
    each device in one cooperative launch, the whole interior at once when
    the mesh lies on one card, otherwise one launch a device and block with
    the host filling ghost slabs from the other devices' shards; the
    result is the same bit for bit.  On the CPU each block is B3's plain
    step block on each shard, with host halo exchanges.  The year
    decomposes as the single-device year does (interior Strang half-steps
    merged): a leading CN(dt/2), (n_steps-1) x [Heun; CN(dt)] in blocks of
    k plus a remainder block, and a final Heun (one-column halo) and
    trailing CN(dt/2) in plain PyTorch.  Every CN column solve, in the
    blocks and the half steps, runs in float64 from the float32 state (at
    256 levels a float32 solve loses the slow modes of a rough state).
    Block start times are float32, and so is each step's time inside a
    block: an ulp in the mixing profile's time grows about 1e3-fold through
    its exponential.

    diag: (module_batch, tracer, nz, ny) implicit local rates
    aging: (module_batch, tracer) explicit source rates (or (B, T, 1, 1)),
        or (module_batch, tracer, nz) depth profiles
    Returns year(y) for y (module_batch, tracer, nz, ny) float32; the result
    lies on the mesh's first device.  Raises ValueError when the batch or
    grid do not split over the mesh, for an aging shape it does not take,
    when the halo 2 block_steps exceeds a shard's width, for a mesh on both
    the CPU and CUDA devices, and when a group's tiles do not fit on its
    card at once (ops/imex_block_cuda.py::block_plan).
    """
    return _build_blocked(mesh, depth, ypos, modelinfo, diag, aging, t_span,
                          n_steps, block_steps, True)


def build_sharded_year_blocked_plain(mesh, depth, ypos, modelinfo, diag,
                                     aging, t_span, n_steps, block_steps=8):
    """build_sharded_year_blocked with B3's plain version on every device
    (the reference the kernel is held against on the card)"""
    return _build_blocked(mesh, depth, ypos, modelinfo, diag, aging, t_span,
                          n_steps, block_steps, False)
