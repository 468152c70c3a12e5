"""the port's device-resident GMRES (ops/gmres.py) against the JAX package's
fused GMRES and against the port's host-driven Krylov loop, float64 on the
CPU: the same iteration counts and increments within 1e-10 of their max
(the two paths solve the same per-(module, region) Hessenberg least
squares, numpy lstsq against Givens rotations)"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    phosphorus as jax_phosphorus,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel as JaxIageKernel,
    PhosphorusKernel as JaxPhosphorusKernel,
)
from newton_krylov_ooc_tpu.ops.gmres import (  # noqa: E402
    build_gmres as jax_build_gmres,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
    light_lim_from_numpy,
    params_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel,
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops.gmres import build_gmres  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-10      # increments, relative to their max: float64, two routes
SOLVE_TOL = 1e-8  # a full solve's iterates, relative to max|x|


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _iage_pair(nz=10, ny=6, n_steps=365, region_mask=None, modelinfo=MODELINFO):
    """the JAX package's and the port's IageKernel on one grid, float64"""
    depth, ypos = build_axes(nz, ny)
    weight = None if region_mask is None else np.outer(depth.delta, ypos.delta)
    jk = JaxIageKernel(depth, ypos, modelinfo, dtype=jnp.float64,
                       n_steps=n_steps, region_mask=region_mask,
                       grid_weight=weight, use_pallas=False)
    grid = grid_from_numpy({k: np.asarray(v) for k, v in jk.grid._asdict().items()},
                           device=CPU, dtype=torch.float64)
    tk = IageKernel(depth, ypos, modelinfo, device=CPU, dtype=torch.float64,
                    n_steps=n_steps, region_mask=region_mask,
                    grid_weight=weight, grid=grid)
    return jk, tk


def _gmres_three_ways(jk, tk, rel_tol=1e-3):
    """(port fused, port host, JAX fused): (increment, iterations)"""
    x = tk.init_iterate()
    fcn = tk.comp_fcn(x)
    fused = NewtonKrylovInCore(tk, krylov_rel_tol=rel_tol,
                               jit_gmres=True)._gmres(x, fcn)
    host = NewtonKrylovInCore(tk, krylov_rel_tol=rel_tol)._gmres(x, fcn)
    jx = jk.init_iterate()
    jax_fused = JaxNewtonKrylovInCore(jk, krylov_rel_tol=rel_tol,
                                      jit_gmres=True)._gmres(jx, jk.comp_fcn(jx))
    return fused, host, jax_fused


def test_fused_gmres_matches_host_loop_and_jax():
    """one GMRES solve on the 10x6x365 iage kernel: the fused increment
    is the host loop's and the JAX package's fused one"""
    fused, host, jax_fused = _gmres_three_ways(*_iage_pair())
    assert isinstance(fused[1], int)
    assert fused[1] == host[1] == jax_fused[1] > 1
    assert _rel(fused[0], host[0]) < TOL
    assert _rel(fused[0], jax_fused[0]) < TOL


def test_fused_gmres_multi_region():
    """per-(module, region) batching: four column regions with no lateral
    coupling, each its own least squares"""
    nz, ny = 10, 4
    mask = np.broadcast_to(np.arange(1, ny + 1, dtype=np.int32), (nz, ny)).copy()
    jk, tk = _iage_pair(nz, ny, region_mask=mask,
                        modelinfo={"max_abs_vvel": "0.0",
                                   "horiz_mix_coeff": "0.0"})
    assert tk.region_cnt == 4
    fused, host, jax_fused = _gmres_three_ways(jk, tk)
    assert fused[1] == host[1] == jax_fused[1]
    assert _rel(fused[0], host[0]) < TOL
    assert _rel(fused[0], jax_fused[0]) < TOL


def test_fused_gmres_inactive_block_and_dimension_cap():
    """a block whose residual is exactly zero never holds the loop open,
    and the loop stops at max_dim with the host loop's increment"""
    _, tk = _iage_pair(n_steps=146)
    x = tk.init_iterate()
    fcn = tk.comp_fcn(x)
    for max_dim in (1, 3):
        fused = NewtonKrylovInCore(tk, krylov_rel_tol=1e-12,
                                   krylov_max_dim=max_dim,
                                   jit_gmres=True)._gmres(x, fcn)
        host = NewtonKrylovInCore(tk, krylov_rel_tol=1e-12,
                                  krylov_max_dim=max_dim)._gmres(x, fcn)
        assert fused[1] == host[1] == max_dim
        assert _rel(fused[0], host[0]) < TOL
    gmres = build_gmres(tk.jvp, tk.precond_apply, tk.dot, tk.region_broadcast,
                        5, 1e-3)
    increment, its, resid, beta = gmres(x, torch.zeros_like(fcn),
                                        tk.precond_setup(x))
    assert its == 0 and float(beta.abs().max()) == 0.0
    assert float(increment.abs().max()) == 0.0 and resid.shape == beta.shape


def test_full_solve_with_fused_gmres():
    """a whole Newton solve on the 10x6x730 iage kernel: the fused GMRES
    gives the host loop's and the JAX package's Newton and Krylov counts
    and iterates"""
    jk, tk = _iage_pair(n_steps=730)
    settings = dict(newton_rel_tol=1e-5, newton_max_iter=6)
    x_host, _, info_host = NewtonKrylovInCore(tk, **settings).solve(
        tk.init_iterate())
    x_fused, _, info_fused = NewtonKrylovInCore(
        tk, jit_gmres=True, **settings).solve(tk.init_iterate())
    x_jax, _, info_jax = JaxNewtonKrylovInCore(
        jk, jit_gmres=True, **settings).solve(jk.init_iterate())
    assert info_fused["iterations"] == info_host["iterations"] \
        == info_jax["iterations"] >= 1
    assert np.array_equal(info_fused["krylov_iterations"],
                          info_host["krylov_iterations"])
    assert _rel(x_fused, x_host) < SOLVE_TOL
    assert _rel(x_fused, np.asarray(x_jax)) < SOLVE_TOL


def test_linearize_fn_on_the_phosphorus_year():
    """linearize_fn: the nonlinear phosphorus F linearized once a solve
    (torch.func.linearize through the plain float64 year) against the JAX
    package's build_gmres(..., linearize_fn=) through its scan year, and
    against the port's forward-mode jvp route.  24 steps a year:
    torch.func.linearize traces the year into a graph and folds its
    constants at about 2 s a step on a CPU core (262 s at 96 steps)"""
    nz, ny, n_steps = 8, 6, 24
    depth, ypos = build_axes(nz, ny)
    jk = JaxPhosphorusKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                             n_steps=n_steps, use_pallas=False)
    grid = grid_from_numpy({k: np.asarray(v) for k, v in jk.grid._asdict().items()},
                           device=CPU, dtype=torch.float64)
    light = light_lim_from_numpy(jax_phosphorus.light_lim_2d(depth, ypos),
                                 nz=nz, ny=ny, device=CPU, dtype=torch.float64)
    tk = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU,
                          dtype=torch.float64, n_steps=n_steps, grid=grid,
                          params=params_from_numpy(jk.params), light_lim=light)
    rng = np.random.default_rng(3)
    x_np = np.asarray(jk.init_iterate()) + rng.uniform(0.0, 0.5, (3, nz, ny))
    x, jx = torch.as_tensor(x_np), jnp.asarray(x_np)
    fcn, jfcn = tk.comp_fcn(x), jk.comp_fcn(jx)
    assert _rel(fcn, np.asarray(jfcn)) < TOL

    def target(y):
        return tk._year_plain(y) - y

    args = (tk.jvp, tk.precond_apply, tk.dot, tk.region_broadcast, 10, 1e-2)
    ours = build_gmres(*args, linearize_fn=target)(x, fcn,
                                                    tk.precond_setup(x))
    by_jvp = build_gmres(*args)(x, fcn, tk.precond_setup(x))
    ref = jax_build_gmres(
        jk.jvp, jk.precond_apply, jk.dot, jk.region_broadcast, 10, 1e-2,
        linearize_fn=lambda y: jk._year_fn(y) - y,
    )(jx, jfcn, jk.precond_setup(jx))
    assert ours[1] == by_jvp[1] == int(ref[1]) >= 1
    assert _rel(ours[0], np.asarray(ref[0])) < TOL
    assert _rel(ours[0], by_jvp[0]) < TOL
