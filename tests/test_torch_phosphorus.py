"""the port's py_driver_2d phosphorus path against the JAX package's, on the
CPU: the tendency and its Jacobian (8x6, float64); the plain year against
the JAX scan year (float64) and the JAX Pallas kernel in interpret mode
(float32), 8x6x24; PhosphorusKernel's hooks (10x6x146, float64, 2 regions);
and the spin-up at the JAX in-core test's 10x6x730, float64"""

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
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    PhosphorusKernel as JaxPhosphorusKernel,
)
from newton_krylov_ooc_tpu.ops.imex_pallas import (  # noqa: E402
    build_phosphorus_year_pallas,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import (  # noqa: E402
    phosphorus,
    physics,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
    light_lim_from_numpy,
    params_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    PhosphorusKernel,
)
from newton_krylov_ooc_tpu_torch.ops import imex_cuda  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
YEAR = physics.SEC_PER_YEAR
SPAN = (0.0, YEAR)
TIMES = [0.0, 0.3, 0.7]  # fractions of a year
PHYS_TOL = 1e-12   # relative, float64: the same formulas, reordered at most
HOOK_TOL = 1e-10   # relative, float64: the same maps through two frameworks
F32_TOL = 5e-5     # relative to max|y|: the JAX test's kernel-vs-scan bound
SOLVER = {"newton_rel_tol": 1e-4, "newton_max_iter": 8}


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _port_inputs(jgrid, depth, ypos, dtype):
    """the port's grid, params and light limitation, carried over from the
    JAX package's numpy values"""
    grid = grid_from_numpy({k: np.asarray(v) for k, v in jgrid._asdict().items()},
                           device=CPU, dtype=dtype)
    params = params_from_numpy(jax_phosphorus.DEFAULT_PARAMS)
    light = light_lim_from_numpy(
        jax_phosphorus.light_lim_2d(depth, ypos), nz=len(depth), ny=len(ypos),
        device=CPU, dtype=dtype,
    )
    return grid, params, light


@pytest.fixture(scope="module")
def small():
    """8x6 grid, both packages, float64, and a positive seeded state"""
    depth, ypos = build_axes(8, 6)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    grid, params, light = _port_inputs(jgrid, depth, ypos, torch.float64)
    rng = np.random.default_rng(21)
    y = rng.uniform(0.01, 2.0, (3, 8, 6))
    return depth, ypos, jgrid, grid, params, light, y


def _static_args(depth, ypos):
    p = jax_phosphorus.DEFAULT_PARAMS
    return (
        p["po4_halfsat"], p["max_uptake_rate"], p["sigma"],
        p["dop_remin_rate"], p["pop_remin_rate"], p["pop_sink_vel"],
        tuple(jax_phosphorus.light_lim_2d(depth, ypos).reshape(-1)),
    )


def test_params_and_light_limitation_match_jax(small):
    depth, ypos, _, _, params, light, _ = small
    assert phosphorus.DEFAULT_PARAMS == jax_phosphorus.DEFAULT_PARAMS
    assert params == jax_phosphorus.DEFAULT_PARAMS
    info = {"sigma": "0.5", "pop_sink_vel": "1.0 / 86400.0", "unrelated": "1"}
    assert phosphorus.gen_params(info) == jax_phosphorus.gen_params(info)
    ours = phosphorus.light_lim_2d(depth, ypos, device=CPU, dtype=torch.float64)
    assert np.array_equal(ours.numpy(), jax_phosphorus.light_lim_2d(depth, ypos))
    assert torch.equal(light, ours)
    with pytest.raises(ValueError, match="differ"):
        params_from_numpy({"sigma": 0.5})


@pytest.mark.parametrize("frac", TIMES)
def test_tend_matches_jax(small, frac):
    depth, ypos, jgrid, grid, params, light, y = small
    tend = jax_phosphorus.phosphorus.build_tend(jgrid, _static_args(depth, ypos),
                                                None)
    ref = tend(frac * YEAR, jnp.asarray(y.reshape(-1))).reshape(3, 8, 6)
    ours = phosphorus.phosphorus_tend(grid, params, light, frac * YEAR,
                                      torch.as_tensor(y))
    assert _rel(ours, ref) < PHYS_TOL


@pytest.mark.parametrize("frac", TIMES)
def test_jac_matches_jax(small, frac):
    depth, ypos, jgrid, grid, params, light, y = small
    jac = jax_phosphorus.phosphorus.build_jac(jgrid, _static_args(depth, ypos),
                                              None)
    ref = jac(frac * YEAR, jnp.asarray(y.reshape(-1)))
    ours = phosphorus.phosphorus_jac(grid, params, light, frac * YEAR,
                                     torch.as_tensor(y[0]))
    assert ours.shape == (3 * 48, 3 * 48)
    assert _rel(ours, ref) < PHYS_TOL


def test_jac_is_the_tendency_derivative(small):
    """phosphorus_jac against forward-mode AD of phosphorus_tend"""
    _, _, _, grid, params, light, y = small
    yt = torch.as_tensor(y)
    jac = phosphorus.phosphorus_jac(grid, params, light, 0.4 * YEAR, yt[0])
    v = torch.as_tensor(np.random.default_rng(3).normal(size=y.shape))
    _, tangent = torch.func.jvp(
        lambda s: phosphorus.phosphorus_tend(grid, params, light, 0.4 * YEAR, s),
        (yt,), (v,),
    )
    assert _rel(jac @ v.reshape(-1), tangent.reshape(-1)) < PHYS_TOL


def test_block_diag_tracers_matches_jax():
    rng = np.random.default_rng(4)
    blocks = [rng.normal(size=(5, 5)) for _ in range(3)]
    ours = physics.block_diag_tracers([torch.as_tensor(b) for b in blocks])
    ref = jax_physics.block_diag_tracers([jnp.asarray(b) for b in blocks])
    assert np.array_equal(ours.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def year_setup():
    """8x6x24: the JAX f64 scan year, and the f32 initial iterate"""
    depth, ypos = build_axes(8, 6)
    jk = JaxPhosphorusKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                             n_steps=24, use_pallas=False)
    return depth, ypos, jk


def test_plain_year_matches_jax_scan(year_setup):
    depth, ypos, jk = year_setup
    grid, params, light = _port_inputs(jk.grid, depth, ypos, torch.float64)
    y0 = np.asarray(jk.init_iterate()) + np.random.default_rng(8).uniform(
        0.0, 0.5, (3, 8, 6))
    ref = jk._year_fn(jnp.asarray(y0))
    year = imex_cuda.build_phosphorus_year_plain(grid, params, light, SPAN, 24)
    y = year(torch.as_tensor(y0))
    assert float(np.abs(y.numpy() - np.asarray(ref)).max()) < (
        1e-12 * float(np.abs(np.asarray(ref)).max())
    )
    # total phosphorus (grid-weighted, summed over tracers) is conserved
    w = np.outer(depth.delta, ypos.delta)
    p0, p1 = (w * y0).sum(), (w * y.numpy()).sum()
    assert abs(p1 - p0) < 1e-13 * abs(p0)


def test_kernel_cpu_dispatch_matches_pallas_interpret(year_setup):
    """the kernel's wrapper on the CPU (its plain version in float32)
    against the JAX package's Pallas kernel in interpret mode"""
    depth, ypos, jk = year_setup
    jgrid32 = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    y0 = np.asarray(JaxPhosphorusKernel.init_iterate(jk), np.float32)
    ref = build_phosphorus_year_pallas(
        jgrid32, jax_phosphorus.DEFAULT_PARAMS,
        jax_phosphorus.light_lim_2d(depth, ypos), SPAN, 24,
    )(jnp.asarray(y0), interpret=True)
    grid, params, light = _port_inputs(jk.grid, depth, ypos, torch.float64)
    before = imex_cuda.phosphorus_year_launches
    year = imex_cuda.build_phosphorus_year(grid, params, light, SPAN, 24,
                                           device="cpu")
    y = year(torch.as_tensor(y0))
    assert imex_cuda.phosphorus_year_launches == before  # no kernel on the CPU
    assert y.dtype == torch.float32
    scale = float(np.abs(np.asarray(ref)).max())
    assert float(np.abs(y.numpy() - np.asarray(ref)).max()) / scale < F32_TOL
    with pytest.raises(ValueError):
        year(torch.as_tensor(y0).double())
    with pytest.raises(ValueError):
        year(torch.as_tensor(y0)[:2])


def test_kernel_cuda_request_never_falls_back(year_setup, monkeypatch):
    """a CUDA request without a card raises, for the wrapper and for
    PhosphorusKernel, and never returns a CPU year"""
    depth, ypos, jk = year_setup
    grid, params, light = _port_inputs(jk.grid, depth, ypos, torch.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        imex_cuda.build_phosphorus_year(grid, params, light, SPAN, 24,
                                        device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PhosphorusKernel(depth, ypos, MODELINFO, device="cuda", n_steps=24)


NZ, NY = 10, 6


@pytest.fixture(scope="module")
def kernels():
    """10x6x146, float64, two regions: both packages' kernels, a positive
    state and a direction"""
    depth, ypos = build_axes(NZ, NY)
    region_mask = np.where(np.arange(NZ)[:, None] < 4, 1, 2) * np.ones(
        (1, NY), np.int32
    )
    jk = JaxPhosphorusKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                             n_steps=146, region_mask=region_mask,
                             use_pallas=False)
    grid, params, light = _port_inputs(jk.grid, depth, ypos, torch.float64)
    tk = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU,
                          dtype=torch.float64, n_steps=146,
                          region_mask=region_mask, params=params, grid=grid,
                          light_lim=light)
    rng = np.random.default_rng(5)
    x = np.asarray(jk.init_iterate()) + rng.uniform(0.0, 1.0, (3, NZ, NY))
    v = rng.normal(size=(3, NZ, NY))
    return jk, tk, x, v


def test_dispatch_and_init_iterate(kernels):
    jk, tk, _, _ = kernels
    assert not tk.use_kernel  # float64 on the CPU: the plain year
    assert tk._year_fn is tk._year_plain
    assert tk.region_cnt == jk.region_cnt == 2
    assert np.array_equal(tk.init_iterate().numpy(), np.asarray(jk.init_iterate()))
    assert np.array_equal(tk.apply_limiter(None, None), jk.apply_limiter(None, None))


def test_comp_fcn_and_jvp_match_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    fcn = tk.comp_fcn(xt)
    assert _rel(fcn, jk.comp_fcn(jnp.asarray(x))) < HOOK_TOL
    # forward mode through the year in both packages
    ref = jk.jvp(jnp.asarray(x), None, jnp.asarray(v))
    assert _rel(tk.jvp(xt, fcn, vt), ref) < HOOK_TOL


def test_reductions_and_scaling_match_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    assert tk.dot(xt, vt).shape == (1, 2)
    assert _rel(tk.dot(xt, vt), jk.dot(jx, jv)) < HOOK_TOL
    assert _rel(tk.norm(vt), jk.norm(jv)) < HOOK_TOL
    factors = np.array([[0.5, -3.0]])
    assert _rel(tk.scale(vt, factors), jk.scale(jv, factors)) < HOOK_TOL
    assert _rel(tk.scale(vt, 2.5), jk.scale(jv, 2.5)) < HOOK_TOL
    coeff = np.array([[[1.0, 2.0]], [[-0.5, 0.25]]])
    assert _rel(tk.lin_comb([xt, vt], coeff), jk.lin_comb([jx, jv], coeff)) < HOOK_TOL


def test_preconditioner_matches_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    ours = tk.precond_apply(tk.precond_setup(xt), vt)
    ref = jk.precond_apply(jk.precond_setup(jnp.asarray(x)), jnp.asarray(v))
    assert _rel(ours, ref) < HOOK_TOL


def test_build_year_operator_raises(kernels):
    _, tk, _, _ = kernels
    with pytest.raises(NotImplementedError, match="nonlinear"):
        tk.build_year_operator()


class _CountingJaxSolver(JaxNewtonKrylovInCore):
    """the JAX host-driven solver, recording Krylov iterations per step"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.krylov_iterations = []

    def _gmres(self, x, fcn):
        increment, its = super()._gmres(x, fcn)
        self.krylov_iterations.append(its)
        return increment, its


def test_spinup_matches_jax():
    """the JAX in-core phosphorus test's solve (10x6, 730 steps, float64,
    newton_rel_tol 1e-4) in both packages"""
    depth, ypos = build_axes(NZ, NY)
    jk = JaxPhosphorusKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                             n_steps=730, use_pallas=False)
    jsolver = _CountingJaxSolver(jk, **SOLVER)
    x_ref, _, info_ref = jsolver.solve(jk.init_iterate())

    grid, params, light = _port_inputs(jk.grid, depth, ypos, torch.float64)
    tk = PhosphorusKernel(depth, ypos, MODELINFO, device=CPU,
                          dtype=torch.float64, n_steps=730, params=params,
                          grid=grid, light_lim=light)
    x0 = tk.init_iterate()
    solver = NewtonKrylovInCore(tk, **SOLVER)
    x, _, info = solver.solve(x0)

    assert info["iterations"] == info_ref["iterations"]
    assert list(info["krylov_iterations"]) == jsolver.krylov_iterations
    assert len(solver.stats) <= 4
    assert (info["fcn_norm"] / info["x_norm"] < 1e-4).all()
    assert _rel(x, x_ref) < 1e-8
    assert torch.isfinite(x).all()
    assert float(x[0].min()) > 0.0  # po4 stays positive
    w = torch.as_tensor(np.outer(depth.delta, ypos.delta))
    p0, p1 = float((w * x0).sum()), float((w * x).sum())
    assert abs(p1 - p0) < 1e-12 * abs(p0)
