"""the port's sharded phosphorus kernels against the JAX package's: the
per-step 2D sharded year's column-local hook, ShardedPhosphorusKernel hook
by hook and in a solve, light_lim_3d and ShardedPhosphorus3dKernel hook by
hook and in solves on one shard and on a (2, 2) mesh.  JAX runs as its own
tests run it: on the CPU, x64 on, 8 virtual devices (tests/conftest.py);
the port runs the plain versions on CPU meshes."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.models.irf_offline import (  # noqa: E402
    synthetic as jax_synthetic,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    phosphorus as jax_phosphorus,
)
from newton_krylov_ooc_tpu.parallel import mesh as jax_mesh  # noqa: E402
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_transport3d as jax_t3d,
)
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_year as jax_sharded,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import (  # noqa: E402
    NewtonKrylovInCore,
)
from newton_krylov_ooc_tpu_torch.models.irf_offline import (  # noqa: E402
    synthetic,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    params_from_numpy,
)
from newton_krylov_ooc_tpu_torch.parallel import (  # noqa: E402
    mesh,
    sharded_transport3d,
    sharded_year,
)

torch.set_num_threads(1)

YEAR = 365.0 * 86400.0
F64_TOL = 1e-12   # relative to max: the same float64 arithmetic
PC_TOL = 1e-10    # relative: LU and PCR solves in another order
SOLVE_2D_TOL = 1e-8   # the JAX test's own mesh bound
SOLVE_3D_TOL = 1e-10
MESH_3D_TOL = 1e-11   # the port's meshes, as JAX's test
CPU = torch.device("cpu")
NZ, NY, N_STEPS = 8, 8, 24


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_mesh(n_module, n_space):
    return jax_mesh.make_mesh(n_module, n_space,
                              devices=jax.devices()[:n_module * n_space])


def _torch_mesh(n_module, n_space):
    return mesh.make_mesh(n_module, n_space,
                          devices=["cpu"] * (n_module * n_space))


def _jax_phos_terms(p, light, dz_r, y):
    """the JAX ShardedPhosphorusKernel's local_tend
    (parallel/sharded_year.py:1021-1042)"""
    po4, dop, pop = y[..., 0, :, :], y[..., 1, :, :], y[..., 2, :, :]
    uptake = p["max_uptake_rate"] * light * po4 / (po4 + p["po4_halfsat"])
    dop_remin = p["dop_remin_rate"] * dop
    pop_remin = p["pop_remin_rate"] * pop
    d_po4 = -uptake + dop_remin + pop_remin
    d_dop = p["sigma"] * uptake - dop_remin
    d_pop = (1.0 - p["sigma"]) * uptake - pop_remin
    sink_int = p["pop_sink_vel"] * pop[..., :-1, :]
    zero = jnp.zeros(pop.shape[:-2] + (1,) + pop.shape[-1:], y.dtype)
    sink = jnp.concatenate([zero, sink_int, zero], axis=-2)
    d_pop = d_pop + dz_r[:, None] * (sink[..., :-1, :] - sink[..., 1:, :])
    return jnp.stack([d_po4, d_dop, d_pop], axis=-3)


# -- 2D: the hook -------------------------------------------------------------


def test_local_tend_matches_jax():
    """the 2D column terms on random states (and the 3D ones with every
    interface open) against the JAX kernel's hook"""
    depth, ypos = build_axes(NZ, NY)
    p = jax_phosphorus.DEFAULT_PARAMS
    rng = np.random.default_rng(0)
    y = rng.uniform(0.0, 2.0, (1, 3, NZ, NY))
    light = jax_phosphorus.light_lim_2d(depth, ypos)
    dz_r = rng.uniform(1e-3, 1e-1, NZ)
    ref = _jax_phos_terms(p, jnp.asarray(light), jnp.asarray(dz_r),
                          jnp.asarray(y))
    args = (torch.as_tensor(light), torch.as_tensor(dz_r)[:, None],
            torch.as_tensor(y))
    assert _rel(sharded_year.phosphorus_terms(p, *args), ref) < F64_TOL
    ones = torch.ones((NZ - 1, NY), dtype=torch.float64)
    assert torch.equal(sharded_year.phosphorus_terms(p, *args, ones),
                       sharded_year.phosphorus_terms(p, *args))


def test_year_with_the_hook_matches_jax(kernels_2d):
    """build_sharded_year with the column-local hook on a (1, 1) mesh
    against JAX's build_sharded_year with the same hook, float64: the JAX
    ShardedPhosphorusKernel's year on (1, 2), x + F(x) from the fixture's
    compile (the kernels' F below holds the port's on (1, 2)); the hook
    sees every Heun stage's time"""
    _, _, x, _, (fcn_ref, _) = kernels_2d
    depth, ypos = build_axes(NZ, NY)
    p = jax_phosphorus.DEFAULT_PARAMS
    light = jax_phosphorus.light_lim_2d(depth, ypos)
    data = sharded_year.ShardedYearData(depth, ypos, MODELINFO, 1)
    dz_r = torch.as_tensor(data.dz_r)[:, None]
    seen = []

    def hook(t, y, dl):
        seen.append(float(t))
        return sharded_year.phosphorus_terms(p, dl["light"], dz_r, y)

    year = sharded_year.build_sharded_year(
        _torch_mesh(1, 1), data, np.zeros((1, 3, NZ, NY)),
        np.zeros((1, 3, 1, 1)), (0.0, YEAR), N_STEPS, local_tend=hook,
        local_data={"light": light[None]})
    assert _rel(year(torch.as_tensor(x)), x + fcn_ref) < F64_TOL
    dt = YEAR / N_STEPS
    stage_times = np.array([[i * dt, i * dt + dt] for i in range(N_STEPS)])
    assert np.allclose(seen, stage_times.reshape(-1), rtol=1e-15, atol=0.0)


def test_hookless_year_is_unchanged():
    """without a hook the (1, 2) per-step year is the hook's year with a
    zero tendency bit for bit (tests/test_torch_sharded_year.py holds the
    hookless year against JAX's)"""
    depth, ypos = build_axes(NZ, NY)
    diag = np.zeros((1, 2, NZ, NY))
    diag[:, :, 0, :] = -1e-6
    aging = np.full((1, 2, 1, 1), 1.0 / YEAR)
    y0 = torch.as_tensor(np.random.default_rng(2).uniform(
        0.0, 1.0, (1, 2, NZ, NY)))
    data = sharded_year.ShardedYearData(depth, ypos, MODELINFO, 2)

    def build(**hook):
        return sharded_year.build_sharded_year(
            _torch_mesh(1, 2), data, diag, aging, (0.0, YEAR), N_STEPS,
            **hook)

    out = build()(y0)
    assert torch.equal(out, build(local_data={})(y0))
    zero = build(local_tend=lambda t, y, dl: torch.zeros_like(y))(y0)
    assert torch.equal(out, zero)


# -- 2D: the kernel -----------------------------------------------------------


@pytest.fixture(scope="module")
def kernels_2d():
    depth, ypos = build_axes(NZ, NY)
    jk = jax_sharded.ShardedPhosphorusKernel(
        _jax_mesh(1, 2), depth, ypos, MODELINFO, n_steps=N_STEPS)
    tk = sharded_year.ShardedPhosphorusKernel(
        _torch_mesh(1, 2), depth, ypos, MODELINFO, n_steps=N_STEPS,
        params=params_from_numpy(jk.params))
    rng = np.random.default_rng(5)
    x = np.asarray(jk.init_iterate()) + rng.uniform(0.0, 0.3, (1, 3, NZ, NY))
    v = rng.normal(size=x.shape)
    return jk, tk, x, v, _jax_fcn_and_jvp(jk, _put(jk, x), _put(jk, v))


def _put(jk, arr):
    return jax.device_put(jnp.asarray(arr), jk.state_sharding)


def _jax_fcn_and_jvp(jk, x, v):
    """the JAX kernel's F(x) and J v in one compile: jax.jvp of the
    function its comp_fcn jits and its jvp differentiates (linearize_target,
    year(y) - y)"""
    return tuple(np.asarray(a) for a in jax.jit(
        lambda x, v: jax.jvp(jk.linearize_target, (x,), (v,)))(x, v))


def test_phosphorus_kernel_fcn_matches_jax(kernels_2d):
    jk, tk, x, _, (fcn_ref, _) = kernels_2d
    assert np.array_equal(tk.init_iterate().numpy(),
                          np.asarray(jk.init_iterate()))
    assert tk.region_cnt == jk.region_cnt == 1
    assert _rel(tk.comp_fcn(torch.as_tensor(x)), fcn_ref) < F64_TOL
    with pytest.raises(ValueError, match="n_module"):
        sharded_year.ShardedPhosphorusKernel(
            _torch_mesh(2, 1), *build_axes(NZ, NY), MODELINFO)


def test_phosphorus_kernel_jvp_matches_jax(kernels_2d):
    """forward mode through the (1, 2) year against jax.jvp through JAX's"""
    _, tk, x, v, (_, jvp_ref) = kernels_2d
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    assert _rel(tk.jvp(xt, None, vt), jvp_ref) < F64_TOL


def test_phosphorus_kernel_precond_matches_jax(kernels_2d):
    jk, tk, x, v, _ = kernels_2d
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    lu = tk.precond_setup(xt)
    assert tuple(lu.shape) == (NY, 3 * NZ, 7)
    jlu = jk.precond_setup(_put(jk, x))
    assert _rel(lu, jlu) < PC_TOL
    assert _rel(tk.precond_apply(lu, vt),
                jk.precond_apply(jlu, _put(jk, v))) < PC_TOL


def test_phosphorus_kernel_limiter_matches_jax(kernels_2d):
    jk, tk, x, v, _ = kernels_2d
    xt = torch.as_tensor(x)
    inc = -2.0 * np.abs(v) * (v > 0.5)
    ours = tk.apply_limiter(xt, torch.as_tensor(inc))
    ref = jk.apply_limiter(_put(jk, x), _put(jk, inc))
    assert np.array_equal(ours, np.asarray(ref)) and (ours < 1.0).all()
    fused = tk.limiter_scalef_jit(xt, torch.as_tensor(inc))
    assert _rel(fused, jk.limiter_scalef_jit(_put(jk, x),
                                             _put(jk, inc))) < F64_TOL
    with pytest.raises(RuntimeError, match="lower bound"):
        tk.apply_limiter(-xt, torch.as_tensor(inc))


SOLVE_2D = dict(newton_rel_tol=1e-4, krylov_rel_tol=1e-2, newton_max_iter=8,
                krylov_max_dim=25, jit_gmres=True)


def _solve_2d(n_space, n_steps):
    """the port's and JAX's solves on a (1, n_space) mesh: (x, info) each"""
    depth, ypos = build_axes(NZ, NY)
    jk = jax_sharded.ShardedPhosphorusKernel(
        _jax_mesh(1, n_space), depth, ypos, MODELINFO, n_steps=n_steps)
    x_ref, _, info_ref = JaxNewtonKrylovInCore(jk, **SOLVE_2D).solve(
        jk.init_iterate())
    tk = sharded_year.ShardedPhosphorusKernel(
        _torch_mesh(1, n_space), depth, ypos, MODELINFO, n_steps=n_steps)
    x, _, info = NewtonKrylovInCore(tk, **SOLVE_2D).solve(tk.init_iterate())
    return (x, info), (np.asarray(x_ref), info_ref)


def _check_solve_2d(ours, ref):
    (x, info), (x_ref, info_ref) = ours, ref
    assert (info["fcn_norm"] < 1e-4 * info["x_norm"]).all()
    assert info["iterations"] == info_ref["iterations"] <= 5
    assert torch.isfinite(x).all() and float(x[0, 0].min()) > 0.0
    assert _rel(x, x_ref) < SOLVE_2D_TOL


@pytest.mark.slow
def test_phosphorus_solve_matches_jax_at_jax_inputs():
    """the JAX test's solve (tests/test_sharded_year.py:480-520): 8x8x96 on
    (1, 2) and (1, 1), each against JAX's (the JAX solve's Newton count,
    iterates within 1e-8 of max|x|), and the meshes against each other"""
    results = []
    for n_space in (2, 1):
        ours, ref = _solve_2d(n_space, 96)
        _check_solve_2d(ours, ref)
        results.append(ours[0])
    assert _rel(results[0], results[1].numpy()) < SOLVE_2D_TOL


# -- 3D -----------------------------------------------------------------------

NZ3, NLAT, NLON = 4, 8, 6
SPAN_30D = (0.0, 30.0 * 86400.0)


def _circ():
    """the JAX test's mask holes (tests/test_sharded_transport3d.py:448-451)"""
    mask = np.ones((NZ3, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    return synthetic.gen_circulation(NZ3, NLAT, NLON, mask=mask)


def _jax_3d_mesh(n_y, n_x):
    devs = jax.devices("cpu")
    if n_x is None:
        return Mesh(np.asarray(devs[:n_y]).reshape(n_y), ("space",))
    return Mesh(np.asarray(devs[:n_y * n_x]).reshape(n_y, n_x),
                ("space", "space_x"))


def _torch_3d_mesh(n_y, n_x):
    if n_x is None:
        return mesh.make_mesh(1, n_y, devices=["cpu"] * n_y)
    return mesh.make_mesh(1, n_y, devices=["cpu"] * (n_y * n_x), n_space_x=n_x)


def test_light_lim_3d_matches_jax():
    dz = _circ()["dz"]
    ours = sharded_transport3d.light_lim_3d(dz, NLAT, NLON)
    assert ours.shape == (NZ3, NLAT, NLON)
    assert np.array_equal(ours, jax_t3d.light_lim_3d(dz, NLAT, NLON))


@pytest.fixture(scope="module")
def kernels_3d():
    circ = _circ()
    jk = jax_t3d.ShardedPhosphorus3dKernel(
        _jax_3d_mesh(2, 2), circ, n_steps=30, t_span=SPAN_30D)
    tk = sharded_transport3d.ShardedPhosphorus3dKernel(
        circ, n_steps=30, t_span=SPAN_30D, mesh=_torch_3d_mesh(2, 2),
        params=params_from_numpy(jk.params))
    rng = np.random.default_rng(11)
    wet = (circ["mask"] > 0)
    x = (np.asarray(jk.init_iterate())
         + rng.uniform(0.0, 0.3, (1, 3, NZ3, NLAT, NLON)) * wet)
    v = rng.normal(size=x.shape) * wet
    return jk, tk, x, v, _jax_fcn_and_jvp(jk, _put3(jk, x), _put3(jk, v))


def _put3(jk, arr):
    return jax.device_put(jnp.asarray(arr), jk.state_sharding)


def test_phosphorus3d_fcn_and_total_p_match_jax(kernels_3d):
    jk, tk, x, _, (fcn_ref, _) = kernels_3d
    x0 = tk.init_iterate()
    assert np.array_equal(x0.numpy(), np.asarray(jk.init_iterate()))
    # the tendency conserves total P exactly (sinking telescopes)
    ones = torch.ones_like(x0)
    assert float(tk.dot(tk.comp_fcn(x0), ones).abs().max()) < 1e-12
    assert _rel(tk.comp_fcn(torch.as_tensor(x)), fcn_ref) < F64_TOL


def test_phosphorus3d_jvp_matches_jax(kernels_3d):
    _, tk, x, v, (_, jvp_ref) = kernels_3d
    assert _rel(tk.jvp(torch.as_tensor(x), None, torch.as_tensor(v)),
                jvp_ref) < F64_TOL


def test_phosphorus3d_precond_and_limiter_match_jax(kernels_3d):
    jk, tk, x, v, _ = kernels_3d
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    lu = tk.precond_setup(xt)
    assert tuple(lu.shape) == (NLAT * NLON, 3 * NZ3, 7)
    jlu = jk.precond_setup(_put3(jk, x))
    assert _rel(lu, jlu) < PC_TOL
    z = tk.precond_apply(lu, vt)
    assert _rel(z, jk.precond_apply(jlu, _put3(jk, v))) < PC_TOL
    # the rank-1 projection: w^T z = -w^T r
    ones = torch.ones_like(vt)
    assert _rel(tk.dot(z, ones), -tk.dot(vt, ones).numpy()) < PC_TOL
    inc = -2.0 * np.abs(v) * (v > 0.5)
    ours = tk.apply_limiter(xt, torch.as_tensor(inc))
    assert np.array_equal(ours, np.asarray(jk.apply_limiter(
        _put3(jk, x), _put3(jk, inc))))
    assert _rel(tk.limiter_scalef_jit(xt, torch.as_tensor(inc)),
                jk.limiter_scalef_jit(_put3(jk, x), _put3(jk, inc))) < F64_TOL


SOLVE_3D = dict(newton_rel_tol=1e-6, krylov_rel_tol=1e-3, newton_max_iter=10,
                krylov_max_dim=40, jit_gmres=True)


def _solve_3d(circ, n_steps, t_span, meshes):
    """the port's and JAX's solves on each (n_y, n_x) mesh, checked as the
    JAX test checks its own; returns the port's iterates"""
    results = []
    for n_y, n_x in meshes:
        jk = jax_t3d.ShardedPhosphorus3dKernel(
            _jax_3d_mesh(n_y, n_x), circ, n_steps=n_steps, t_span=t_span)
        x_ref, _, info_ref = JaxNewtonKrylovInCore(jk, **SOLVE_3D).solve(
            jk.init_iterate())
        kwargs = ({"device": "cpu"} if (n_y, n_x) == (1, None)
                  else {"mesh": _torch_3d_mesh(n_y, n_x)})
        tk = sharded_transport3d.ShardedPhosphorus3dKernel(
            circ, n_steps=n_steps, t_span=t_span, **kwargs)
        x0 = tk.init_iterate()
        ones = torch.ones_like(x0)
        assert float(tk.dot(tk.comp_fcn(x0), ones).abs().max()) < 1e-12
        x, _, info = NewtonKrylovInCore(tk, **SOLVE_3D).solve(x0)
        assert (info["fcn_norm"] < 1e-6 * info["x_norm"]).all()
        assert info["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(tk.dot(x, ones).numpy(),
                                   tk.dot(x0, ones).numpy(), rtol=1e-9)
        assert float(x.min()) >= 0.0
        assert _rel(x, np.asarray(x_ref)) < SOLVE_3D_TOL
        results.append(x)
    scale = float(results[0].abs().max())
    assert float((results[1] - results[0]).abs().max()) < MESH_3D_TOL * scale


@pytest.mark.slow
def test_phosphorus3d_gmres_matches_jax(kernels_3d):
    """a Newton step's fused GMRES (ops/gmres.py, two Krylov steps of the
    forward-mode JVP and the banded preconditioner) on the (2, 2) mesh
    against JAX's build_gmres on its own (about 14 s, most of it JAX's
    compile); the whole solves, a few hundred JVPs each, below"""
    from newton_krylov_ooc_tpu.ops.gmres import build_gmres as jax_gmres

    from newton_krylov_ooc_tpu_torch.ops.gmres import build_gmres

    jk, tk, x, _, _ = kernels_3d
    xt, jx = torch.as_tensor(x), _put3(jk, x)
    fcn, jfcn = tk.comp_fcn(xt), jk.comp_fcn(jx)
    ours = build_gmres(tk.jvp, tk.precond_apply, tk.dot, tk.region_broadcast,
                       2, 1e-12)(xt, fcn, tk.precond_setup(xt))
    ref = jax_gmres(jk.jvp, jk.precond_apply, jk.dot, jk.region_broadcast,
                    2, 1e-12)(jx, jfcn, jk.precond_setup(jx))
    assert ours[1] == int(ref[1]) == 2
    assert _rel(ours[0], np.asarray(ref[0])) < PC_TOL


@pytest.mark.slow
def test_phosphorus3d_solve_matches_jax():
    """30 days at daily steps on 1 shard and on (2, 2), each against JAX's
    solve, and against each other"""
    _solve_3d(_circ(), 30, SPAN_30D, ((1, None), (2, 2)))


@pytest.mark.slow
def test_phosphorus3d_solve_matches_jax_at_jax_inputs():
    """the JAX test's solve (tests/test_sharded_transport3d.py:435-492): a
    year at 480 steps on (1, None) and (2, 2)"""
    circ = _circ()
    n_steps = max(480, jax_synthetic.stable_steps_per_year(circ))
    _solve_3d(circ, n_steps, (0.0, YEAR), ((1, None), (2, 2)))


# -- the card's configurations (chip_smoke.py's phase 18) ----------------------


@pytest.mark.parametrize("steps, stable", [(73, False), (94, False),
                                           (110, True)])
def test_phosphorus_2d_year_stability_at_40x50(steps, stable):
    """why phase 18's 2D year runs 110 steps: at py_driver_2d's 40 x 50 a
    year of 73-94 Heun steps is explicitly unstable (the 10 m top layer's
    uptake and sinking), growing far past the initial iterate's max 4.1;
    at 110 the year stays within it"""
    kernel = sharded_year.ShardedPhosphorusKernel(
        _torch_mesh(1, 1), *build_axes(40, 50), MODELINFO, n_steps=steps)
    x0 = kernel.init_iterate()
    y = kernel._year(x0)
    grows = float(y.abs().max()) > 2.0 * float(x0.abs().max())
    assert grows != stable


@pytest.mark.slow
@pytest.mark.parametrize("grid, converges", [((4, 20, 16), True),
                                             ((10, 24, 20), False)],
                         ids=["4x20x16", "10x24x20"])
def test_phosphorus3d_grid_of_the_card(grid, converges):
    """why phase 18's 3D solve runs at 4 x 20 x 16: the JAX package's own
    solve (the JAX test's settings and mask holes, 30 days at daily steps,
    one device) converges there, and leaves the feasible region at
    examples/irf3d_spinup.py's 10 x 24 x 20"""
    mask = np.ones(grid, np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    jk = jax_t3d.ShardedPhosphorus3dKernel(
        _jax_3d_mesh(1, None), jax_synthetic.gen_circulation(*grid, mask=mask),
        n_steps=30, t_span=SPAN_30D)
    solver = JaxNewtonKrylovInCore(jk, **SOLVE_3D)
    if not converges:
        with pytest.raises(RuntimeError, match="feasible region"):
            solver.solve(jk.init_iterate())
        return
    x, _, info = solver.solve(jk.init_iterate())
    assert (np.asarray(info["fcn_norm"]) < 1e-6 * np.asarray(info["x_norm"])).all()
    assert float(np.asarray(x).min()) >= 0.0
