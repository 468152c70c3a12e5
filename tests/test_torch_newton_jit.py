"""the port's device-resident Newton-Krylov (ops/newton_jit.py,
NewtonKrylovInCore(jit_newton=True)) against the port's host-driven solve
and the JAX package's fused solve, float64 on the CPU: Newton iterations
exact, iterates within 1e-10 of max|x|, stats within rtol 1e-6 (the JAX
tests' bounds, tests/test_newton_jit.py), and the same errors"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.core.spatial_axis import (  # noqa: E402
    spatial_axis_defn_dict,
    spatial_axis_from_defn_dict,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel as JaxIageKernel,
)
from newton_krylov_ooc_tpu.models.test_problem.incore import (  # noqa: E402
    DyeDecayFamilyKernel as JaxDyeDecayFamilyKernel,
)
from newton_krylov_ooc_tpu.parallel import mesh as jax_mesh  # noqa: E402
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_year as jax_sharded,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel,
)
from newton_krylov_ooc_tpu_torch.models.test_problem.incore import (  # noqa: E402
    DyeDecayFamilyKernel,
)
from newton_krylov_ooc_tpu_torch.parallel import mesh  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel.sharded_year import (  # noqa: E402
    ShardedForcedFamilyKernel,
)
from newton_krylov_ooc_tpu_torch.utils.regions import (  # noqa: E402
    comp_scalef_lob,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
YEAR = 365.0 * 86400.0
X_TOL = 1e-10    # iterates, relative to max|x|
STATS_RTOL = 1e-6
# the forced family on a (1, 2) mesh: 8x8, 36 steps, two regions, the
# restoring and decay of tests/test_torch_sharded_year.py; from its initial
# iterate the first increment crosses zero, so the lob-0 limiter scales it
NZ, NY, N_STEPS = 8, 8, 36
REGIONS = np.where(np.arange(NZ)[:, None] < 4, 1, 2) * np.ones((1, NY),
                                                                np.int32)
FORCED = dict(restore_rate=1.0 / (10.0 * 86400.0),
              restore_targets=np.array([1.0, 0.8, 0.6, 0.4]),
              decay_rates=np.arange(1, 5) / (200.0 * 86400.0))
FORCED_SOLVER = dict(krylov_rel_tol=1e-2, newton_max_iter=8,
                     krylov_max_dim=10)


def _column_depth(nlev=12):
    return spatial_axis_from_defn_dict(
        defn_dict=spatial_axis_defn_dict(
            nlevs=nlev, edge_end=4000.0, delta_ratio_max=19.0
        )
    )


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _solve(solver, x0):
    x, fcn, info = solver.solve(x0)
    return _np(x), info


def _assert_match(ours, ref):
    (x_o, info_o), (x_r, info_r) = ours, ref
    assert info_o["iterations"] == info_r["iterations"]
    assert np.abs(x_o - x_r).max() <= X_TOL * max(np.abs(x_r).max(), 1e-300)
    assert len(info_o["stats"]) == len(info_r["stats"])
    for s_o, s_r in zip(info_o["stats"], info_r["stats"]):
        assert s_o["iteration"] == s_r["iteration"]
        assert np.allclose(s_o["fcn_norm"], s_r["fcn_norm"], rtol=STATS_RTOL)
        assert np.allclose(s_o["x_norm"], s_r["x_norm"], rtol=STATS_RTOL)


def _three_solves(tk, jk, **settings):
    """(port fused, port host, JAX fused) solves from the initial iterates;
    the host-driven Newton loop runs the fused GMRES, as the JAX test's
    does, so the two Newton loops see the same increments"""
    fused = _solve(NewtonKrylovInCore(tk, jit_newton=True, **settings),
                   tk.init_iterate())
    host = _solve(NewtonKrylovInCore(tk, jit_gmres=True, **settings),
                  tk.init_iterate())
    ref = _solve(JaxNewtonKrylovInCore(jk, jit_newton=True, **settings),
                 jk.init_iterate())
    return fused, host, ref


def test_fused_matches_host_and_jax_dye_decay_family():
    """a linear batched column family, decay rates 1, 2 and 4 a year (the
    kernel's unit; rates a year smaller than 1e-7 leave I - B so close to
    singular that the two frameworks' roundings part at 1e-7)"""
    depth = _column_depth()
    rates = np.array([1.0, 2.0, 4.0])
    settings = dict(newton_rel_tol=1e-6, krylov_rel_tol=1e-3,
                    newton_max_iter=6, krylov_max_dim=15)
    fused, host, ref = _three_solves(
        DyeDecayFamilyKernel(depth, rates, device=CPU, n_steps=365),
        JaxDyeDecayFamilyKernel(depth, rates, n_steps=365), **settings)
    _assert_match(fused, host)
    _assert_match(fused, ref)
    assert fused[1]["iterations"] >= 1
    assert np.array_equal(fused[1]["krylov_iterations"],
                          ref[1]["krylov_iterations"])
    assert np.array_equal(fused[1]["krylov_iterations"],
                          host[1]["krylov_iterations"])


def test_fused_matches_host_and_jax_multi_region():
    """per-(module, region) convergence masks: column regions decouple and
    every block converges on its own"""
    nz, ny = 10, 4
    mask = np.broadcast_to(np.arange(1, ny + 1, dtype=np.int32),
                           (nz, ny)).copy()
    depth, ypos = build_axes(nz, ny)
    still = {"max_abs_vvel": "0.0", "horiz_mix_coeff": "0.0"}
    weight = np.outer(depth.delta, ypos.delta)
    jk = JaxIageKernel(depth, ypos, still, dtype=jnp.float64, n_steps=365,
                       region_mask=mask, grid_weight=weight, use_pallas=False)
    grid = grid_from_numpy({k: np.asarray(v) for k, v in jk.grid._asdict().items()},
                           device=CPU, dtype=torch.float64)
    tk = IageKernel(depth, ypos, still, device=CPU, dtype=torch.float64,
                    n_steps=365, region_mask=mask, grid_weight=weight,
                    grid=grid)
    assert tk.region_cnt == ny
    fused, host, ref = _three_solves(
        tk, jk, newton_rel_tol=1e-5, krylov_rel_tol=1e-3, newton_max_iter=8,
        krylov_max_dim=20)
    _assert_match(fused, host)
    _assert_match(fused, ref)


def _forced_pair():
    depth, ypos = build_axes(NZ, NY)
    tm = mesh.make_mesh(1, 2, devices=["cpu"] * 2)
    jm = jax_mesh.make_mesh(1, 2, devices=jax.devices()[:2])
    return (ShardedForcedFamilyKernel(tm, depth, ypos, MODELINFO,
                                      n_steps=N_STEPS, region_mask=REGIONS,
                                      **FORCED),
            jax_sharded.ShardedForcedFamilyKernel(
                jm, depth, ypos, MODELINFO, dtype=jnp.float64,
                n_steps=N_STEPS, region_mask=REGIONS, **FORCED))


def test_fused_matches_host_and_jax_forced_family_limiter():
    """the bounded forced family on a (1, 2) CPU mesh: the lob-0 limiter's
    traced twin scales the first increment and Armijo runs on the
    device; the port's fused solve gives the host path's and the JAX fused
    solve's iterates, and the JAX solve's limiter and Armijo factors"""
    tk, jk = _forced_pair()
    fused, host, ref = _three_solves(tk, jk, newton_rel_tol=1e-5,
                                     **FORCED_SOLVER)
    _assert_match(fused, host)
    _assert_match(fused, ref)
    scalef = fused[1]["limiter_scalef"]
    assert scalef.min() < 1.0  # the limiter bound this solve
    assert np.allclose(scalef, ref[1]["limiter_scalef"], rtol=1e-8, atol=0.0)
    assert np.allclose(fused[1]["armijo_factor"], ref[1]["armijo_factor"],
                       rtol=0.0, atol=0.0)
    # the post-Newton fixed-point update is unlimited: it may undershoot
    # the bound by the host limiter's tolerance, no more
    assert fused[0].min() > -1e-5 * np.abs(fused[0]).max()


def test_armijo_failure_parity():
    """past the rounding floor (newton_rel_tol 1e-6) every Armijo trial
    fails: the fused port, the host port and the JAX fused solve raise the
    same error after the same stats"""
    tk, jk = _forced_pair()
    runs = ((NewtonKrylovInCore(tk, jit_newton=True, newton_rel_tol=1e-6,
                                **FORCED_SOLVER), tk.init_iterate()),
            (NewtonKrylovInCore(tk, jit_gmres=True, newton_rel_tol=1e-6,
                                **FORCED_SOLVER), tk.init_iterate()),
            (JaxNewtonKrylovInCore(jk, jit_newton=True, newton_rel_tol=1e-6,
                                   **FORCED_SOLVER), jk.init_iterate()))
    stats = []
    for solver, x0 in runs:
        with pytest.raises(RuntimeError, match="Armijo_ind exceeds limit"):
            solver.solve(x0)
        stats.append(solver.stats)
    assert len(stats[0]) == len(stats[1]) == len(stats[2]) >= 2
    for ours, host, ref in zip(*stats):
        assert ours["iteration"] == host["iteration"] == ref["iteration"]
        assert np.allclose(ours["fcn_norm"], ref["fcn_norm"],
                           rtol=STATS_RTOL)
        assert np.allclose(ours["fcn_norm"], host["fcn_norm"],
                           rtol=STATS_RTOL)


def test_traced_limiter_matches_host_comp_scalef_lob():
    """the device lob-0 limiter against the host comp_scalef_lob factors
    and the JAX twin, on states whose increments cross the bound"""
    tk, jk = _forced_pair()
    rng = np.random.default_rng(0)
    shape = tuple(tk.init_iterate().shape)
    x = rng.uniform(0.1, 1.0, shape)
    inc = rng.uniform(-0.5, 0.2, shape)
    ours = _np(tk.limiter_scalef_jit(torch.as_tensor(x), torch.as_tensor(inc)))
    host = tk.apply_limiter(torch.as_tensor(x), torch.as_tensor(inc))
    direct = np.stack([comp_scalef_lob(tk.region_cnt, REGIONS, x[b, 0],
                                       inc[b, 0], 0.0)
                       for b in range(shape[0])])
    ref = np.asarray(jax.jit(jk.limiter_scalef_jit)(jnp.asarray(x),
                                                    jnp.asarray(inc)))
    assert ours.shape == (tk.module_batch, tk.region_cnt)
    assert host.min() < 1.0  # the draw crosses the bound
    assert np.allclose(ours, host, rtol=1e-12, atol=0.0)
    assert np.allclose(ours, direct, rtol=1e-12, atol=0.0)
    assert np.allclose(ours, ref, rtol=1e-12, atol=0.0)
    # an increment that keeps the state feasible: exactly ones
    ones = _np(tk.limiter_scalef_jit(torch.as_tensor(x),
                                     torch.as_tensor(np.abs(inc))))
    assert (ones == 1.0).all()
    # the linear kernels' twin is a no-op on the device
    iage = IageKernel(*build_axes(6, 4), MODELINFO, device=CPU,
                      dtype=torch.float64, n_steps=24)
    assert not hasattr(iage, "limiter_scalef_jit")


def test_fused_max_iter_error_parity():
    """the fused path raises the host path's Newton overrun error, with
    the same stats"""
    depth = _column_depth()
    kernel = DyeDecayFamilyKernel(depth, np.array([1.0]) / YEAR, device=CPU,
                                  n_steps=96)
    stats = []
    for jit_newton in (False, True):
        solver = NewtonKrylovInCore(
            kernel, newton_rel_tol=1e-14, newton_max_iter=0,
            jit_gmres=not jit_newton, jit_newton=jit_newton,
        )
        with pytest.raises(RuntimeError, match="maximum Newton iterations"):
            solver.solve(kernel.init_iterate())
        stats.append(solver.stats)
    assert len(stats[0]) == len(stats[1]) == 1
    assert np.allclose(stats[0][0]["fcn_norm"], stats[1][0]["fcn_norm"],
                       rtol=STATS_RTOL)


def test_fused_rejects_checkpoint_dir(tmp_path):
    kernel = DyeDecayFamilyKernel(_column_depth(), np.array([1.0e-8]),
                                  device=CPU, n_steps=8)
    solver = NewtonKrylovInCore(kernel, jit_newton=True)
    with pytest.raises(ValueError, match="host-driven"):
        solver.solve(kernel.init_iterate(), checkpoint_dir=str(tmp_path))
