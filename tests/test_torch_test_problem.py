"""the port's test_problem column kernels (models/test_problem/incore.py)
against the JAX package's, float64 on the CPU: the year, F, the JVP and the
preconditioner within 1e-12 relative (the same plain IMEX year in two
frameworks), and the batched family spin-up with the fused GMRES in both
packages"""

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
from newton_krylov_ooc_tpu.models.test_problem import (  # noqa: E402
    constants as jax_constants,
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.models.test_problem.incore import (  # noqa: E402
    DyeDecayFamilyKernel as JaxDyeDecayFamilyKernel,
    IageColumnKernel as JaxIageColumnKernel,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.test_problem import (  # noqa: E402
    constants,
    physics,
)
from newton_krylov_ooc_tpu_torch.models.test_problem.incore import (  # noqa: E402
    DyeDecayFamilyKernel,
    IageColumnKernel,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-12        # float64, the same maps through two frameworks
SOLVE_TOL = 1e-10  # a solve's iterates, relative to max|x|


def _depth(nlev):
    return spatial_axis_from_defn_dict(
        defn_dict=spatial_axis_defn_dict(
            nlevs=nlev, edge_end=900.0, delta_ratio_max=5.0
        )
    )


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(name, nlev=16, n_steps=292):
    depth = _depth(nlev)
    if name == "dye_decay":
        rates = np.array([0.05, 0.5, 2.0])
        return (JaxDyeDecayFamilyKernel(depth, rates, n_steps=n_steps),
                DyeDecayFamilyKernel(depth, rates, device=CPU,
                                     n_steps=n_steps))
    return (JaxIageColumnKernel(depth, n_steps=n_steps),
            IageColumnKernel(depth, device=CPU, n_steps=n_steps))


def test_constants_and_mixing_match_jax():
    for name in ("sec_per_year", "year_per_sec", "day_per_sec"):
        assert getattr(constants, name) == getattr(jax_constants, name)
    assert physics.IAGE_PIST_VEL == jax_physics.IAGE_PIST_VEL
    depth = _depth(16)
    grid = physics.column_grid(depth, device=CPU)
    jgrid = jax_physics.column_grid(depth)
    for frac in (0.0, 0.15, 0.3, 0.65, 0.99):
        t = frac * constants.sec_per_year
        tt = torch.tensor(t, dtype=torch.float64)
        assert _rel(physics.mixing_coeff(grid, tt),
                    jax_physics.mixing_coeff(jgrid, t)) < TOL
        assert abs(float(physics.dye_decay_surf_flux(tt))
                   - float(jax_physics.dye_decay_surf_flux(t))) \
            <= TOL * 2.0 * constants.year_per_sec


@pytest.mark.parametrize("name", ["dye_decay", "iage"])
def test_year_fcn_jvp_and_precond_match_jax(name):
    jk, tk = _pair(name)
    rng = np.random.default_rng(4)
    shape = (tk.module_cnt, tk.nlev)
    x = rng.uniform(0.0, 2.0, shape)
    v = rng.normal(size=shape)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    assert _rel(tk._year_fn(xt), jk._year_fn(jx)) < TOL
    fcn = tk.comp_fcn(xt)
    assert _rel(fcn, jk.comp_fcn(jx)) < TOL
    assert _rel(tk.jvp(xt, fcn, vt), jk.jvp(jx, None, jv)) < TOL
    assert _rel(tk.precond_apply(tk.precond_setup(xt), vt),
                jk.precond_apply(jk.precond_setup(jx), jv)) < TOL
    assert _rel(tk.dot(xt, vt), jk.dot(jx, jv)) < TOL
    factors = np.linspace(0.5, 1.5, tk.module_cnt)[:, None]
    assert _rel(tk.scale(vt, factors), jk.scale(jv, factors)) < TOL
    assert _rel(vt * tk.region_broadcast(torch.as_tensor(factors)),
                jv * jk.region_broadcast(jnp.asarray(factors))) < TOL
    assert np.array_equal(tk.init_iterate().numpy(),
                          np.asarray(jk.init_iterate()))
    assert np.array_equal(tk.apply_limiter(None, None),
                          jk.apply_limiter(None, None))


@pytest.mark.parametrize("name, settings", [
    ("dye_decay", dict(newton_rel_tol=1e-6, krylov_rel_tol=1e-3,
                       newton_max_iter=6, krylov_max_dim=25)),
    ("iage", dict(newton_rel_tol=1e-6, krylov_rel_tol=1e-3,
                  newton_max_iter=6)),
])
def test_family_spinup_matches_jax(name, settings):
    """the batched spin-up with the fused GMRES in both packages (the JAX
    tests' settings, at 292 steps a year): the same Newton and Krylov
    counts and iterates, and the port's host-driven GMRES the same"""
    jk, tk = _pair(name)
    x_j, _, info_j = JaxNewtonKrylovInCore(jk, jit_gmres=True,
                                           **settings).solve(jk.init_iterate())
    x_f, _, info_f = NewtonKrylovInCore(tk, jit_gmres=True,
                                        **settings).solve(tk.init_iterate())
    x_h, _, info_h = NewtonKrylovInCore(tk, **settings).solve(
        tk.init_iterate())
    assert info_f["iterations"] == info_j["iterations"] \
        == info_h["iterations"] >= 1
    assert np.array_equal(info_f["krylov_iterations"],
                          info_h["krylov_iterations"])
    assert _rel(x_f, x_j) < SOLVE_TOL
    assert _rel(x_h, x_j) < SOLVE_TOL
    rel = info_f["fcn_norm"] / np.maximum(info_f["x_norm"], 1e-300)
    assert (rel < settings["newton_rel_tol"]).all()
    if name == "dye_decay":
        # the column inventory falls with the decay rate
        inv = (x_f.numpy() * np.asarray(tk.depth.delta)).sum(axis=1)
        assert (np.diff(inv) < 0).all()
    else:
        age = x_f.numpy()[0]
        assert abs(age[0]) < 0.05 and age[-1] > age[0]
