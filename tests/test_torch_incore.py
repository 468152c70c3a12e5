"""the port's IageKernel against the JAX package's, hook by hook, float64,
on the 10x6 grid with 2 regions"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel as JaxIageKernel,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel,
)

torch.set_num_threads(1)

NZ, NY, N_STEPS = 10, 6, 146
TOL = 1e-10  # relative, float64: the same maps, two routes at most
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def kernels():
    depth, ypos = build_axes(NZ, NY)
    region_mask = np.where(np.arange(NZ)[:, None] < 4, 1, 2) * np.ones(
        (1, NY), np.int32
    )
    jk = JaxIageKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                       n_steps=N_STEPS, region_mask=region_mask,
                       use_pallas=False)
    grid = grid_from_numpy(
        {k: np.asarray(v) for k, v in jk.grid._asdict().items()},
        device=CPU, dtype=torch.float64,
    )
    tk = IageKernel(depth, ypos, MODELINFO, device=CPU, dtype=torch.float64,
                    n_steps=N_STEPS, region_mask=region_mask, grid=grid)
    rng = np.random.default_rng(5)
    x = np.asarray(jk.init_iterate()) + rng.uniform(0.0, 1.0, (2, NZ, NY))
    v = rng.normal(size=(2, NZ, NY))
    return jk, tk, x, v


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_dispatch_and_init_iterate(kernels):
    jk, tk, _, _ = kernels
    assert not tk.use_kernel  # float64 on the CPU: the plain year
    assert tk.region_cnt == jk.region_cnt == 2
    assert np.array_equal(tk.init_iterate().numpy(), np.asarray(jk.init_iterate()))
    assert np.array_equal(tk.apply_limiter(None, None), jk.apply_limiter(None, None))


def test_comp_fcn_and_jvp_match_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    fcn = tk.comp_fcn(xt)
    assert _rel(fcn, jk.comp_fcn(jnp.asarray(x))) < TOL
    # the port's year_src0(v) - v against JAX's forward-mode jax.jvp
    ref = jk.jvp(jnp.asarray(x), None, jnp.asarray(v))
    assert _rel(tk.jvp(xt, fcn, vt), ref) < TOL


def test_reductions_and_scaling_match_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    assert tk.dot(xt, vt).shape == (1, 2)
    assert _rel(tk.dot(xt, vt), jk.dot(jx, jv)) < TOL
    assert _rel(tk.norm(vt), jk.norm(jv)) < TOL
    factors = np.array([[0.5, -3.0]])
    assert _rel(tk.scale(vt, factors), jk.scale(jv, factors)) < TOL
    assert _rel(tk.scale(vt, 2.5), jk.scale(jv, 2.5)) < TOL
    assert _rel(tk.region_broadcast(factors), jk.region_broadcast(jnp.asarray(factors))) < TOL
    coeff = np.array([[[1.0, 2.0]], [[-0.5, 0.25]]])
    assert _rel(tk.lin_comb([xt, vt], coeff), jk.lin_comb([jx, jv], coeff)) < TOL


def test_preconditioner_matches_jax(kernels):
    jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    ours = tk.precond_apply(tk.precond_setup(xt), vt)
    ref = jk.precond_apply(jk.precond_setup(jnp.asarray(x)), jnp.asarray(v))
    assert _rel(ours, ref) < TOL
