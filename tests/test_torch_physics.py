"""the port's py_driver_2d physics against the JAX package's, float64, on
the 8x6 test grid and a 30x30 grid"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)

TOL = 1e-13  # relative: the same float64 formulas, reordered at most
CPU = torch.device("cpu")
GRIDS = [(8, 6), (30, 30)]
TIMES = [0.0, 0.1, 0.3, 0.5, 0.7, 0.99, 1.0]  # fractions of a year


def _grids(nz, ny):
    depth, ypos = build_axes(nz, ny)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float64)
    tgrid = physics.make_grid(depth, ypos, MODELINFO, device=CPU,
                              dtype=torch.float64)
    return jgrid, tgrid


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("nz, ny", GRIDS)
def test_make_grid_and_carry_are_bitwise(nz, ny):
    jgrid, tgrid = _grids(nz, ny)
    fields = {k: np.asarray(v) for k, v in jgrid._asdict().items()}
    carried = grid_from_numpy(fields, device=CPU, dtype=torch.float64)
    for name in physics.Grid2D._fields:
        ours = getattr(tgrid, name).numpy()
        assert np.array_equal(ours, fields[name]), name
        assert np.array_equal(getattr(carried, name).numpy(), ours), name
    assert physics.explicit_dt_bound(tgrid) == jax_physics.explicit_dt_bound(
        jgrid
    )
    x = np.arange(12.0).reshape(2, 2, 3)
    assert np.array_equal(
        state_from_numpy(x, device=CPU, dtype=torch.float64).numpy(), x
    )
    with pytest.raises(ValueError):
        grid_from_numpy({"dz_r": fields["dz_r"]}, device=CPU,
                        dtype=torch.float64)


def test_interp_extrapolates_flat_like_numpy():
    xp, fp = jax_physics._BLD_YPOS, jax_physics._BLD_MAX
    x = np.linspace(-1e6, 3e6, 401)
    ours = physics.interp(torch.as_tensor(x), xp, fp).numpy()
    assert _rel(ours, np.interp(x, xp, fp)) < TOL


@pytest.mark.parametrize("nz, ny", GRIDS)
@pytest.mark.parametrize("frac", TIMES)
def test_vert_mixing_coeff_matches_jax(nz, ny, frac):
    jgrid, tgrid = _grids(nz, ny)
    t = frac * physics.SEC_PER_YEAR
    ours = physics.vert_mixing_coeff(tgrid, t).numpy()
    assert _rel(ours, jax_physics.vert_mixing_coeff(jgrid, t)) < TOL


@pytest.mark.parametrize("nz, ny", GRIDS)
def test_tendencies_match_jax(nz, ny):
    jgrid, tgrid = _grids(nz, ny)
    rng = np.random.default_rng(nz * ny)
    v = rng.normal(1.0, 0.5, (2, nz, ny))
    kv = np.array(jax_physics.vert_mixing_coeff(jgrid, 0.4 * physics.SEC_PER_YEAR))
    vt, kvt = torch.as_tensor(v), torch.as_tensor(kv)
    for ours, ref in [
        (physics.advection_tend(tgrid, vt),
         jax.vmap(lambda f: jax_physics.advection_tend(jgrid, f))(v)),
        (physics.horiz_mix_tend(tgrid, vt),
         jax.vmap(lambda f: jax_physics.horiz_mix_tend(jgrid, f))(v)),
        (physics.vertical_jac(tgrid, kvt),
         jax_physics.vertical_jac(jgrid, jnp.asarray(kv))),
    ]:
        assert ours.shape == ref.shape
        assert _rel(ours.numpy(), ref) < TOL


@pytest.mark.parametrize("nz, ny", GRIDS)
def test_transport_jac_matches_jax(nz, ny):
    jgrid, tgrid = _grids(nz, ny)
    lateral = physics.lateral_jac_const(tgrid)
    assert np.array_equal(lateral.numpy(), jax_physics.lateral_jac_const(jgrid))
    for frac in (0.2, 0.6):
        t = frac * physics.SEC_PER_YEAR
        ref = np.asarray(jax_physics.transport_jac(jgrid, t))
        assert _rel(physics.transport_jac(tgrid, t).numpy(), ref) < TOL
