"""the fused 3D step's host side and B3's deep columns, on the CPU.

pack_selectors (ops/transport3d_stream_cuda.py), the byte a cell from which
the fused step of kernels B5, B6 and B7 reads its upwind3 faces, against
the JAX package's build_transport3d selectors on masks with land, rows at
the latitude edges and grids narrower than the far upwind cell in
longitude (periodic).  Then
B3's plain blocked year at 256 levels from seeded noise against the float64
per-step year: its column solves run in float64, and a float32 one (the TPU
kernel's reciprocal-form PCR, or Thomas) misses the bound by 100x or more
(ROADMAP C)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from newton_krylov_ooc_tpu.ops import transport3d as jax_t3  # noqa: E402
from newton_krylov_ooc_tpu.parallel import mesh as jax_mesh  # noqa: E402
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_year as jax_sharded,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (  # noqa: E402
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.ops import (  # noqa: E402
    transport3d_stream_cuda as t3s,
)
from newton_krylov_ooc_tpu_torch.parallel import sharded_year  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(2)


def _mask(shape, seed, land):
    mask = (np.random.default_rng(seed).uniform(size=shape) > land)
    return mask.astype(np.int32)


@pytest.mark.parametrize("shape, seed, land", [
    ((4, 8, 6), 1, 0.2),     # the JAX tests' grid, scattered land
    ((3, 5, 2), 2, 0.3),     # two longitudes: every far cell wraps
    ((5, 3, 1), 3, 0.0),     # one longitude, all wet: edges only
    ((2, 9, 7), 4, 0.6),     # mostly land
    ((2, 4, 3), 5, 0.25),    # two levels: no top face has both far cells
])
def test_pack_selectors_matches_the_jax_derivation(shape, seed, land):
    """bit b of every cell's byte is the JAX package's selector field b
    (wet, then sel3p_e, sel3n_e, sel3p_n, sel3n_n, sel3p_t, sel3n_t), and
    bit 7 is clear"""
    mask = _mask(shape, seed, land)
    nz, nlat, nlon = shape
    ones = np.ones(shape)
    jax_coef = jax_t3.build_transport3d(
        mask, np.ones(nz), np.ones((nlat, nlon)), uet=ones, vnt=ones,
        wtt=ones, adv_type="upwind3", dtype=jnp.float64)
    packed = t3s.pack_selectors(torch.as_tensor(mask, dtype=torch.float32))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == shape
    bits = packed.numpy()
    for pos, name in enumerate(t3s.SEL_BITS):
        np.testing.assert_array_equal((bits >> pos) & 1,
                                      np.asarray(jax_coef[name]) != 0,
                                      err_msg=name)
    assert not np.any(bits >> len(t3s.SEL_BITS))


def test_pack_selectors_edges_and_wrap():
    """on an all-wet grid the far cells are missing exactly past the
    latitude and depth edges, never in longitude"""
    packed = t3s.pack_selectors(torch.ones((4, 5, 3))).numpy()
    sel = {name: (packed >> pos) & 1 for pos, name in enumerate(t3s.SEL_BITS)}
    assert sel["wet"].all() and sel["sel3p_e"].all() and sel["sel3n_e"].all()
    # sel3p_n: the row below; sel3n_n: two rows up
    assert not sel["sel3p_n"][:, 0].any() and sel["sel3p_n"][:, 1:].all()
    assert not sel["sel3n_n"][:, -2:].any() and sel["sel3n_n"][:, :-2].all()
    # sel3p_t: the level below; sel3n_t: two levels up
    assert not sel["sel3p_t"][-1].any() and sel["sel3p_t"][:-1].all()
    assert not sel["sel3n_t"][:2].any() and sel["sel3n_t"][2:].all()


# -- B3 at 256 levels from a rough state ---------------------------------------

DEEP_TOL = 5e-5  # chip_smoke.py phase 9's rel_err_rough_f64_tenth gate


@pytest.mark.parametrize("ny, n_steps, block_steps", [(32, 300, 8),
                                                      (24, 200, 3)])
def test_blocked_year_deep_columns_from_noise(ny, n_steps, block_steps):
    """B3's plain blocked year at 256 levels and the bench's step (12,615
    a year), source-free, from seeded standard-normal noise, against the
    float64 per-step year, the port's and the JAX package's scan year (the
    reference): within the phase-9 gate relative to max|y| of each.  The
    mixed layer's CN systems have h |M| ~ 6e3 there; float32 column solves
    were 1.4e-3 (Thomas) and 1.5e-2 (PCR) away at 300 steps"""
    nz = 256
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((1, 2, nz, ny), np.float32)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    span = (0.0, n_steps * physics.SEC_PER_YEAR / 12615.0)
    one = make_mesh(1, 1, devices=["cpu"])
    y0 = torch.as_tensor(np.random.default_rng(61).standard_normal(
        (1, 2, nz, ny)), dtype=torch.float32)
    y32 = sharded_year.build_sharded_year_blocked(
        one, depth, ypos, MODELINFO, diag, np.zeros((1, 2), np.float32), span,
        n_steps, block_steps=block_steps)(y0)
    y64 = sharded_year.build_sharded_year(
        one, sharded_year.ShardedYearData(depth, ypos, MODELINFO, 1), diag,
        np.zeros((1, 2, 1, 1)), span, n_steps)(y0.double())
    jm = jax_mesh.make_mesh(1, 1, devices=jax.devices()[:1])
    y_jax = torch.as_tensor(np.array(jax_sharded.build_sharded_year(
        jm, jax_sharded.ShardedYearData(depth, ypos, MODELINFO, n_space=1,
                                        dtype=jnp.float64),
        diag.astype(np.float64), np.zeros((1, 2, 1, 1)), span, n_steps)(
            jax.device_put(jnp.asarray(y0.double().numpy()), NamedSharding(
                jm, P("module", None, None, "space"))))))
    assert y32.dtype == torch.float32 and torch.isfinite(y32).all()
    for ref in (y_jax, y64):
        scale = float(ref.abs().max())
        assert scale > 0.1 * float(y0.abs().max())  # the noise lives on
        assert float((y32.double() - ref).abs().max()) / scale < DEEP_TOL
