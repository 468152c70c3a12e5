"""the port's sharded py_driver_2d family path against the JAX package's:
B3's plain step block against the JAX B3 in interpret mode, the per-step
and blocked sharded years on CPU meshes, the ShardedIage and
ShardedForcedFamily kernels hook by hook, a small solve in both packages,
and the sharded spin-up CLI.  JAX runs as its own tests run it: on the CPU,
x64 on, 8 virtual devices (tests/conftest.py)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.ops import imex_pallas  # noqa: E402
from newton_krylov_ooc_tpu.parallel import mesh as jax_mesh  # noqa: E402
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_year as jax_sharded,
)
from newton_krylov_ooc_tpu_torch.cli import sharded_spinup  # noqa: E402
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import (  # noqa: E402
    NewtonKrylovInCore,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (  # noqa: E402
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.ops import imex_block_cuda  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel import mesh, sharded_year  # noqa: E402

torch.set_num_threads(1)

YEAR = 365.0 * 86400.0
F64_TOL = 1e-12   # relative: the same float64 arithmetic on both sides
PC_TOL = 1e-10    # relative: LU solves in another summation order
# relative to max|y|: float32 rounding in another order; an ulp of the
# mixing profile grows ~1e3-fold through its exponential (the JAX test's
# bound for its own 8-shard against 1-shard blocked years)
F32_TOL = 5e-5
CPU = torch.device("cpu")
STATE = P("module", None, None, "space")


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


def _iage_inputs(nz, ny, batch, dtype):
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((batch, 2, nz, ny), dtype)
    diag[:, 0, 0, :] = -rate
    diag[:, 1, 0, :] = -SURF_SLOW_FACTOR * rate
    return depth, ypos, diag


# -- the mesh -----------------------------------------------------------------


def test_mesh_shapes_devices_and_blocks():
    m = _torch_mesh(2, 4)
    assert m.shape == {"module": 2, "space": 4}
    assert m.first_device == CPU and len(m.devices) == 2
    assert mesh.make_mesh(2, devices=["cpu"] * 8).shape["space"] == 4
    with pytest.raises(ValueError, match="device count"):
        mesh.make_mesh(2, 3, devices=["cpu"] * 8)

    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 2, 3, 8)))
    blocks = mesh.shard_state(m, x)
    assert blocks[1][2].shape == (2, 2, 3, 2)
    assert torch.equal(blocks[1][2], x[2:, ..., 4:6])
    assert blocks[0][0].is_contiguous()
    assert torch.equal(mesh.gather_state(m, blocks), x)
    # the blocks never alias the state, even on a (1, 1) mesh
    one = mesh.shard_state(_torch_mesh(1, 1), x)
    one[0][0].zero_()
    assert float(x.abs().max()) > 0.0
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_state(m, x[:, ..., :7])

    assert mesh.mesh_devices("cpu", 4, 4) == [CPU] * 4
    with pytest.raises(ValueError, match="groups"):
        mesh.mesh_devices("cpu", 4, 3)


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh(1, 1, devices=["cuda"])


# -- B3: the step block -------------------------------------------------------


def _window(source_kind):
    """one (C=4, nz=10, nx=20) window's static arrays, as the blocked year
    packs a shard's: faces zero at the physical edges, restoring diag"""
    c_dim, nz, nx = 4, 10, 20
    depth, ypos = build_axes(nz, nx)
    grid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    vf = np.asarray(grid.vvel, np.float32).copy()
    vf[:, 0] = vf[:, -1] = 0.0
    hf = np.zeros((nz, nx + 1), np.float32)
    hf[:, 1:-1] = np.asarray(grid.horiz_mix_coeff)
    rng = np.random.default_rng(17)
    diag = np.zeros((c_dim, nz, nx), np.float32)
    diag[:, 0, :] = -surf_restore_rate(depth)
    diag -= rng.uniform(0.0, 1e-9, (c_dim, 1, 1)).astype(np.float32)
    if source_kind == "uniform":
        source = rng.uniform(0.5, 2.0, c_dim) / YEAR
    else:
        source = np.zeros((c_dim, nz))
        source[:, 0] = rng.uniform(0.5, 2.0, c_dim) / (10.0 * 86400.0)
    bld_max = np.interp(np.asarray(grid.ypos_mid, np.float64),
                        jax_physics._BLD_YPOS, jax_physics._BLD_MAX)
    args = (vf, hf, np.asarray(grid.wvel), diag, source, bld_max,
            np.asarray(grid.dy_r), np.asarray(grid.dz_r),
            np.asarray(grid.dz_mid), np.asarray(grid.dz_mid_r),
            np.asarray(grid.depth_mid))
    y0 = rng.uniform(0.0, 2.0, (c_dim, nz, nx)).astype(np.float32)
    c0 = rng.uniform(-1e-7, 1e-7, (c_dim, nz, nx)).astype(np.float32)
    return args, y0, c0


@pytest.mark.parametrize("source_kind", ["uniform", "profile"])
def test_pack_block_consts_matches_jax(source_kind):
    args, _, _ = _window(source_kind)
    ours = imex_block_cuda.pack_block_consts(*args)
    ref = imex_pallas.pack_block_consts(*args)
    assert len(ours) == len(ref) == 11
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("t_start", [0.0, 1.3e7])
@pytest.mark.parametrize("source_kind", ["uniform", "profile"])
def test_plain_step_block_matches_jax_b3(source_kind, t_start):
    """j = 2 steps on all nx columns, in the shallow season and in the deep
    mixed layer, against the JAX B3 in interpret mode"""
    args, y0, c0 = _window(source_kind)
    dt, j_steps = YEAR / 200, 2
    ref_y, ref_c = imex_pallas.build_iage_step_block_pallas(
        *args, dt, j_steps)(jnp.asarray(y0), jnp.asarray(c0),
                            np.float32(t_start), interpret=True)
    y, c = imex_block_cuda.build_iage_step_block_plain(*args, dt, j_steps)(
        torch.as_tensor(y0), torch.as_tensor(c0), t_start)
    assert y.shape == c.shape == y0.shape and y.dtype == torch.float32
    assert _rel(y, ref_y) < F32_TOL
    assert _rel(y + c, np.asarray(ref_y) + np.asarray(ref_c)) < F32_TOL
    assert _rel(y, y0) > 1e-3  # the block moved y
    # the wrapper on the CPU is the plain version
    y_w, c_w = imex_block_cuda.build_iage_step_block(
        *args, dt, j_steps, device="cpu")(torch.as_tensor(y0),
                                          torch.as_tensor(c0), t_start)
    assert torch.equal(y_w, y) and torch.equal(c_w, c)


def test_step_block_refuses_what_it_cannot_take():
    args, y0, c0 = _window("uniform")
    with pytest.raises(ValueError, match="j_steps"):
        imex_block_cuda.build_iage_step_block(*args, 100.0, 0, device="cpu")
    block = imex_block_cuda.build_iage_step_block(*args, 100.0, 1,
                                                  device="cpu")
    y, c = torch.as_tensor(y0), torch.as_tensor(c0)
    for bad in (y.double(), y[:2], y.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError):
            block(bad, c, 0.0)
    with pytest.raises(TypeError):
        block(y0, c, 0.0)


def test_block_plan_tiles_and_splits():
    """B3's launch layout: the narrowest tiles (at least 16 columns) whose
    blocks all fit on the card at once, and the most steps between halo
    exchanges whose halo is at most half a tile and whose region fits a
    block's shared memory"""
    def smem(nz, width):  # csrc/iage_block.cu's count
        area = nz * (width | 1)  # an odd row pitch
        lanes = 1
        while 32 * lanes < nz:
            lanes *= 2
        cols = 16 * 32 * (lanes + 1 if lanes > 1 else 1)  # warps' buffers
        return 4 * (2 * area + max(2 * area, cols) + 2 * width + 3 * nz
                    + 2 * (nz - 1))

    limit = 232448  # one H100 block's opt-in shared memory

    def h100(smem_bytes):  # one block an SM (512 threads) on 132 SMs
        return 132

    plan = imex_block_cuda.block_plan
    # phase 10's (1, 1) and (1, 4) meshes: 8 channels of 24 levels
    assert plan(smem, limit, 24, [48], 8, 8, h100) == (4, 16)
    assert plan(smem, limit, 24, [12] * 4, 8, 4, h100) == (3, 12)
    # the bench's million-cell year: one wave of 130 tiles at 256 levels
    j_int, tile = plan(smem, limit, 256, [2000], 2, 8, h100)
    assert (j_int, tile) == (6, 31)
    assert 2 * -(-2000 // tile) <= 132 and smem(256, tile + 4 * j_int) <= limit
    assert smem(256, tile + 4 * (j_int + 1)) > limit
    j_int, tile = plan(smem, limit, 128, [2032], 1, 8, h100)
    assert (j_int, tile) == (4, 16) and smem(128, tile + 4 * j_int) <= limit
    # a tile narrower than its halo's reach takes one step an interval
    assert plan(smem, limit, 10, [4, 4], 2, 2, h100) == (1, 4)
    with pytest.raises(ValueError, match="shared memory"):
        plan(smem, limit, 2000, [100], 1, 8, h100)
    with pytest.raises(ValueError, match="at once"):
        plan(smem, limit, 24, [48] * 20, 8, 8, lambda smem_bytes: 100)


def test_tile_table_covers_every_slab_column():
    tiles = imex_block_cuda.tile_table([40, 12], 2, 16)
    assert tiles.dtype == np.int32 and tiles.shape == (2 * 3 + 2 * 1, 4)
    assert tiles[:3].tolist() == [[0, 0, 0, 16], [0, 0, 16, 32],
                                  [0, 0, 32, 40]]
    assert tiles[-1].tolist() == [1, 1, 0, 12]


@pytest.mark.parametrize("keys, expect", [
    # every shard of one card: one group, no ghosts
    ([["a", "a"], ["a", "a"]],
     [("a", [((0, 0), None, 0, -1, 1), ((0, 1), None, 0, 0, -1),
             ((1, 0), None, 0, -1, 3), ((1, 1), None, 0, 2, -1)])]),
    # two cards of two shards each: a ghost slab beside each inner edge
    ([["a", "a", "b", "b"]],
     [("a", [((0, 0), None, 0, -1, 1), ((0, 1), None, 0, 0, 2),
             ((0, 1), (0, 2), 1, 1, -1)]),
      ("b", [((0, 2), (0, 1), -1, -1, 1), ((0, 2), None, 0, 0, 2),
             ((0, 3), None, 0, 1, -1)])]),
    # a group a shard
    ([[0, 1, 2]],
     [(0, [((0, 0), None, 0, -1, 1), ((0, 0), (0, 1), 1, 0, -1)]),
      (1, [((0, 1), (0, 0), -1, -1, 1), ((0, 1), None, 0, 0, 2),
           ((0, 1), (0, 2), 1, 1, -1)]),
      (2, [((0, 2), (0, 1), -1, -1, 1), ((0, 2), None, 0, 0, -1)])]),
])
def test_slab_layout_groups_shards_by_device(keys, expect):
    """the blocked year's launch groups: shards grouped by key, each
    group's neighbour table, ghost slabs where a neighbour is in another
    group"""
    groups = sharded_year.slab_layout(keys)
    assert [(key, [tuple(sl) for sl in slabs]) for key, slabs in groups] \
        == expect


# -- the sharded years --------------------------------------------------------


def test_per_step_year_matches_jax():
    """the (2, 4) per-step year against JAX's build_sharded_year on its
    (2, 4) mesh, float64"""
    nz, ny, batch, n_steps = 10, 8, 4, 48
    depth, ypos, diag = _iage_inputs(nz, ny, batch, np.float64)
    aging = np.broadcast_to(
        ((1.0 + 0.2 * np.arange(batch)) / YEAR)[:, None, None, None],
        (batch, 2, 1, 1))
    y0 = np.maximum(np.random.default_rng(7).normal(
        1.0, 0.5, (batch, 2, nz, ny)), 0.0)

    jm = _jax_mesh(2, 4)
    ref_year = jax_sharded.build_sharded_year(
        jm, jax_sharded.ShardedYearData(depth, ypos, MODELINFO, n_space=4),
        diag, aging, (0.0, YEAR), n_steps)
    ref = ref_year(jax.device_put(jnp.asarray(y0), NamedSharding(jm, STATE)))

    tm = _torch_mesh(2, 4)
    year = sharded_year.build_sharded_year(
        tm, sharded_year.ShardedYearData(depth, ypos, MODELINFO, n_space=4),
        diag, aging, (0.0, YEAR), n_steps)
    out = year(torch.as_tensor(y0))
    assert out.dtype == torch.float64 and out.device == CPU
    assert _rel(out, ref) < F64_TOL


@pytest.fixture(scope="module")
def blocked_case():
    """JAX's test_sharded_pallas_year_blocked inputs and its (2, 4) year"""
    nz, ny, batch, n_steps, k = 10, 16, 4, 25, 2
    depth, ypos, diag = _iage_inputs(nz, ny, batch, np.float32)
    aging = np.broadcast_to(
        ((1.0 + 0.2 * np.arange(batch)) / YEAR)[:, None], (batch, 2)
    ).astype(np.float32)
    column = np.interp(depth.mid, [55.0, 200.0], [0.0, 2.0])
    y0 = (np.broadcast_to(column[None, None, :, None], (batch, 2, nz, ny))
          + np.random.default_rng(3).uniform(0, 0.3, (batch, 2, nz, ny))
          ).astype(np.float32)
    args = (depth, ypos, MODELINFO, diag, aging, (0.0, YEAR), n_steps)
    jm = _jax_mesh(2, 4)
    ref = np.asarray(jax_sharded.build_sharded_year_pallas(
        jm, *args, block_steps=k, interpret=True)(
            jax.device_put(jnp.asarray(y0), NamedSharding(jm, STATE))))
    return args, k, y0, ref


def test_blocked_year_matches_jax_b3(blocked_case):
    """the (2, 4) blocked year on B3's plain version against JAX's
    build_sharded_year_pallas in interpret mode on (2, 4), and against the
    port's own (1, 1) year"""
    args, k, y0, ref = blocked_case
    out8 = sharded_year.build_sharded_year_blocked(
        _torch_mesh(2, 4), *args, block_steps=k)(torch.as_tensor(y0))
    assert out8.dtype == torch.float32 and out8.shape == y0.shape
    assert _rel(out8, ref) < F32_TOL
    out1 = sharded_year.build_sharded_year_blocked(
        _torch_mesh(1, 1), *args, block_steps=k)(torch.as_tensor(y0))
    assert _rel(out8, out1) < F32_TOL
    # on the CPU the blocked year is B3's plain version
    plain = sharded_year.build_sharded_year_blocked_plain(
        _torch_mesh(2, 4), *args, block_steps=k)(torch.as_tensor(y0))
    assert torch.equal(plain, out8)


def test_blocked_year_depth_profile_source_matches_per_step():
    """the forced family's (B, T, nz) source rides the blocked year: one
    year against the per-step float32 year of the same family"""
    nz, ny, n_steps = 8, 8, 25
    depth, ypos = build_axes(nz, ny)
    kw = dict(restore_rate=1.0 / (10.0 * 86400.0),
              restore_targets=[1.0, 0.5],
              decay_rates=np.array([1.0, 2.0]) / (200.0 * 86400.0),
              n_steps=n_steps)
    m = _torch_mesh(2, 2)
    blocked = sharded_year.ShardedForcedFamilyKernel(
        m, depth, ypos, MODELINFO, use_kernel=True, block_steps=2, **kw)
    step = sharded_year.ShardedForcedFamilyKernel(
        m, depth, ypos, MODELINFO, dtype=torch.float32, **kw)
    x0 = step.init_iterate()
    assert _rel(blocked._year(x0), step._year(x0).numpy()) < 1e-4


@pytest.mark.parametrize("case, match", [
    ("halo", "halo depth"),
    ("split", "do not split"),
    ("aging", "aging shape"),
])
def test_blocked_year_refuses_what_jax_refuses(case, match):
    depth, ypos = build_axes(8, 16)
    diag = np.zeros((4, 2, 8, 16), np.float32)
    aging = np.zeros((4, 2), np.float32)
    block_steps, m = 2, (2, 4)
    if case == "halo":
        block_steps = 8
    elif case == "split":
        m = (3, 1)
        diag, aging = diag[:2], aging[:2]
    else:
        aging = np.zeros((4, 3), np.float32)
    args = (depth, ypos, MODELINFO, diag, aging, (0.0, YEAR), 25)
    with pytest.raises(ValueError, match=match):
        jax_sharded.build_sharded_year_pallas(
            _jax_mesh(*m), *args, block_steps=block_steps, interpret=True)
    with pytest.raises(ValueError, match=match):
        sharded_year.build_sharded_year_blocked(
            _torch_mesh(*m), *args, block_steps=block_steps)


# -- the family kernels -------------------------------------------------------

NZ, NY, N_STEPS = 8, 8, 36
RATES = (1.0 + 0.25 * np.arange(4)) / YEAR
# two regions: the upper four levels and the rest
REGIONS = np.where(np.arange(NZ)[:, None] < 4, 1, 2) * np.ones((1, NY),
                                                                np.int32)
FORCED = dict(restore_rate=1.0 / (10.0 * 86400.0),
              restore_targets=np.array([1.0, 0.8, 0.6, 0.4]),
              decay_rates=np.arange(1, 5) / (200.0 * 86400.0))


def _kernel_pair(kind):
    depth, ypos = build_axes(NZ, NY)
    jm, tm = _jax_mesh(2, 4), _torch_mesh(2, 4)
    if kind == "iage":
        return (jax_sharded.ShardedIageKernel(
                    jm, depth, ypos, MODELINFO, RATES, dtype=jnp.float64,
                    n_steps=N_STEPS, region_mask=REGIONS),
                sharded_year.ShardedIageKernel(
                    tm, depth, ypos, MODELINFO, RATES, n_steps=N_STEPS,
                    region_mask=REGIONS))
    return (jax_sharded.ShardedForcedFamilyKernel(
                jm, depth, ypos, MODELINFO, dtype=jnp.float64,
                n_steps=N_STEPS, region_mask=REGIONS, **FORCED),
            sharded_year.ShardedForcedFamilyKernel(
                tm, depth, ypos, MODELINFO, n_steps=N_STEPS,
                region_mask=REGIONS, **FORCED))


@pytest.fixture(scope="module", params=["iage", "forced"])
def kernels(request):
    jk, tk = _kernel_pair(request.param)
    rng = np.random.default_rng(5)
    x = np.asarray(jk.init_iterate()) + rng.uniform(0.0, 0.5,
                                                    tk.init_iterate().shape)
    v = rng.normal(size=x.shape)
    return request.param, jk, tk, x, v


def _put(jk, arr):
    return jax.device_put(jnp.asarray(arr), jk.state_sharding)


def test_kernel_setup_matches_jax(kernels):
    kind, jk, tk, _, _ = kernels
    assert not tk.use_kernel and tk.dtype == torch.float64
    assert tk.region_cnt == jk.region_cnt == 2
    assert tk.module_batch == jk.module_batch == 4
    assert np.array_equal(tk.init_iterate().numpy(),
                          np.asarray(jk.init_iterate()))


def test_kernel_fcn_and_jvp_match_jax(kernels):
    _, jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    fcn = tk.comp_fcn(xt)
    assert _rel(fcn, jk.comp_fcn(_put(jk, x))) < F64_TOL
    assert _rel(tk.jvp(xt, fcn, vt), jk.jvp(None, None, _put(jk, v))) < F64_TOL


def test_kernel_precond_matches_jax(kernels):
    _, jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    ours = tk.precond_apply(tk.precond_setup(xt), vt)
    ref = jk.precond_apply(jk.precond_setup(_put(jk, x)), _put(jk, v))
    assert _rel(ours, ref) < PC_TOL


def test_kernel_reductions_and_limiter_match_jax(kernels):
    kind, jk, tk, x, v = kernels
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    jx, jv = _put(jk, x), _put(jk, v)
    assert _rel(tk.dot(xt, vt), jk.dot(jx, jv)) < F64_TOL
    assert _rel(tk.norm(vt), jk.norm(jv)) < F64_TOL
    factors = np.arange(1.0, 9.0).reshape(4, 2)
    assert _rel(tk.scale(vt, factors), jk.scale(jv, factors)) < F64_TOL
    # an increment that drives part of the state below zero
    inc = -2.0 * np.abs(v) * (v > 0.5)
    ours = tk.apply_limiter(xt, torch.as_tensor(inc))
    ref = jk.apply_limiter(jx, _put(jk, inc))
    assert np.array_equal(ours, np.asarray(ref))
    # the shared zero-lower-bound limiter over the first module's tracers
    lob0 = tk._apply_limiter_lob0(xt, torch.as_tensor(inc))
    assert np.array_equal(lob0, jk._apply_limiter_lob0(jx, _put(jk, inc)))
    assert (lob0 < 1.0).any()
    if kind == "forced":
        assert (ours < 1.0).any()
        with pytest.raises(RuntimeError, match="lower bound"):
            tk.apply_limiter(-xt, torch.as_tensor(inc))


SOLVE_OPTS = dict(newton_rel_tol=1e-5, krylov_rel_tol=1e-2, newton_max_iter=8,
                  krylov_max_dim=20)


@pytest.fixture(scope="module")
def f64_solve():
    """the port's float64 per-step solve on a (2, 2) CPU mesh: (x, info)"""
    depth, ypos = build_axes(NZ, NY)
    tk = sharded_year.ShardedIageKernel(
        _torch_mesh(2, 2), depth, ypos, MODELINFO, RATES, n_steps=N_STEPS)
    x, _, info = NewtonKrylovInCore(tk, **SOLVE_OPTS).solve(tk.init_iterate())
    return x, info


def test_small_solve_matches_jax(f64_solve):
    """8x8, 36 steps, 4 modules: host GMRES in both packages, the port on a
    (2, 2) CPU mesh and JAX on its (2, 2) mesh"""
    depth, ypos = build_axes(NZ, NY)
    jk = jax_sharded.ShardedIageKernel(
        _jax_mesh(2, 2), depth, ypos, MODELINFO, RATES, dtype=jnp.float64,
        n_steps=N_STEPS)
    x_ref, _, info_ref = JaxNewtonKrylovInCore(jk, **SOLVE_OPTS).solve(
        jk.init_iterate())
    x, info = f64_solve
    assert (info["fcn_norm"] < 1e-5 * info["x_norm"]).all()
    assert info["iterations"] == info_ref["iterations"]
    assert _rel(x, x_ref) < 1e-9


def test_blocked_route_solve_matches_per_step_solve(f64_solve):
    """use_kernel on the CPU: the blocked float32 year on B3's plain
    version solves to within 1e-3 of the float64 per-step solve"""
    depth, ypos = build_axes(NZ, NY)
    m = _torch_mesh(2, 2)
    blocked = sharded_year.ShardedIageKernel(
        m, depth, ypos, MODELINFO, RATES, n_steps=N_STEPS, use_kernel=True,
        block_steps=2)
    assert blocked.dtype == torch.float32
    x32, _, info = NewtonKrylovInCore(
        blocked, **dict(SOLVE_OPTS, newton_rel_tol=1e-4)).solve(
            blocked.init_iterate())
    assert (info["fcn_norm"] < 1e-4 * info["x_norm"]).all()
    assert _rel(x32.double(), f64_solve[0].numpy()) < 1e-3
    with pytest.raises(ValueError, match="float32"):
        sharded_year.ShardedIageKernel(m, depth, ypos, MODELINFO, RATES,
                                       dtype=torch.float64, use_kernel=True)


def test_sharded_spinup_cli_converges(capsys):
    kernel, x, fcn, info = sharded_spinup.main(
        ["1", "2", "8", "36", "--device", "cpu", "--block-steps", "2"])
    assert kernel.use_kernel and kernel.mesh.shape == {"module": 1,
                                                        "space": 2}
    assert x.shape == (4, 2, 24, 8) and torch.isfinite(x).all()
    assert (info["fcn_norm"] < 1e-4 * info["x_norm"]).all()
    assert info["f_evals"] >= 1 and info["jvp_evals"] >= 1
    assert "converged" in capsys.readouterr().out


def test_example_grid_krylov_counts_match_jax():
    """the sharded example's 24x48 grid, 4 modules, at 73 steps a year
    (stable: the explicit half needs about 40) in float64 through both
    packages' host GMRES with the example's solver settings: the same
    Newton and Krylov counts, Krylov at its cap of 30 as on the card, and
    iterates within the rounding of a capped GMRES.  So the cap is the
    problem's, not a fault of the port (ROADMAP C)."""
    depth, ypos = build_axes(sharded_spinup.NZ, 48)
    rates = (1.0 + 0.25 * np.arange(4)) / YEAR
    n_steps = 73
    jk = jax_sharded.ShardedIageKernel(
        _jax_mesh(1, 1), depth, ypos, MODELINFO, rates, dtype=jnp.float64,
        n_steps=n_steps)
    jax_solver = JaxNewtonKrylovInCore(jk, **sharded_spinup.SOLVER)
    jax_krylov = []
    gmres = jax_solver._gmres

    def counted(x, fcn):
        # the JAX host loop does not report its Krylov counts: record them
        increment, its = gmres(x, fcn)
        jax_krylov.append(int(its))
        return increment, its

    jax_solver._gmres = counted
    x_ref, _, info_ref = jax_solver.solve(jk.init_iterate())
    tk = sharded_year.ShardedIageKernel(
        _torch_mesh(1, 1), depth, ypos, MODELINFO, rates, n_steps=n_steps)
    x, _, info = NewtonKrylovInCore(tk, **sharded_spinup.SOLVER).solve(
        tk.init_iterate())
    assert info["iterations"] == info_ref["iterations"]
    assert [int(k) for k in info["krylov_iterations"]] == jax_krylov
    assert max(int(k) for k in info["krylov_iterations"]) == 30
    assert (info["fcn_norm"] < 1e-4 * info["x_norm"]).all()
    # a GMRES stopped at its cap keeps the rounding of its Arnoldi basis,
    # which the two packages sum in another order: the iterates part by
    # ~2e-6 of max|x|, 50 times inside the solve's tolerance
    assert _rel(x, x_ref) < 1e-5
    print("krylov counts", jax_krylov, "iterate rel diff", _rel(x, x_ref))
