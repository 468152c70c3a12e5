"""the port's blocked latitude-sharded 3D year and its B1v1 iage year
against the JAX package, on the CPU: kernel B7's plain version
(ops/transport3d_block_cuda.py::block3d_steps_plain) against JAX's
build_block3d_steps in interpret mode on a seeded window; the blocked
year (parallel/sharded_transport3d.py::build_sharded_transport3d_year_blocked)
on CPU meshes against JAX's float64 scan year and JAX's pallas block year;
every refusal in JAX's words; block_schedule's tiles and launches; and the
B1v1 wrapper's
CPU year against JAX's build_iage_year_pallas in interpret mode.

A port mesh of CPU shards is make_mesh(1, n, devices=["cpu"] * n); the JAX
side runs on the 8 virtual CPU devices of tests/conftest.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from newton_krylov_ooc_tpu.models.irf_offline import (  # noqa: E402
    synthetic as jax_synthetic,
)
from newton_krylov_ooc_tpu.models.py_driver_2d import (  # noqa: E402
    physics as jax_physics,
)
from newton_krylov_ooc_tpu.ops import transport3d as jax_t3  # noqa: E402
from newton_krylov_ooc_tpu.ops.imex import imex_year as jax_imex_year  # noqa: E402
from newton_krylov_ooc_tpu.ops.imex_pallas import (  # noqa: E402
    build_iage_year_pallas,
)
from newton_krylov_ooc_tpu.ops.transport3d_block_pallas import (  # noqa: E402
    build_block3d_steps as jax_block3d_steps,
)
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_transport3d as jax_st3,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.models.irf_offline.convert import (  # noqa: E402
    coef_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d import physics  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.iage import (  # noqa: E402
    SURF_SLOW_FACTOR,
    surf_restore_rate,
)
from newton_krylov_ooc_tpu_torch.ops import imex_cuda  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import transport3d_block_cuda as b7  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops.transport3d_cuda import _cn_bands  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel import (  # noqa: E402
    sharded_transport3d as st3,
)

torch.set_num_threads(1)

NZ, NLAT, NLON, T = 4, 8, 6, 2
N_STEPS = 480  # inside the synthetic circulation's explicit bound
YEAR = 365.0 * 86400.0
SPAN = (0.0, YEAR)
# the kernel-level window: a 16-row grid, lane-padded to 128 for JAX
WIN_ROWS = 16
LANES = 128
# block3d_steps_plain against JAX's kernel in interpret mode, relative to
# max|y|: on the seeded rough window one step moves y by O(1), and each
# float32 version lies about 4e-6 from the same steps in float64 (the two
# differ in the PCR form and the order of a few sums); measured under 4e-6
# between them over the cases below
BLOCK_TOL = 1e-5
# the JAX test's bound for its float32 block year against the float64 scan
YEAR_TOL = 2e-5
SHARD_TOL = 1e-6  # 2 shards against 1 (JAX's contract, exact here)
IAGE_TOL = 5e-5   # the JAX v1/v2 bound (tests/test_imex_pallas.py:92)
# the dic/dic14 pair of the JAX slow test (tests/test_sharded_transport3d.py)
ABIO_SPECS = [
    {"name": "dic", "sink_rate_per_year": 0.02,
     "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0,
     "surf_flux_d": {"dic14": 1.5e-4}},
    {"name": "dic14", "source_per_year": 1.0e-3},
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _port_mesh(n):
    return port_mesh.make_mesh(1, n, devices=["cpu"] * n)


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), ("space",))


def _circ(nz, nlat, nlon):
    mask = np.ones((nz, nlat, nlon), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = jax_synthetic.gen_circulation(nz, nlat, nlon, mask=mask)
    jc = jax_t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"])
    kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
    jc = {k: None if v is None else np.asarray(v) for k, v in jc.items()}
    return circ, jc, kv, np.asarray(dz_r), (mask > 0).astype(np.float64)


@pytest.fixture(scope="module")
def problem():
    """the JAX tests' toy year (tests/test_sharded_transport3d.py:35-54),
    its coupled dic/dic14 variant, and JAX's float64 scan year of each"""
    circ, jc, kv, dz_r, wet = _circ(NZ, NLAT, NLON)
    rng = np.random.default_rng(9)
    diag = -rng.uniform(0.0, 1.0e-7, (T, NZ, NLAT, NLON)) * wet
    src = rng.uniform(0.0, 1.0e-8, (T, NZ, NLAT, NLON)) * wet
    y0 = rng.uniform(0.0, 1.0, (T, NZ, NLAT, NLON)) * wet
    a_diag, a_src, couple = jax_t3.assemble_rate_fields(
        ABIO_SPECS, wet.reshape(NZ, -1), float(circ["dz"][0]), YEAR)
    a_diag, a_src, couple = (np.asarray(a) for a in (a_diag, a_src, couple))

    def scan(diag2, src2, couple=None):
        src_j = jnp.asarray(src2)
        wet_surf = jnp.asarray(wet[0].reshape(-1))

        def tend(t, y):
            y3 = y.reshape(y.shape[:-1] + (NLAT, NLON))
            out = jax_t3.transport_tend(jc, y3).reshape(y.shape) + src_j
            if couple is None:
                return out
            sflux = wet_surf * jnp.einsum("xy,yh->xh", jnp.asarray(couple),
                                          y[:, 0, :])
            return out.at[:, 0, :].add(sflux)

        out = jax_imex_year(tend, lambda t: kv, jnp.asarray(diag2), dz_r,
                            jnp.asarray(y0.reshape(T, NZ, -1)), SPAN, N_STEPS)
        return np.asarray(out).reshape(y0.shape)

    plain = (diag.reshape(T, NZ, -1), src.reshape(T, NZ, -1), None)
    coupled = (a_diag, a_src, couple)
    return {
        "circ": circ, "jc": jc, "pc": coef_from_numpy(jc, device="cpu",
                                                      dtype=torch.float64),
        "kv": kv, "dz_r": dz_r, "wet": wet, "y0": y0,
        "cases": {"dense": plain, "coupled": coupled},
        "expected": {"dense": scan(*plain), "coupled": scan(*coupled)},
    }


def _port_year(problem, case, n_space, k, **kwargs):
    diag, src, couple = problem["cases"][case]
    year = st3.build_sharded_transport3d_year_blocked(
        _port_mesh(n_space), problem["pc"], problem["kv"], problem["dz_r"],
        diag, src, SPAN, N_STEPS, block_steps=k, couple=couple, **kwargs)
    return year, year(torch.as_tensor(problem["y0"])).numpy()


# -- (a) B7's plain version against JAX's block kernel ------------------------


@pytest.fixture(scope="module")
def window():
    """a seeded (T, 4, 16, 6) window of a 16-row circulation: its
    coefficient stack, CN bands, rate fields and state, and the step"""
    circ, jc, kv, dz_r, wet = _circ(NZ, WIN_ROWS, NLON)
    dt = YEAR / jax_synthetic.stable_steps_per_year(circ)
    names = [n for n, a in sorted(jc.items()) if a is not None]
    dlb, dub = _cn_bands(kv, dz_r, NZ, WIN_ROWS, NLON)
    rng = np.random.default_rng(17)
    shape = (T, NZ, WIN_ROWS, NLON)
    return {
        "names": names, "dt": dt, "wet": wet,
        "stack": np.stack([jc[n] for n in names]), "dlb": dlb, "dub": dub,
        "diag": -rng.uniform(0.0, 1.0e-6, shape) * wet,
        "src": rng.uniform(0.0, 1.0e-8, shape) * wet,
        "y": rng.uniform(0.0, 1.0, shape) * wet,
        "c": rng.uniform(-1.0e-7, 1.0e-7, shape) * wet,
        # factored rates a wet + b wet_surf, two scalars a tracer
        "diag_fac": ([-2.0e-8, 0.0], [-3.0e-7, -1.0e-7]),
        "src_fac": ([1.0e-9, 3.0e-9], [0.0, 2.0e-9]),
        "couple": np.array([[-3.0e-7, 2.0e-7], [0.0, -1.0e-7]]),
    }


def _pad(arr):
    out = np.zeros(arr.shape[:-1] + (LANES,), np.float32)
    out[..., :NLON] = arr
    return out


# (k, rates, coupled, tend_chunk)
BLOCK_CASES = [
    (1, "none", False, None),
    (2, "factored", True, 1),
    (3, "dense", True, 2),
    (2, "dense", False, 1),
    (1, "factored", False, 2),
    (3, "none", True, 1),
]


@pytest.mark.parametrize("k, rates, coupled, chunk", BLOCK_CASES)
def test_block_plain_matches_jax_kernel(window, k, rates, coupled, chunk):
    """k x [Heun; CN] on the whole window, in every rate form, with and
    without the coupling, and two tracer chunks of JAX's kernel"""
    w = window
    kw = dict(has_diag=rates != "none", has_src=rates != "none",
              couple=w["couple"] if coupled else None)
    extras = []
    if rates == "factored":
        kw.update(diag_fac=w["diag_fac"], src_fac=w["src_fac"])
    elif rates == "dense":
        extras = [w["diag"], w["src"]]
    jblk = jax_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"], k,
                             tend_chunk=chunk, **kw)
    ops = [w["y"], w["c"], w["stack"], w["dlb"], w["dub"], *extras]
    y_j, c_j = jblk(*(jnp.asarray(_pad(a)) for a in ops), interpret=True)
    y_j, c_j = np.asarray(y_j)[..., :NLON], np.asarray(c_j)[..., :NLON]

    fn = b7.build_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"], k,
                                tend_chunk=chunk, device="cpu", **kw)
    assert fn.stream_diag == (rates == "dense") == fn.stream_src
    assert fn.tend_chunk == (chunk or T) and fn.schedule(1) is None
    y_p, c_p = fn(*(torch.as_tensor(a, dtype=torch.float32) for a in ops))
    y_64, _ = fn(*(torch.as_tensor(a) for a in ops))
    assert y_p.dtype == torch.float32 and y_64.dtype == torch.float64
    assert _rel(y_p.numpy(), y_j) < BLOCK_TOL
    assert _rel(y_j, y_64.numpy()) < BLOCK_TOL
    # the carry: the compensated sums agree to the same bound
    assert _rel((y_p + c_p).numpy(), y_j + c_j) < BLOCK_TOL
    assert _rel(y_p.numpy(), w["y"]) > 1e-4  # the block moved y
    assert np.abs(y_p.numpy() * (1.0 - w["wet"])).max() == 0.0


def test_block_refuses_a_bad_tend_chunk_or_operands(window):
    w = window
    for chunk in (0.5, 3, -1):
        with pytest.raises(ValueError, match="outside"):
            b7.build_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"],
                                   1, tend_chunk=chunk, device="cpu")
    fn = b7.build_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"], 1,
                                has_diag=True, device="cpu")
    ops = [torch.as_tensor(w[key], dtype=torch.float32)
           for key in ("y", "c", "stack", "dlb", "dub")]
    with pytest.raises(ValueError, match="coefficient operands"):
        fn(*ops)
    with pytest.raises(ValueError, match="couple"):
        b7.build_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"], 1,
                               couple=np.zeros((3, 3)), device="cpu")


def test_block_cuda_request_never_falls_back(window, monkeypatch):
    """without a card a CUDA block raises rather than running the plain
    version"""
    w = window
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        b7.build_block3d_steps(w["names"], NZ, WIN_ROWS, NLON, T, w["dt"], 1,
                               device="cuda")


# -- (b) block_schedule: the persistent blocks' tiles and the shards a launch ---

H100_SMEM, H100_SMS = 232448, 132
# the fused step's tile and shared memory, as the kernel's library gives
# them (tests/test_torch_kernels.py holds the library to these on the card):
# 25,608 floats of rings, face tiles and carries, and when coupled a
# tracer's surface stage states at 512 columns
STEP_TILE = (16, 32)


def _step_smem(t_dim, coupled):
    return 4 * (25608 + (512 * t_dim if coupled else 0))


@pytest.mark.parametrize("t_dim, coupled, rows, nlon, n_shards, per_sm", [
    (2, True, 416, 320, 1, 2),    # gx1's horizontal extent, the coupled pair
    (2, True, 80, 320, 8, 2),     # eight shards of it, one launch
    (1, False, 392, 320, 1, 2),   # gx1 at full depth, one shard
    (1, False, 112, 320, 4, 2),   # four shards of it
    (2, True, 16, 6, 3, 4),       # a toy window: one ragged tile a shard
    (1, False, 80, 320, 20, 2),   # more shards than one launch takes
    (4, True, 12, 40, 1, 1),      # one tile row and a ragged column
])
def test_block_schedule_fits_and_covers(t_dim, coupled, rows, nlon, n_shards,
                                        per_sm):
    """the schedule fits the H100's opt-in shared memory, never launches
    more blocks than fit at once, puts every shard in some launch and, in
    the kernel's walk over tiles (block b takes tiles b, b + grid, ...),
    every tile of every shard once a step"""
    smem = _step_smem(t_dim, coupled)
    sched = b7.block_schedule(smem, STEP_TILE, rows, nlon, n_shards, per_sm,
                              H100_SMS, H100_SMEM)
    tile_y, tile_x = STEP_TILE
    assert sched.smem_bytes == smem
    assert sched.smem_bytes <= H100_SMEM
    assert sched.tiles_y * tile_y >= rows > (sched.tiles_y - 1) * tile_y
    assert sched.tiles_x * tile_x >= nlon > (sched.tiles_x - 1) * tile_x
    assert sum(sched.groups) == n_shards
    assert all(1 <= g <= b7.MAX_SHARDS for g in sched.groups)
    per_shard = sched.tiles_y * sched.tiles_x
    for group, grid, most in zip(sched.groups, sched.grids,
                                 sched.tiles_per_block):
        assert 1 <= grid <= per_sm * H100_SMS
        walks = [list(range(b, per_shard * group, grid)) for b in range(grid)]
        assert sorted(t for walk in walks for t in walk) == list(
            range(per_shard * group))
        assert max(len(walk) for walk in walks) == most


def test_block_schedule_refuses_what_one_block_cannot_take():
    """the surface stage states of 96 coupled tracers overflow a step
    tile's shared memory: refused, naming the limit and the streaming
    year; four coupled tracers fit, and so do 96 uncoupled ones"""
    def schedule(t_dim, coupled, per_sm):
        return b7.block_schedule(_step_smem(t_dim, coupled), STEP_TILE, 392,
                                 320, 1, per_sm, H100_SMS, H100_SMEM)

    with pytest.raises(ValueError, match="232448 bytes.*year_stream"):
        schedule(96, True, 2)
    assert schedule(4, True, 1).smem_bytes <= H100_SMEM
    assert schedule(96, False, 1).smem_bytes <= H100_SMEM
    with pytest.raises(ValueError, match="fits an SM"):
        schedule(1, False, 0)


@pytest.mark.parametrize("over", [-1, 0, 1])
def test_block_schedule_takes_the_limit_exactly(over):
    """a step tile of exactly the opt-in limit fits; one byte more is
    refused, naming both numbers"""
    smem = H100_SMEM + over
    if over > 0:
        with pytest.raises(ValueError, match=f"{smem} bytes.*{H100_SMEM}"):
            b7.block_schedule(smem, STEP_TILE, 80, 320, 2, 1, H100_SMS,
                              H100_SMEM)
    else:
        sched = b7.block_schedule(smem, STEP_TILE, 80, 320, 2, 1, H100_SMS,
                                  H100_SMEM)
        assert sched.smem_bytes == smem and sched.groups == (2,)


# -- (c) the blocked year against the JAX package ------------------------------


@pytest.mark.parametrize("n_space, k", [(1, 1), (2, 1), (1, 2)])
def test_blocked_year_matches_jax_scan(problem, n_space, k):
    """the year on CPU meshes within the JAX test's bound of JAX's float64
    scan; (2, 1) has shards of exactly 4 k rows, (1, 2) ends in a remainder
    block of one step (479 = 2 x 239 + 1); land stays dry"""
    year, got = _port_year(problem, "dense", n_space, k)
    assert got.dtype == np.float32
    assert _rel(got, problem["expected"]["dense"]) < YEAR_TOL
    assert np.abs(got * (1.0 - problem["wet"])).max() == 0.0
    m_blocks, r_steps = divmod(N_STEPS - 1, k)
    assert year.n_blocks == m_blocks + (r_steps > 0)
    assert year.halo == 4 * k and year.stream_diag and year.stream_src
    assert year.smem_bytes == 0
    assert year.halo_copies == (4 * year.n_blocks + 4) * (n_space - 1)


def test_blocked_year_shards_agree_and_carry_rides_the_exchange(problem):
    """2 shards against 1 (JAX's contract, 1e-6); on CPU shards every
    interior cell does the one-shard arithmetic, so the two are equal.
    Every block after the first starts from a non-zero carry, so a carry
    left out of the exchange would show at the shard seam"""
    _, one = _port_year(problem, "dense", 1, 1)
    _, two = _port_year(problem, "dense", 2, 1)
    assert _rel(two, one) <= SHARD_TOL
    assert np.array_equal(two, one)


@pytest.mark.parametrize("n_space, k", [(2, 1), (1, 2)])
def test_blocked_year_matches_jax_pallas_year(problem, n_space, k):
    """against JAX's pallas block year in interpret mode, on the same mesh
    and block depth (float32 both; the JAX year is 2e-5 from the scan)"""
    diag, src, _ = problem["cases"]["dense"]
    mesh = _jax_mesh(n_space)
    fn = jax_st3.build_sharded_transport3d_year_pallas(
        mesh, problem["jc"], problem["kv"], problem["dz_r"], diag, src, SPAN,
        N_STEPS, block_steps=k, interpret=True)
    ref = np.asarray(fn(jax.device_put(
        jnp.asarray(problem["y0"]),
        NamedSharding(mesh, P(None, None, "space", None)))))
    _, got = _port_year(problem, "dense", n_space, k)
    # measured 1e-6: the column solves' PCR forms and the sums' order
    assert _rel(got, ref) < 5e-6


@pytest.mark.parametrize("n_space, k", [(1, 2), (2, 1)])
def test_blocked_year_coupled_matches_jax_scan(problem, n_space, k):
    """the dic/dic14 pair: factored rates (two scalars a tracer) and the
    surface coupling in both Heun stages"""
    year, got = _port_year(problem, "coupled", n_space, k)
    assert not (year.stream_diag or year.stream_src)
    assert _rel(got, problem["expected"]["coupled"]) < YEAR_TOL
    assert np.abs(got * (1.0 - problem["wet"])).max() == 0.0
    if n_space == 2:
        _, one = _port_year(problem, "coupled", 1, k)
        assert np.array_equal(got, one)


def test_blocked_year_plain_is_the_cpu_year(problem):
    """plain=True runs block3d_steps_plain, which is what a CPU shard runs"""
    _, got = _port_year(problem, "dense", 2, 1)
    _, plain = _port_year(problem, "dense", 2, 1, plain=True)
    assert np.array_equal(got, plain)


# -- (d) the refusals, in JAX's words ------------------------------------------


def test_blocked_year_refusals(problem):
    """tests/test_sharded_transport3d.py:523-533, 620-655"""
    diag, src, _ = problem["cases"]["dense"]
    args = (problem["kv"], problem["dz_r"], diag, src, SPAN, N_STEPS)
    pc = problem["pc"]
    build = st3.build_sharded_transport3d_year_blocked
    mesh2d = port_mesh.make_mesh(1, 2, devices=["cpu"] * 4, n_space_x=2)
    with pytest.raises(ValueError, match="latitude only"):
        build(mesh2d, pc, *args)
    circ_s = jax_synthetic.gen_circulation(NZ, NLAT, NLON, n_seasons=4)
    coef_s = jax_t3.build_transport3d(
        circ_s["mask"], circ_s["dz"], circ_s["TAREA"], uet=circ_s["UET"],
        vnt=circ_s["VNT"], wtt=circ_s["WTT"], hdiff_e=circ_s["HDIFF_E"],
        hdiff_n=circ_s["HDIFF_N"])
    pc_s = coef_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in coef_s.items()},
        device="cpu", dtype=torch.float64)
    mesh = _port_mesh(2)
    with pytest.raises(ValueError, match="steady-only"):
        build(mesh, pc_s, *args)
    kv_s, _ = jax_t3.vmix_vertical_coeff(circ_s["VDC"], circ_s["dz"])
    kv_s = np.asarray(jax_t3.mask_vmix_coeff(kv_s, circ_s["mask"]))
    with pytest.raises(ValueError, match="seasonal kv"):
        build(mesh, pc, kv_s, *args[1:])
    with pytest.raises(ValueError, match="does not split over"):
        build(_port_mesh(3), pc, *args)
    with pytest.raises(ValueError, match="block_steps must be positive"):
        build(mesh, pc, *args, block_steps=0)
    with pytest.raises(ValueError, match="halo depth"):
        build(_port_mesh(4), pc, *args, block_steps=1)
    with pytest.raises(ValueError, match="outside"):
        build(mesh, pc, *args, block_steps=1, tend_chunk=3)
    with pytest.raises(ValueError, match="couple"):
        build(mesh, pc, *args, block_steps=1, couple=np.zeros((3, 3)))


# -- (e) B1v1: the first layout of the iage year --------------------------------


def _iage_grids(t_dim):
    """tests/test_imex_pallas.py's 8 x 6 grid, 24 steps, with its 2- or
    3-tracer rates and sources"""
    nz, ny = 8, 6
    depth, ypos = build_axes(nz, ny)
    rate = surf_restore_rate(depth)
    diag = np.zeros((t_dim, nz, ny), np.float32)
    diag[0, 0, :] = -rate
    diag[1, 0, :] = -SURF_SLOW_FACTOR * rate
    if t_dim == 3:
        diag[2, 1, :] = -0.5 * rate
        source = np.array([1.0, 2.0, 0.5], np.float32).reshape(3, 1, 1) / YEAR
    else:
        source = np.full((2, 1, 1), 1.0 / YEAR, np.float32)
    col = np.interp(np.asarray(depth.mid), [55.0, 200.0], [0.0, 2.0])
    y0 = np.ascontiguousarray(
        np.broadcast_to(col[None, :, None], (t_dim, nz, ny)), np.float32)
    return depth, ypos, diag, source, y0


@pytest.mark.parametrize("t_dim", [2, 3])
@pytest.mark.parametrize("aging", [True, False])
def test_iage_year_v1_cpu_matches_jax_v1(t_dim, aging):
    """build_iage_year_v1 on the CPU (the plain year, divide-form PCR)
    against JAX's build_iage_year_pallas (divide-form PCR) in interpret
    mode, with the source on and zeroed (the JVP route)"""
    depth, ypos, diag, source, y0 = _iage_grids(t_dim)
    if not aging:
        source = np.zeros_like(source)
    jgrid = jax_physics.make_grid(depth, ypos, MODELINFO, jnp.float32)
    ref = np.asarray(build_iage_year_pallas(jgrid, diag, source, SPAN, 24)(
        jnp.asarray(y0), interpret=True))
    grid = physics.make_grid(depth, ypos, MODELINFO, device="cpu",
                             dtype=torch.float64)
    before = imex_cuda.iage_year_v1_launches
    year = imex_cuda.build_iage_year_v1(grid, diag, source, SPAN, 24,
                                        device="cpu")
    got = year(torch.as_tensor(y0))
    assert got.dtype == torch.float32
    assert imex_cuda.iage_year_v1_launches == before
    assert _rel(got.numpy(), ref) < IAGE_TOL
    assert _rel(got.numpy(), y0) > 1e-3  # the year moved y


def test_iage_year_v1_cuda_request_never_falls_back(monkeypatch):
    depth, ypos, diag, source, _ = _iage_grids(2)
    grid = physics.make_grid(depth, ypos, MODELINFO, device="cpu",
                             dtype=torch.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        imex_cuda.build_iage_year_v1(grid, diag, source, SPAN, 24,
                                     device="cuda")
