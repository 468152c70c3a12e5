"""the port's latitude-sharded 3D years against the JAX package's, on CPU
meshes: the extended coefficient slices; the per-step sharded year in
float64 on latitude and lat x lon meshes (coupled, seasonal, with a
column-local hook) against JAX's build_sharded_transport3d_year; the
streaming sharded year through the plain sweep (kernel B6's plain version)
against JAX's unsharded float64 scan at the JAX tests' bounds, and against
JAX's streaming year in interpret mode over short spans; the streaming
year's refusals, in JAX's words; and float64 solves of
ShardedTransport3dKernel on 4 and 2 x 2 shards against 1 shard and against
JAX's kernel on 2 shards.

A port mesh of CPU shards is make_mesh(1, n, devices=["cpu"] * n); the JAX
side runs on the 8 virtual CPU devices of tests/conftest.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.models.irf_offline import (  # noqa: E402
    synthetic as jax_synthetic,
)
from newton_krylov_ooc_tpu.ops import transport3d as jax_t3  # noqa: E402
from newton_krylov_ooc_tpu.ops.imex import imex_year as jax_imex_year  # noqa: E402
from newton_krylov_ooc_tpu.parallel import (  # noqa: E402
    sharded_transport3d as jax_st3,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.irf_offline.convert import (  # noqa: E402
    coef_from_numpy,
)
from newton_krylov_ooc_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel import (  # noqa: E402
    sharded_transport3d as st3,
)

torch.set_num_threads(1)

NZ, NLAT, NLON, T = 4, 8, 6, 2
N_STEPS = 480  # inside the synthetic circulation's explicit bound
YEAR = 365.0 * 86400.0
SPAN = (0.0, YEAR)
F64 = torch.float64
# meshes as (n_space, n_space_x): None is a latitude-only mesh
MESHES = [(1, None), (2, None), (4, None), (2, 2), (1, 3), (4, 2), (2, 1)]


def _jax_mesh(n_y, n_x=None):
    """a JAX ("space",) or ("space", "space_x") CPU mesh and the state's
    PartitionSpec (tests/test_sharded_transport3d.py::_mesh_and_spec)"""
    if n_x is None:
        return (Mesh(np.asarray(jax.devices("cpu")[:n_y]), ("space",)),
                P(None, None, "space", None))
    return (Mesh(np.asarray(jax.devices("cpu")[:n_y * n_x]).reshape(n_y, n_x),
                 ("space", "space_x")), P(None, None, "space", "space_x"))


def _port_mesh(n_y, n_x=None):
    return port_mesh.make_mesh(1, n_y, devices=["cpu"] * (n_y * (n_x or 1)),
                               n_space_x=n_x)


def _numpy(coef):
    return {k: None if v is None else np.asarray(v) for k, v in coef.items()}


def _port(jc, dtype=F64):
    return coef_from_numpy(_numpy(jc), device="cpu", dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(n_seasons=None, seed=9):
    """the JAX tests' problem (tests/test_sharded_transport3d.py:35-54,
    318-337): circulation, JAX coefficients, kv, dz_r, random rates, y0,
    wet"""
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = jax_synthetic.gen_circulation(NZ, NLAT, NLON, mask=mask,
                                         n_seasons=n_seasons)
    jc = jax_t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"])
    kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
    rng = np.random.default_rng(seed)
    wet = (mask > 0).astype(np.float64)
    diag = -rng.uniform(0.0, 1.0e-7, (T, NZ, NLAT, NLON)) * wet
    src = rng.uniform(0.0, 1.0e-8, (T, NZ, NLAT, NLON)) * wet
    y0 = rng.uniform(0.0, 1.0, (T, NZ, NLAT, NLON)) * wet
    return {"circ": circ, "jc": jc, "kv": kv, "dz_r": np.asarray(dz_r),
            "diag": diag.reshape(T, NZ, -1), "src": src.reshape(T, NZ, -1),
            "y0": y0, "wet": wet}


# -- (a) the extended coefficient slices ------------------------------------------


@pytest.mark.parametrize("n_y, n_x", [(2, None), (4, None), (2, 2), (1, 3),
                                      (4, 2)])
def test_extended_slices_match_jax(n_y, n_x):
    """zero-padded latitude, periodic longitude, leading axes riding along"""
    arr = np.random.default_rng(1).standard_normal((3, NZ, NLAT, NLON))
    args = (arr, n_y, NLAT // n_y, n_x, None if n_x is None else NLON // n_x)
    got = st3._extended_slices(*args)
    expected = jax_st3._extended_slices(*args)
    assert st3.HALO == jax_st3.HALO
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("n_y, n_x", [(4, None), (2, 3)])
def test_grid_blocks_round_trip(n_y, n_x):
    """shard_grid cuts latitude (x longitude) blocks, copies on their
    devices; gather_grid joins them on the mesh's first device"""
    mesh = _port_mesh(n_y, n_x)
    assert ("space_x" in mesh.shape) == (n_x is not None)
    x = torch.arange(T * NZ * NLAT * NLON, dtype=F64).reshape(T, NZ, NLAT, NLON)
    blocks = port_mesh.shard_grid(mesh, x)
    assert len(blocks) == n_y and len(blocks[0]) == (n_x or 1)
    assert blocks[-1][-1].shape == (T, NZ, NLAT // n_y, NLON // (n_x or 1))
    blocks[0][0].zero_()
    assert torch.equal(port_mesh.gather_grid(mesh, port_mesh.shard_grid(
        mesh, x)), x)
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.shard_grid(_port_mesh(3), x)


# -- (b) the per-step sharded year -------------------------------------------------


def _couple(circ):
    couple = np.zeros((T, T))
    couple[1, 0] = 4.25e-3 / circ["dz"][0]
    return couple


def _light():
    """a column-local data field for the local_tend hook"""
    depth = np.linspace(1.0, 0.1, NZ)[:, None, None]
    lat = np.linspace(0.2, 1.0, NLAT)[None, :, None]
    return np.broadcast_to(depth * lat, (NZ, NLAT, NLON)).copy()


# case -> (n_space, n_space_x, seasonal, coupled, local_tend)
YEAR_CASES = {
    **{f"plain_{n_y}x{n_x}": (n_y, n_x, False, False, False)
       for n_y, n_x in MESHES},
    "coupled_2": (2, None, False, True, False),
    "coupled_2x2": (2, 2, False, True, False),
    "seasonal_2": (2, None, True, False, False),
    "seasonal_2x2": (2, 2, True, False, False),
    "local_tend_2x2": (2, 2, False, False, True),
}


@pytest.fixture(scope="module")
def year_problems():
    return {False: _problem(), True: _problem(n_seasons=4, seed=11)}


@pytest.mark.parametrize("case", sorted(YEAR_CASES))
def test_per_step_year_matches_jax(year_problems, case):
    """float64, the JAX tests' 4 x 8 x 6 over 480 steps: the port's halo
    copies reproduce JAX's ppermute year to roundoff (JAX's scan is not
    unrolled here, which only shortens its compile)"""
    n_y, n_x, seasonal, coupled, hook = YEAR_CASES[case]
    p = year_problems[seasonal]
    couple = _couple(p["circ"]) if coupled else None
    # the hook's arithmetic reads the same in jax.numpy and in torch
    hooks = {"local_data": {"light": _light()},
             "local_tend": lambda t, y, d: -1.0e-8 * d["light"] * y} if hook else {}
    mesh, spec = _jax_mesh(n_y, n_x)
    fn = jax_st3.build_sharded_transport3d_year(
        mesh, p["jc"], p["kv"], p["dz_r"], p["diag"], p["src"], SPAN, N_STEPS,
        unroll=1, couple=couple, **hooks)
    expected = np.asarray(fn(jax.device_put(jnp.asarray(p["y0"]),
                                            NamedSharding(mesh, spec))))
    year = st3.build_sharded_transport3d_year(
        _port_mesh(n_y, n_x), _port(p["jc"]), p["kv"], p["dz_r"], p["diag"],
        p["src"], SPAN, N_STEPS, couple=couple, **hooks)
    got = year(torch.tensor(p["y0"]))
    assert got.dtype == F64 and got.shape == p["y0"].shape
    assert _rel(got.numpy(), expected) <= 1e-12
    assert np.abs(got.numpy() * (1.0 - p["wet"])).max() == 0.0
    assert _rel(p["y0"], expected) > 1e-3  # the year moved y


def test_per_step_year_runs_in_the_states_dtype(year_problems):
    """float32 in, float32 out (the port's plain years' rule), within
    float32 rounding of the float64 year; the result lies on the mesh's
    first device"""
    p = year_problems[False]
    year = st3.build_sharded_transport3d_year(
        _port_mesh(2, 2), _port(p["jc"]), p["kv"], p["dz_r"], p["diag"],
        p["src"], SPAN, N_STEPS)
    y64 = year(torch.tensor(p["y0"]))
    y32 = year(torch.tensor(p["y0"], dtype=torch.float32))
    assert y32.dtype == torch.float32 and y32.device == torch.device("cpu")
    assert _rel(y32.numpy(), y64.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="does not split"):
        st3.build_sharded_transport3d_year(
            _port_mesh(3), _port(p["jc"]), p["kv"], p["dz_r"], p["diag"],
            p["src"], SPAN, N_STEPS)


# -- (c) the streaming year against JAX's float64 scan -------------------------------


SNZ, SNLAT = 4, 16


def _jax_scan(jc, kv, dz_r, diag, src, y0, couple=None, wet=None,
              seasonal=False):
    """the JAX tests' unsharded float64 imex_year of a 4 x 16 x 6 family"""
    t_dim = y0.shape[0]
    src2 = jnp.asarray(np.asarray(src).reshape(t_dim, SNZ, SNLAT * NLON))

    def tend(t, y):
        y3 = y.reshape(y.shape[:-1] + (SNLAT, NLON))
        c = (jax_t3.interp_transport_coef(jc, jnp.mod(t / YEAR, 1.0))
             if seasonal else jc)
        out = jax_t3.transport_tend(c, y3).reshape(y.shape) + src2
        if couple is not None:
            sflux = jnp.asarray(wet[0].reshape(-1)) * jnp.einsum(
                "xy,yh->xh", jnp.asarray(couple), y[:, 0, :])
            out = out.at[:, 0, :].add(sflux)
        return out

    kv_j = jnp.asarray(kv)
    if kv_j.ndim == 3:
        def vert_coeff(t):
            return jax_t3.interp_month(kv_j, jnp.mod(t / YEAR, 1.0))
    else:
        def vert_coeff(t):
            return kv_j
    return np.asarray(jax_imex_year(
        tend, vert_coeff,
        jnp.asarray(np.asarray(diag).reshape(t_dim, SNZ, SNLAT * NLON)), dz_r,
        jnp.asarray(y0.reshape(t_dim, SNZ, SNLAT * NLON)), SPAN, N_STEPS,
    )).reshape(y0.shape)


def _stream_problem(kind):
    """the streams of tests/test_sharded_transport3d.py:658-943: "mixed"
    (one factorable and one dense tracer, masked), "factored" (three
    tracers whose rates all factor), "seasonal" (4 seasons, seasonal kv,
    the coupled pair)"""
    mask = np.ones((SNZ, SNLAT, NLON), np.int32)
    if kind != "factored":
        mask[:, 3, 2] = 0
        mask[2:, 11, 4] = 0
    circ = jax_synthetic.gen_circulation(
        SNZ, SNLAT, NLON, mask=mask, n_seasons=4 if kind == "seasonal" else None)
    jc = jax_t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"])
    kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
    wet = (np.asarray(circ["mask"]) > 0).astype(np.float64)
    shape = (SNZ, SNLAT, NLON)
    couple = None
    if kind == "mixed":
        rng = np.random.default_rng(11)
        diag = np.zeros((2,) + shape)
        diag[0] = -1.0e-8 * wet
        diag[0, 0] -= 2.0e-8 * wet[0]
        diag[1] = -rng.uniform(0.0, 1.0e-7, shape) * wet
        src = np.zeros((2,) + shape)
        src[0] = 1.0e-8 * wet
        src[1] = rng.uniform(0.0, 1.0e-8, shape) * wet
        y0 = rng.uniform(0.0, 1.0, (2,) + shape) * wet
    elif kind == "factored":
        rng = np.random.default_rng(13)
        diag = np.stack([
            -1.0e-8 * wet,
            -2.0e-8 * wet - 1.0e-8 * np.concatenate(
                [wet[:1], np.zeros_like(wet[1:])]),
            np.zeros_like(wet),
        ])
        src = np.stack([1.0e-8 * wet, np.zeros_like(wet), 2.0e-8 * wet])
        y0 = rng.uniform(0.0, 1.0, (3,) + shape) * wet
    else:
        rng = np.random.default_rng(17)
        diag = np.zeros((2,) + shape)
        diag[0] = -1.0e-8 * wet
        src = np.zeros((2,) + shape)
        src[0] = 1.0e-8 * wet
        y0 = rng.uniform(0.0, 1.0, (2,) + shape) * wet
        couple = np.zeros((2, 2))
        couple[1, 0] = 4.25e-3 / circ["dz"][0]
        couple[1, 1] = -2.0e-3 / circ["dz"][0]
    t_dim = y0.shape[0]
    return {"circ": circ, "jc": jc, "kv": kv, "dz_r": np.asarray(dz_r),
            "diag": diag.reshape(t_dim, SNZ, -1),
            "src": src.reshape(t_dim, SNZ, -1), "y0": y0, "wet": wet,
            "couple": couple}


@pytest.fixture(scope="module")
def streams():
    out = {}
    for kind in ("mixed", "factored", "seasonal"):
        p = _stream_problem(kind)
        p["scan"] = _jax_scan(p["jc"], p["kv"], p["dz_r"], p["diag"],
                              p["src"], p["y0"], p["couple"], p["wet"],
                              seasonal=kind == "seasonal")
        out[kind] = p
    return out


def _port_stream(p, n_space, **kwargs):
    year = st3.build_sharded_transport3d_year_stream(
        _port_mesh(n_space), _port(p["jc"]), p["kv"], p["dz_r"],
        kwargs.pop("diag", p["diag"]), kwargs.pop("src", p["src"]), SPAN,
        N_STEPS, **kwargs)
    return year, year(torch.tensor(p["y0"][:kwargs.get("t_dim") or None],
                                   dtype=torch.float32))


@pytest.mark.parametrize("n_space, block_rows, k", [(2, 8, 1), (1, 8, 2),
                                                    (2, 8, 2)])
def test_stream_year_matches_jax_scan(streams, n_space, block_rows, k):
    """across shard counts and steps_per_sweep, recip_vol rebuilt from its
    factors (tests/test_sharded_transport3d.py:711-730)"""
    p = streams["mixed"]
    year, got = _port_stream(
        p, n_space, block_rows=block_rows, steps_per_sweep=k,
        recip_area=1.0 / np.asarray(p["circ"]["TAREA"]),
        recip_dz=1.0 / np.asarray(p["circ"]["dz"]))
    assert got.dtype == torch.float32
    assert year.halo == 8 and year.n_sweeps == N_STEPS // k + 1
    assert year.stream_diag and year.stream_src
    assert year.halo_copies == year.n_sweeps * 4 * (n_space - 1)
    assert np.abs(got.numpy() - p["scan"]).max() <= 2e-5 * np.abs(p["scan"]).max()
    assert np.abs(got.numpy() * (1.0 - p["wet"])).max() == 0.0


@pytest.mark.parametrize("chunk, stencil", [(None, False), (2, False),
                                            (None, True)])
def test_stream_year_factored_rates_and_chunks(streams, chunk, stencil):
    """every rate field factors (no dense field streams); tracer chunking;
    the collapsed stencil operator (tests/test_sharded_transport3d.py:
    796-811)"""
    p = streams["factored"]
    year, got = _port_stream(p, 2, block_rows=8, steps_per_sweep=2,
                             tend_chunk=chunk, stencil=stencil)
    assert not year.stream_diag and not year.stream_src
    assert year.stencil == stencil
    bound = 2e-4 if stencil else 2e-5
    assert np.abs(got.numpy() - p["scan"]).max() <= bound * np.abs(p["scan"]).max()


def test_stream_year_rate_free_family(streams):
    """no diag and no src: t_dim is required, and then the year is the bare
    transport (tests/test_sharded_transport3d.py:813-841)"""
    p = streams["factored"]
    with pytest.raises(ValueError, match="t_dim"):
        _port_stream(p, 2, block_rows=8, diag=None, src=None)
    zeros = np.zeros((1, SNZ, SNLAT * NLON))
    expected = _jax_scan(p["jc"], p["kv"], p["dz_r"], zeros, zeros,
                         p["y0"][:1])
    _, got = _port_stream(p, 2, block_rows=8, steps_per_sweep=2, t_dim=1,
                          diag=None, src=None)
    assert np.abs(got.numpy() - expected).max() <= 2e-5 * np.abs(expected).max()


@pytest.mark.parametrize("n_space", [1, 2])
def test_stream_year_seasonal_coupled(streams, n_space):
    """monthly faces and kv with the gas-exchange coupling
    (tests/test_sharded_transport3d.py:909-943); the coupling matters at
    this bound"""
    p = streams["seasonal"]
    year, got = _port_stream(p, n_space, block_rows=8, couple=p["couple"])
    assert year.seasonal
    scale = np.abs(p["scan"]).max()
    assert np.abs(got.numpy() - p["scan"]).max() <= 5e-5 * scale
    assert np.abs(got.numpy() * (1.0 - p["wet"])).max() == 0.0
    _, uncoupled = _port_stream(p, n_space, block_rows=8)
    assert np.abs(uncoupled.numpy()[1] - p["scan"][1]).max() > 1e-3 * scale


# -- (d) against JAX's streaming year in interpret mode ------------------------------


SHORT = 48  # steps of the short spans, each of the 480-step year's dt


@pytest.mark.parametrize("kind, k", [("mixed", 2), ("seasonal", 1)])
def test_stream_year_matches_jax_stream(streams, kind, k):
    """float32 against float32 over 48 steps of the year on 2 shards: JAX's
    sweeps in interpret mode against the port's plain sweeps.  They round
    in other orders (the TPU kernel's PCR and band-form CN factors), and
    the seasonal weights follow each package's own convention (the port's
    season_samples; JAX's per-sweep x_2 = x_1 + dt n_time/period): measured
    6.8e-6 (steady, k = 2) and 3.2e-6 (seasonal coupled) max|y| apart,
    held at 2e-5, the bound tests/test_torch_stream.py holds the port's
    plain year to JAX's B5 at"""
    p = streams[kind]
    span = (0.0, YEAR * SHORT / N_STEPS)
    kwargs = dict(block_rows=8, steps_per_sweep=k, couple=p["couple"])
    jax_mesh, spec = _jax_mesh(2)
    fn = jax_st3.build_sharded_transport3d_year_stream(
        jax_mesh, p["jc"], p["kv"], p["dz_r"], p["diag"], p["src"], span,
        SHORT, interpret=True, **kwargs)
    expected = np.asarray(fn(jax.device_put(
        jnp.asarray(p["y0"], jnp.float32), NamedSharding(jax_mesh, spec))))
    year = st3.build_sharded_transport3d_year_stream(
        _port_mesh(2), _port(p["jc"]), p["kv"], p["dz_r"], p["diag"],
        p["src"], span, SHORT, **kwargs)
    got = year(torch.tensor(p["y0"], dtype=torch.float32)).numpy()
    for attr in ("halo", "seasonal", "stencil", "stream_diag", "stream_src"):
        assert getattr(year, attr) == getattr(fn, attr), attr
    assert _rel(got, expected) <= 2e-5
    assert _rel(p["y0"], expected) > 1e-4  # the span moved y


# -- (e) the refusals ----------------------------------------------------------------


def _guard_args(seasonal):
    circ = jax_synthetic.gen_circulation(SNZ, SNLAT, NLON,
                                         n_seasons=4 if seasonal else None)
    jc = jax_t3.build_transport3d(circ["mask"], circ["dz"], circ["TAREA"],
                                  uet=circ["UET"], vnt=circ["VNT"],
                                  wtt=circ["WTT"])
    kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
    return jc, kv, np.asarray(dz_r)


# case -> (seasonal, (n_space, n_space_x), keyword changes, words)
GUARDS = {
    "halo_depth": (False, (2, None), {"steps_per_sweep": 3}, "halo depth"),
    "seasonal_sweep": (True, (2, None), {"steps_per_sweep": 2},
                       "steps_per_sweep=1"),
    "seasonal_dt": (True, (2, None), {"n_steps": 3}, "period/n_time"),
    "stencil_seasonal": (True, (2, None), {"stencil": True}, "STEADY"),
    "space_x": (False, (2, 2), {}, "space_x"),
    "block_rows": (False, (4, None), {}, "not a multiple of block_rows"),
    "divide": (False, (2, None), {"steps_per_sweep": 7}, "steps_per_sweep"),
    "t_dim": (False, (2, None), {"t_dim": None}, "t_dim"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_stream_year_refuses_what_jax_refuses(case):
    seasonal, (n_y, n_x), changes, words = GUARDS[case]
    jc, kv, dz_r = _guard_args(seasonal)
    args = {"t_span": SPAN, "n_steps": 480, "block_rows": 8, "t_dim": 1,
            **changes}
    if n_x is None:
        jax_mesh = Mesh(np.asarray(jax.devices("cpu")[:n_y]), ("space",))
    else:
        jax_mesh = Mesh(np.asarray(jax.devices("cpu")[:n_y * n_x])
                        .reshape(1, n_y, n_x), ("module", "space", "space_x"))
    with pytest.raises(ValueError, match=words):
        jax_st3.build_sharded_transport3d_year_stream(
            jax_mesh, jc, kv, dz_r, None, None, interpret=True, **args)
    with pytest.raises(ValueError, match=words):
        st3.build_sharded_transport3d_year_stream(
            _port_mesh(n_y, n_x), _port(jc), kv, dz_r, None, None, **args)


# -- (f) the sharded solves ----------------------------------------------------------


# the JAX test's family on two regions (tests/test_sharded_transport3d.py:
# 76-150); 192 steps a year keep dt inside the explicit bound (186 steps at
# the circulation's safety factor 0.5) and the solves short
SOLVE_STEPS = 192
MODULE_SPECS = [
    [{"sink_rate_per_year": 0.5, "source_per_year": 1.0}],
    [{"surf_restore_pv_cm_s": 5.0, "surf_restore_target": 2.0,
      "sink_rate_per_year": 0.1}],
]
SOLVER = {"newton_rel_tol": 1e-6, "krylov_rel_tol": 1e-2,
          "newton_max_iter": 8, "krylov_max_dim": 20}


@pytest.fixture(scope="module")
def solve_problem():
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = jax_synthetic.gen_circulation(NZ, NLAT, NLON, mask=mask)
    vol = circ["dz"][:, None, None] * circ["TAREA"][None]
    out = (2 * np.abs(circ["UET"]) + 2 * np.abs(circ["VNT"])
           + np.abs(circ["WTT"]) + 2 * circ["HDIFF_E"] + 2 * circ["HDIFF_N"])
    assert YEAR / (0.5 / (out / vol).max()) <= SOLVE_STEPS
    region = circ["mask"].copy()
    north = region[:, NLAT // 2:, :]
    north[north > 0] = 2
    return circ, region


def _port_solve(circ, region, **placement):
    kernel = st3.ShardedTransport3dKernel(
        circ, MODULE_SPECS, SOLVE_STEPS, dtype=F64, region_mask=region,
        **placement)
    x, _, info = NewtonKrylovInCore(kernel, **SOLVER).solve(
        kernel.init_iterate())
    assert (info["fcn_norm"] / info["x_norm"] < SOLVER["newton_rel_tol"]).all()
    return kernel, x.numpy(), info


@pytest.fixture(scope="module")
def one_shard_solve(solve_problem):
    return _port_solve(*solve_problem, device="cpu")


@pytest.mark.parametrize("n_y, n_x", [(4, None), (2, 2)])
def test_sharded_solve_matches_one_shard(solve_problem, one_shard_solve, n_y,
                                         n_x):
    """the JAX test's bound, 1e-11 max|x| (the meshes run the same
    arithmetic, and agree bit for bit here)"""
    kernel, x, info = _port_solve(*solve_problem, mesh=_port_mesh(n_y, n_x))
    assert not kernel.use_kernel and kernel.device == torch.device("cpu")
    _, x_ref, info_ref = one_shard_solve
    assert info["iterations"] == info_ref["iterations"]
    assert np.abs(x - x_ref).max() <= 1e-11 * np.abs(x_ref).max()


def test_sharded_solve_matches_jax(solve_problem, one_shard_solve):
    """JAX's kernel on a 2-shard mesh, its host-driven GMRES, the same
    settings: within 1e-8 max|x| of the port's solution (the bound of
    tests/test_torch_irf3d.py's solve: the two packages' GMRES sums round
    apart)"""
    circ, region = solve_problem
    jk = jax_st3.ShardedTransport3dKernel(
        _jax_mesh(2)[0], circ, MODULE_SPECS, n_steps=SOLVE_STEPS,
        dtype=jnp.float64, region_mask=region)
    x_j, _, info_j = JaxNewtonKrylovInCore(jk, **SOLVER).solve(
        jk.init_iterate())
    _, x, info = one_shard_solve
    assert info["iterations"] == info_j["iterations"]
    assert _rel(x, np.asarray(x_j)) <= 1e-8


def test_kernel_takes_one_of_device_and_mesh(solve_problem):
    circ, _ = solve_problem
    with pytest.raises(ValueError, match="one of"):
        st3.ShardedTransport3dKernel(circ, MODULE_SPECS, SOLVE_STEPS)
    with pytest.raises(ValueError, match="one of"):
        st3.ShardedTransport3dKernel(circ, MODULE_SPECS, SOLVE_STEPS,
                                     device="cpu", mesh=_port_mesh(2))
    one = st3.ShardedTransport3dKernel(circ, MODULE_SPECS, SOLVE_STEPS,
                                       mesh=_port_mesh(1))
    assert one.mesh.shape == {"module": 1, "space": 1}
    assert one.device == torch.device("cpu") and not one.use_kernel
