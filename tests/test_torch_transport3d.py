"""the port's 3D transport operators and plain IMEX year against the JAX
package's, on the CPU at the JAX tests' size (4 x 8 x 6, T = 2, 480 steps,
the masked cells of tests/test_transport3d_pallas.py): transport_tend and
transport_tridiag_bands in float64 on one coefficient set; the set-up
functions; the plain year against the JAX float64 scan year and, in
float32, against the JAX kernel B4 run in interpret mode"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from newton_krylov_ooc_tpu.models.irf_offline import (  # noqa: E402
    synthetic as jax_synthetic,
)
from newton_krylov_ooc_tpu.ops import transport3d as jax_t3  # noqa: E402
from newton_krylov_ooc_tpu.ops.transport3d_pallas import (  # noqa: E402
    build_transport3d_year_pallas,
)
from newton_krylov_ooc_tpu.parallel.sharded_transport3d import (  # noqa: E402
    build_sharded_transport3d_year,
)
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.irf_offline.convert import (  # noqa: E402
    coef_from_numpy,
)
from newton_krylov_ooc_tpu_torch.ops import transport3d as t3  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import transport3d_cuda as t3c  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops.imex import imex_year  # noqa: E402

torch.set_num_threads(1)

NZ, NLAT, NLON, T = 4, 8, 6, 2
N_STEPS = 480  # inside the synthetic circulation's explicit bound
YEAR = t3c.SEC_PER_YEAR
SPAN = (0.0, YEAR)
CPU = torch.device("cpu")
F64 = torch.float64


def _mask():
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    return mask


def _circ(n_seasons=None):
    return jax_synthetic.gen_circulation(NZ, NLAT, NLON, mask=_mask(),
                                         n_seasons=n_seasons)


def _jax_coef(circ, adv_type="upwind3"):
    return jax_t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"], adv_type=adv_type, dtype=jnp.float64,
    )


def _numpy(coef):
    return {k: None if v is None else np.asarray(v) for k, v in coef.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- operators -----------------------------------------------------------------


@pytest.fixture(scope="module", params=["upwind3", "centered"])
def operator_case(request):
    """one float64 coefficient set with a nonzero vertical transport (the
    synthetic WTT is zero), in both packages"""
    circ = _circ()
    rng = np.random.default_rng(5)
    circ["WTT"] = rng.uniform(-2.0e10, 2.0e10, circ["WTT"].shape)
    jc = _jax_coef(circ, request.param)
    tc = coef_from_numpy(_numpy(jc), device=CPU, dtype=F64)
    y = rng.uniform(0.0, 1.0, (T, NZ, NLAT, NLON))
    return jc, tc, y


def test_transport_tend_matches_jax(operator_case):
    jc, tc, y = operator_case
    expected = np.asarray(jax_t3.transport_tend(jc, jnp.asarray(y)))
    got = t3.transport_tend(tc, torch.tensor(y)).numpy()
    assert np.abs(got - expected).max() <= 1e-12 * np.abs(expected).max()
    assert np.abs(got * (1.0 - _mask())).max() == 0.0  # land stays zero


def test_transport_tridiag_bands_matches_jax(operator_case):
    jc, tc, _ = operator_case
    for got, expected in zip(t3.transport_tridiag_bands(tc),
                             jax_t3.transport_tridiag_bands(jc)):
        expected = np.asarray(expected)
        scale = max(np.abs(expected).max(), 1e-300)
        assert np.abs(got.numpy() - expected).max() <= 1e-12 * scale


@pytest.mark.parametrize("n_seasons", [None, 4])
@pytest.mark.parametrize("adv_type", ["upwind3", "centered"])
def test_build_transport3d_matches_jax(n_seasons, adv_type):
    circ = _circ(n_seasons)
    expected = _numpy(_jax_coef(circ, adv_type))
    got = t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"], adv_type=adv_type, device=CPU, dtype=F64,
    )
    assert set(got) == set(expected)
    for key, arr in expected.items():
        if arr is None:
            assert got[key] is None
            continue
        assert got[key].shape == arr.shape
        assert np.abs(got[key].numpy() - arr).max() <= 1e-12 * max(
            np.abs(arr).max(), 1e-300)
    with pytest.raises(ValueError, match="adv_type"):
        t3.build_transport3d(circ["mask"], circ["dz"], circ["TAREA"],
                             adv_type="quick", device=CPU, dtype=F64)


def test_assemble_rate_fields_matches_jax():
    wet = (_mask() > 0).astype(np.float64).reshape(NZ, -1)
    specs = [
        {"name": "ABIO_DIC", "surf_flux_const_cm_s": 1.05e-2,
         "surf_flux_d": {"ABIO_DIC": -5.0e-3}, "source_per_year": 0.3},
        {"name": "ABIO_DIC14", "sink_rate_per_year": 1.2097e-4,
         "surf_restore_pv_cm_s": 5.0e-3, "surf_restore_target": 2.0,
         "surf_flux_d": {"ABIO_DIC": 4.25e-3, "ABIO_DIC14": -5.0e-3}},
    ]
    got = t3.assemble_rate_fields(specs, wet, 1.0e4, YEAR)
    expected = jax_t3.assemble_rate_fields(specs, wet, 1.0e4, YEAR)
    for g, e in zip(got, expected):
        assert np.abs(g - e).max() <= 1e-12 * np.abs(e).max()
    assert t3.assemble_rate_fields(specs[:1], wet, 1.0e4, YEAR)[2] is None
    with pytest.raises(ValueError, match="not in its module"):
        t3.assemble_rate_fields(specs[1:], wet, 1.0e4, YEAR)


@pytest.mark.parametrize("n_seasons", [None, 4])
def test_vmix_coeff_matches_jax(n_seasons):
    circ = _circ(n_seasons)
    kv_j, dzr_j = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv_j = jax_t3.mask_vmix_coeff(kv_j, circ["mask"])
    kv, dz_r = t3.vmix_vertical_coeff(circ["VDC"], circ["dz"], device=CPU,
                                      dtype=F64)
    kv = t3.mask_vmix_coeff(kv, circ["mask"])
    assert kv.shape == np.shape(kv_j)
    assert _rel(kv.numpy(), kv_j) <= 1e-12
    assert _rel(dz_r.numpy(), dzr_j) <= 1e-12


def test_interp_and_mean_match_jax():
    circ = _circ(4)
    jc = _jax_coef(circ)
    tc = coef_from_numpy(_numpy(jc), device=CPU, dtype=F64)
    assert t3.transport_coef_n_time(tc) == jax_t3.transport_coef_n_time(jc) == 4
    for frac in (0.0, 0.05, 0.125, 0.49, 0.874, 0.999):
        got = t3.interp_month(tc["t_e"], torch.tensor(frac, dtype=F64))
        expected = np.asarray(jax_t3.interp_month(jc["t_e"], frac))
        assert _rel(got.numpy(), expected) <= 1e-12
    mean = t3.mean_transport_coef(tc)
    expected = _numpy(jax_t3.mean_transport_coef(jc))
    for key in ("t_e", "t_n", "wet"):
        assert _rel(mean[key].numpy(), expected[key]) <= 1e-12
    assert t3.transport_coef_n_time(mean) is None


def test_synthetic_matches_jax():
    for n_seasons in (None, 3):
        got = synthetic.gen_circulation(NZ, NLAT, NLON, mask=_mask(),
                                        n_seasons=n_seasons)
        expected = _circ(n_seasons)
        assert set(got) == set(expected)
        for key in expected:
            np.testing.assert_array_equal(got[key], expected[key])
        assert (synthetic.stable_steps_per_year(got)
                == jax_synthetic.stable_steps_per_year(expected))


# -- the plain year --------------------------------------------------------------


CASES = ("steady", "coupled", "seasonal")


@pytest.fixture(scope="module")
def years():
    """per case: the year's inputs, the JAX float64 scan year (the sharded
    year on a 1-CPU mesh) and the JAX kernel B4 in interpret mode"""
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]), ("space",))
    out = {}
    for case in CASES:
        circ = _circ(4 if case == "seasonal" else None)
        assert jax_synthetic.stable_steps_per_year(circ) <= N_STEPS
        jc = _jax_coef(circ)
        kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
        kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
        dz_r = np.asarray(dz_r)
        rng = np.random.default_rng(9)
        wet = (_mask() > 0).astype(np.float64)
        diag = (-rng.uniform(0.0, 1.0e-7, (T, NZ, NLAT, NLON)) * wet).reshape(
            T, NZ, -1)
        src = (rng.uniform(0.0, 1.0e-8, (T, NZ, NLAT, NLON)) * wet).reshape(
            T, NZ, -1)
        y0 = rng.uniform(0.0, 1.0, (T, NZ, NLAT, NLON)) * wet
        couple = None
        if case == "coupled":
            couple = np.zeros((T, T))
            couple[1, 0] = 4.25e-3 / circ["dz"][0]
            couple[1, 1] = -2.0e-3 / circ["dz"][0]
        args = (kv, dz_r, diag, src, SPAN, N_STEPS)
        scan = build_sharded_transport3d_year(mesh, jc, *args, couple=couple)
        kernel = build_transport3d_year_pallas(jc, *args, couple=couple)
        out[case] = {
            "coef": _numpy(jc), "args": args, "couple": couple, "y0": y0,
            "wet": wet,
            "scan64": np.asarray(scan(jnp.asarray(y0))),
            "b4": np.asarray(kernel(jnp.asarray(y0, jnp.float32),
                                    interpret=True)),
        }
    return out


def _plain(case, dtype):
    coef = coef_from_numpy(case["coef"], device=CPU, dtype=dtype)
    year = t3c.build_transport3d_year_plain(coef, *case["args"],
                                            couple=case["couple"])
    return year(torch.tensor(case["y0"], dtype=dtype)).numpy()


@pytest.mark.parametrize("case", CASES)
def test_plain_year_f64_matches_jax_scan(years, case):
    got = _plain(years[case], F64)
    expected = years[case]["scan64"]
    assert _rel(got, expected) <= 1e-10
    assert np.abs(got * (1.0 - years[case]["wet"])).max() == 0.0
    # the year moves the state well past the tolerances
    assert _rel(years[case]["y0"], expected) > 1e-3


@pytest.mark.parametrize("case", CASES)
def test_plain_year_f32_matches_jax_b4(years, case):
    """float32 in another rounding order than the TPU kernel's (PCR, FMA)"""
    got = _plain(years[case], torch.float32)
    b4 = years[case]["b4"]
    scale = np.abs(b4).max()
    assert np.abs(got - b4).max() <= 2e-5 * scale
    # and both stay at the float32 discretization level of the f64 scan
    expected = years[case]["scan64"]
    assert np.abs(got - expected).max() <= 1e-5 * np.abs(expected).max()


def test_coupling_and_seasons_matter(years):
    """the coupled and seasonal years differ from the steady one by far
    more than the tolerances above"""
    steady = years["steady"]["scan64"]
    for case in ("coupled", "seasonal"):
        assert _rel(years[case]["scan64"], steady) > 1e-4


# -- the kernel wrapper on the CPU -----------------------------------------------


def test_wrapper_on_cpu_is_the_plain_f32_year(years):
    case = years["seasonal"]
    coef = coef_from_numpy(case["coef"], device=CPU, dtype=F64)
    year = t3c.build_transport3d_year(coef, *case["args"], device="cpu")
    y32 = torch.tensor(case["y0"], dtype=torch.float32)
    assert torch.equal(year(y32), torch.tensor(_plain(case, torch.float32)))
    before = t3c.transport3d_year_launches
    for bad in (y32.double(), y32[:1]):
        with pytest.raises(ValueError):
            year(bad)
    assert t3c.transport3d_year_launches == before


def test_wrapper_rejects_bad_operands_and_missing_card(
        years, monkeypatch):
    case = years["seasonal"]
    coef = coef_from_numpy(case["coef"], device=CPU, dtype=F64)
    kv, dz_r, diag, src, span, _ = case["args"]
    with pytest.raises(ValueError, match="n_time"):
        t3c.build_transport3d_year(coef, kv, dz_r, diag, src, span, 3,
                                   device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        t3c.build_transport3d_year(coef, kv[:3], dz_r, diag, src, span,
                                   N_STEPS, device="cpu")
    with pytest.raises(ValueError, match="kv has shape"):
        t3c.build_transport3d_year(coef, kv[:, 1:], dz_r, diag, src, span,
                                   N_STEPS, device="cpu")
    with pytest.raises(ValueError, match="dz_r has shape"):
        t3c.build_transport3d_year(coef, kv, dz_r[1:], diag, src, span,
                                   N_STEPS, device="cpu")
    bad = dict(coef, t_n=coef["t_n"][:, :, 1:])
    with pytest.raises(ValueError, match="t_n has shape"):
        t3c.build_transport3d_year(bad, *case["args"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t3c.build_transport3d_year(coef, *case["args"], device="cuda")


def test_season_samples_are_the_plain_years_times(years):
    """the kernel's month table holds, sample for sample, the months and
    weights the plain year interpolates at (imex_year's stage times)"""
    n_steps = 40
    m0, m1, w = t3c.season_samples(SPAN, n_steps, 4)
    assert len(m0) == len(m1) == len(w) == 2 * n_steps + 1
    arr = torch.arange(4, dtype=torch.float32).reshape(4, 1) * 10.0
    seen = []

    def explicit_tend(t, y):
        seen.append(float(t3.interp_month(arr, t3c.year_frac(t))[0]))
        return torch.zeros_like(y)

    def vert_coeff(t):
        seen.append(float(t3.interp_month(arr, t3c.year_frac(t))[0]))
        return torch.zeros((1, 1))

    imex_year(explicit_tend, vert_coeff, torch.zeros(()), torch.ones(2),
              torch.zeros((1, 2, 1)), SPAN, n_steps)
    # the plain year visits t0, then per step t_i, t_i + dt (Heun) and
    # t_i + dt (CN)
    assert seen[2::3] == seen[3::3]  # the CN step samples Heun stage 2's time
    plain = [seen[0]] + [v for step in range(n_steps)
                         for v in seen[1 + 3 * step:3 + 3 * step]]
    table = []
    for a, b, wq in zip(m0, m1, w):
        wq = torch.tensor(wq)
        table.append(float(((1.0 - wq) * arr[a] + wq * arr[b])[0]))
    assert plain == table
    # the kernel runs the year in one launch, two grid-wide barriers a step
    assert t3c.cuda_launches_per_year(n_steps) == 1
    assert t3c.grid_syncs_per_year(n_steps) == 2 * n_steps
    # the device table holds the same samples
    for got, want in zip(t3c.month_table(SPAN, n_steps, 4, "cpu"),
                         (m0, m1, w)):
        assert got.dtype == torch.as_tensor(want).dtype
        assert np.array_equal(got.numpy(), want)


def _smem(t_dim, nz, ty, tx, resident):
    """csrc/transport3d_year.cu's count"""
    tile = t_dim * nz * ty * tx
    return 4 * (t_dim * nz * (ty + 4) * (tx + 4) + (3 if resident else 1)
                * tile)


@pytest.mark.parametrize("shape, plan", [
    # gx3, T = 2: 130 resident tiles of 9 x 10 columns on 132 SMs
    ((2, 60, 116, 100), (9, 10, True, 130)),
    # phase 12's grid: 120 tiles of 2 x 2
    ((2, 10, 24, 20), (2, 2, True, 120)),
    # gx1, T = 1: the state does not fit, 8 x 32 tiles walked by 132 blocks
    ((1, 60, 384, 320), (8, 32, False, 132)),
])
def test_year_plan_tiles_whole_columns(shape, plan):
    """B4's tiles: the fewest columns whose tiles all fit the card at once
    with their state resident, else walked tiles"""
    got = t3c.year_plan(_smem, 232448, *shape, lambda resident, smem: 132)
    assert tuple(got) == plan
    assert _smem(*shape[:2], got.ty, got.tx, got.resident) <= 232448
    t_dim, nz, nlat, nlon = shape
    if got.resident:
        assert -(-nlat // got.ty) * -(-nlon // got.tx) == got.grid
        # every tile of fewer columns needs more blocks than the card holds
        assert all(-(-nlat // ty) * -(-nlon // tx) > 132
                   for ty in range(1, nlat + 1) for tx in range(1, nlon + 1)
                   if ty * tx < got.ty * got.tx)


def test_year_plan_walks_and_refuses():
    # a budget of 2000 bytes and 8 blocks: 2 x 2 tiles, walked
    assert tuple(t3c.year_plan(_smem, 2000, 2, 6, 13, 11,
                               lambda resident, smem: 8)) == (2, 2, False, 8)
    # seven blocks: resident tiles of 2 x 11, the last row ragged
    assert tuple(t3c.year_plan(_smem, 232448, 2, 6, 13, 11,
                               lambda resident, smem: 7)) == (2, 11, True, 7)
    with pytest.raises(ValueError, match="shared memory"):
        t3c.year_plan(_smem, 1000, 2, 60, 13, 11, lambda resident, smem: 8)
