"""the port's streaming 3D year (kernel B5's plain version and its wrapper on
the CPU) and the collapsed stencil operator against the JAX package, at the
JAX tests' size (4 x 8 x 6, T = 2, 480 steps, the masked cells and the
4-season problem of tests/test_transport3d_pallas.py): the stencil operator
in float64; _factor_rate_field; the plain float32 year in every mode against
JAX's B5 run in interpret mode and against the JAX float64 scan; the plain
float64 year against the JAX float64 scans; the wrapper's checks, with the
JAX builder's words, and its CPU route"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.models.irf_offline import (  # noqa: E402
    synthetic as jax_synthetic,
)
from newton_krylov_ooc_tpu.ops import transport3d as jax_t3  # noqa: E402
from newton_krylov_ooc_tpu.ops import (  # noqa: E402
    transport3d_stream_pallas as jax_stream,
)
from newton_krylov_ooc_tpu.ops.imex import imex_year as jax_imex_year  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.irf_offline.convert import (  # noqa: E402
    coef_from_numpy,
)
from newton_krylov_ooc_tpu_torch.ops import transport3d as t3  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import transport3d_cuda as t3c  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import (  # noqa: E402
    transport3d_stream_cuda as t3s,
)

torch.set_num_threads(1)

NZ, NLAT, NLON, T = 4, 8, 6, 2
N_STEPS = 480  # inside the synthetic circulation's explicit bound
YEAR = t3c.SEC_PER_YEAR
SPAN = (0.0, YEAR)
CPU = torch.device("cpu")
F64 = torch.float64


def _mask(seasonal=False):
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    if not seasonal:
        mask[2:, 5, 4] = 0
    return mask


def _jax_coef(circ, adv_type="upwind3"):
    return jax_t3.build_transport3d(
        circ["mask"], circ["dz"], circ["TAREA"], uet=circ["UET"],
        vnt=circ["VNT"], wtt=circ["WTT"], hdiff_e=circ["HDIFF_E"],
        hdiff_n=circ["HDIFF_N"], adv_type=adv_type, dtype=jnp.float64,
    )


def _numpy(coef):
    return {k: None if v is None else np.asarray(v) for k, v in coef.items()}


def _port(jc):
    return coef_from_numpy(_numpy(jc), device=CPU, dtype=F64)


def _problem(seasonal):
    """the JAX tests' problem (tests/test_transport3d_pallas.py:35-54 and
    :260-278): coefficients, kv, dz_r, dense rates, y0, wet, and the
    factors of recip_vol"""
    mask = _mask(seasonal)
    circ = jax_synthetic.gen_circulation(NZ, NLAT, NLON, mask=mask,
                                         n_seasons=4 if seasonal else None)
    assert jax_synthetic.stable_steps_per_year(circ) <= N_STEPS
    jc = _jax_coef(circ)
    kv, dz_r = jax_t3.vmix_vertical_coeff(circ["VDC"], circ["dz"])
    kv = np.asarray(jax_t3.mask_vmix_coeff(kv, circ["mask"]))
    rng = np.random.default_rng(11 if seasonal else 9)
    wet = (mask > 0).astype(np.float64)
    diag = -rng.uniform(0.0, 1.0e-7, (T, NZ, NLAT, NLON)) * wet
    src = rng.uniform(0.0, 1.0e-8, (T, NZ, NLAT, NLON)) * wet
    y0 = rng.uniform(0.0, 1.0, (T, NZ, NLAT, NLON)) * wet
    return {
        "circ": circ, "jc": jc, "kv": kv, "dz_r": np.asarray(dz_r),
        "diag": diag.reshape(T, NZ, -1), "src": src.reshape(T, NZ, -1),
        "y0": y0, "wet": wet, "recip_area": 1.0 / np.asarray(circ["TAREA"]),
        "recip_dz": 1.0 / np.asarray(circ["dz"]),
    }


def _jax_scan(jc, kv, dz_r, diag, src, y0, couple=None, wet=None, st=None,
              seasonal=False):
    """float64 imex_year ground truth (the JAX tests' _scan_reference), over
    transport_tend or, given st, over stencil_tend"""
    src2 = jnp.asarray(src.reshape(T, NZ, NLAT * NLON))

    def tend(t, y):
        y3 = y.reshape(y.shape[:-1] + (NLAT, NLON))
        if st is not None:
            out = jax_t3.stencil_tend(jnp.asarray(st), y3)
        elif seasonal:
            out = jax_t3.transport_tend(
                jax_t3.interp_transport_coef(jc, jnp.mod(t / YEAR, 1.0)), y3)
        else:
            out = jax_t3.transport_tend(jc, y3)
        out = out.reshape(y.shape) + src2
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
        tend, vert_coeff, jnp.asarray(diag.reshape(T, NZ, NLAT * NLON)),
        dz_r, jnp.asarray(y0.reshape(T, NZ, NLAT * NLON)), SPAN, N_STEPS,
    )).reshape(T, NZ, NLAT, NLON)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- the stencil operator ----------------------------------------------------------


@pytest.fixture(scope="module", params=["upwind3", "centered"])
def operator_case(request):
    """one float64 coefficient set with a nonzero vertical transport (the
    synthetic WTT is zero), in both packages"""
    circ = jax_synthetic.gen_circulation(NZ, NLAT, NLON, mask=_mask())
    rng = np.random.default_rng(5)
    circ["WTT"] = rng.uniform(-2.0e10, 2.0e10, circ["WTT"].shape)
    jc = _jax_coef(circ, request.param)
    return jc, _port(jc), rng.uniform(-1.0, 1.0, (T, NZ, NLAT, NLON))


def test_stencil_coef_matches_jax(operator_case):
    jc, tc, _ = operator_case
    expected = np.asarray(jax_t3.transport_stencil_coef(jc))
    got = t3.transport_stencil_coef(tc)
    assert got.shape == (len(t3.STENCIL_OFFSETS), NZ, NLAT, NLON)
    assert t3.STENCIL_OFFSETS == jax_t3.STENCIL_OFFSETS
    assert t3.STENCIL_RADIUS == jax_t3.STENCIL_RADIUS
    assert _rel(got.numpy(), expected) <= 1e-12
    # every coefficient carries its source cell's wet factor
    wet = _mask() > 0
    for ind, off in enumerate(t3.STENCIL_OFFSETS):
        src_wet = t3._offset(torch.tensor(wet, dtype=F64), off).numpy()
        assert np.abs(got[ind].numpy() * (1.0 - src_wet)).max() == 0.0


def test_stencil_tend_matches_jax_and_transport_tend(operator_case):
    jc, tc, y = operator_case
    st64 = t3.transport_stencil_coef(tc)
    expected = np.asarray(jax_t3.stencil_tend(
        jnp.asarray(st64.numpy()), jnp.asarray(y)))
    got = t3.stencil_tend(st64, torch.tensor(y)).numpy()
    assert _rel(got, expected) <= 1e-12
    assert np.abs(got * (1.0 - _mask())).max() == 0.0
    # in float32 the collapsed operator reproduces transport_tend to
    # reassociation roundoff (the JAX test's bound, :898-931)
    tc32 = {k: None if v is None else v.float() for k, v in tc.items()}
    y32 = torch.tensor(y, dtype=torch.float32)
    ref = t3.transport_tend(tc32, y32)
    st32 = t3.stencil_tend(st64.float(), y32)
    assert float((st32 - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# -- _factor_rate_field --------------------------------------------------------------


@pytest.mark.parametrize("case", ["assembled", "random", "wet_surface_row"])
def test_factor_rate_field_matches_jax(case):
    wet = (_mask() > 0).astype(np.float64)
    if case == "assembled":
        specs = [
            {"name": "a", "sink_rate_per_year": 0.02,
             "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0},
            {"name": "b", "source_per_year": 1.0e-3},
        ]
        diag, src, _ = t3.assemble_rate_fields(specs, wet.reshape(NZ, -1),
                                               1.0e3, YEAR)
        fields = [diag.reshape(T, NZ, NLAT, NLON),
                  src.reshape(T, NZ, NLAT, NLON)]
    elif case == "random":
        rng = np.random.default_rng(3)
        fields = [-rng.uniform(0.0, 1e-7, (T, NZ, NLAT, NLON)) * wet]
    else:
        field = np.zeros((T, NZ, NLAT, NLON))
        field[0, 0] = 3.0e-8 * wet[0]
        field[1] = 1.0e-9 * wet
        field[1, 0] = 5.0e-9 * wet[0]
        fields = [field]
    for field in fields:
        got = t3s._factor_rate_field(field, wet)
        expected = jax_stream._factor_rate_field(field, wet)
        assert got == expected
        assert (got is None) == (case == "random")


# -- the plain stream year against JAX's B5 ----------------------------------------


CASES = ("dense", "shed", "coupled", "seasonal", "stencil")


@pytest.fixture(scope="module")
def problems():
    return {False: _problem(False), True: _problem(True)}


def _case_args(problems, case):
    """(problem, builder keyword arguments, diag, src) of one case"""
    p = problems[case == "seasonal"]
    kwargs, diag, src = {}, p["diag"], p["src"]
    if case == "shed":
        diag = src = None
        kwargs = {"recip_area": p["recip_area"], "recip_dz": p["recip_dz"],
                  "t_dim": T}
    elif case == "coupled":
        couple = np.zeros((T, T))
        couple[1, 0] = 4.25e-3 / p["circ"]["dz"][0]
        couple[1, 1] = -2.0e-3 / p["circ"]["dz"][0]
        kwargs = {"couple": couple}
    elif case == "seasonal":
        kwargs = {"recip_area": p["recip_area"], "recip_dz": p["recip_dz"]}
    elif case == "stencil":
        kwargs = {"stencil": True}
    elif case == "bf16":
        diag = np.stack([-1.0e-8 * p["wet"]] * T).reshape(T, NZ, -1)
        src = np.stack([1.0e-8 * p["wet"]] * T).reshape(T, NZ, -1)
        kwargs = {"stencil": True, "coef_bf16": True}
    return p, kwargs, diag, src


@pytest.fixture(scope="module")
def jax_years(problems):
    """per case: JAX's B5 in interpret mode (float32) and the JAX float64
    scan year"""
    out = {}
    for case in CASES + ("bf16",):
        p, kwargs, diag, src = _case_args(problems, case)
        fn = jax_stream.build_transport3d_year_stream(
            p["jc"], p["kv"], p["dz_r"], diag, src, SPAN, N_STEPS, **kwargs)
        zeros = np.zeros((T, NZ, NLAT * NLON))
        scan = _jax_scan(
            p["jc"], p["kv"], p["dz_r"], zeros if diag is None else diag,
            zeros if src is None else src, p["y0"], kwargs.get("couple"),
            p["wet"], seasonal=case == "seasonal")
        out[case] = {"b5": np.asarray(fn(jnp.asarray(p["y0"]), interpret=True)),
                     "scan64": scan}
    return out


def _plain(problems, case, dtype):
    p, kwargs, diag, src = _case_args(problems, case)
    year = t3s.build_transport3d_year_stream_plain(
        _port(p["jc"]), p["kv"], p["dz_r"], diag, src, SPAN, N_STEPS,
        dtype=dtype, **kwargs)
    return year(torch.tensor(p["y0"], dtype=dtype)).numpy()


@pytest.mark.parametrize("case", CASES)
def test_plain_stream_f32_matches_jax_b5(problems, jax_years, case):
    """float32 in another rounding order than the TPU kernel's (PCR, FMA);
    both at the float32 discretization level of the float64 scan (the JAX
    tests' bounds: 1e-5, and 5e-4 for the reassociated stencil)"""
    got = _plain(problems, case, torch.float32)
    b5, scan = jax_years[case]["b5"], jax_years[case]["scan64"]
    assert np.abs(got - b5).max() <= 2e-5 * np.abs(b5).max()
    bound = 5e-4 if case == "stencil" else 1e-5
    assert np.abs(got - scan).max() <= bound * np.abs(scan).max()
    wet = problems[case == "seasonal"]["wet"]
    assert np.abs(got * (1.0 - wet)).max() == 0.0
    assert _rel(problems[case == "seasonal"]["y0"], scan) > 1e-3


def test_plain_stream_bf16_matches_jax_b5(problems, jax_years):
    p, _, _, _ = _case_args(problems, "bf16")
    # the operator rounded to bfloat16 once, from the same float32 fields
    st = t3s._stencil_fields(_port(p["jc"]), torch.float32, True).numpy()
    st_jax = np.asarray(jnp.asarray(
        np.asarray(jax_t3.transport_stencil_coef(p["jc"]), np.float32),
        jnp.bfloat16)).astype(np.float32)
    differ = st != st_jax
    print(f"bf16 stencil cells that differ from JAX's: {int(differ.sum())}")
    if differ.any():
        ulp = np.abs(st_jax[differ]) * 2.0 ** -7
        assert (np.abs(st[differ] - st_jax[differ]) <= ulp).all()
    got = _plain(problems, "bf16", torch.float32)
    b5, scan = jax_years["bf16"]["b5"], jax_years["bf16"]["scan64"]
    assert np.abs(got - b5).max() <= 1e-4 * np.abs(b5).max()
    assert np.abs(got - scan).max() <= 2e-2 * np.abs(scan).max()
    assert np.abs(got * (1.0 - p["wet"])).max() == 0.0


@pytest.mark.parametrize("stencil", [False, True])
def test_plain_stream_f64_matches_jax_scan(problems, jax_years, stencil):
    p = problems[False]
    got = _plain(problems, "stencil" if stencil else "dense", F64)
    if stencil:
        expected = _jax_scan(p["jc"], p["kv"], p["dz_r"], p["diag"], p["src"],
                             p["y0"], st=jax_t3.transport_stencil_coef(p["jc"]))
    else:
        expected = jax_years["dense"]["scan64"]
    assert _rel(got, expected) <= 1e-10
    assert np.abs(got * (1.0 - p["wet"])).max() == 0.0


# -- the wrapper --------------------------------------------------------------------


# case -> (seasonal problem, builder keyword changes, words of the error)
REFUSALS = {
    "block_rows": (False, {"block_rows": 12}, "positive multiple of 8"),
    "steps_per_sweep": (False, {"steps_per_sweep": 0}, "positive integer"),
    "divide": (False, {"steps_per_sweep": 7}, "must divide n_steps"),
    "seasonal_sweep": (True, {"steps_per_sweep": 2}, "steps_per_sweep=1"),
    "seasonal_dt": (True, {"n_steps": 2}, r"dt <= period/n_time"),
    "stencil_seasonal": (True, {"stencil": True}, "STEADY"),
    "bf16_flux": (False, {"coef_bf16": True}, "stencil mode only"),
    "bf16_dense_src": (False, {"stencil": True, "coef_bf16": True},
                       "dense src"),
    "recip_dz": (False, {"recip_area": "area"}, "requires recip_dz"),
    "factor": (False, {"recip_area": "area_wrong", "recip_dz": "dz"},
               "factor"),
    "t_dim": (False, {"diag": None, "src": None}, "t_dim"),
    "couple": (False, {"couple": np.zeros((3, 3))}, r"couple must be"),
    "tend_chunk": (False, {"tend_chunk": 7}, "tend_chunk"),
    "kv_months": (True, {"kv": "three_months"}, "disagree"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_jax_refuses(problems, case):
    seasonal, changes, words = REFUSALS[case]
    p = problems[seasonal]
    args = {"kv": p["kv"], "dz_r": p["dz_r"], "diag": p["diag"],
            "src": p["src"], "t_span": SPAN, "n_steps": N_STEPS}
    named = {"area": p["recip_area"], "area_wrong": 1.1 * p["recip_area"],
             "dz": p["recip_dz"], "three_months": p["kv"][:3]}
    for key, val in changes.items():
        args[key] = named[val] if isinstance(val, str) else val
    with pytest.raises(ValueError, match=words):
        jax_stream.build_transport3d_year_stream(p["jc"], **args)
    with pytest.raises(ValueError, match=words):
        t3s.build_transport3d_year_stream(_port(p["jc"]), **args, device="cpu")


@pytest.mark.parametrize("case", ["dense", "stencil", "bf16", "shed"])
def test_wrapper_on_cpu_is_the_plain_f32_year(problems, case):
    """any float y0 is cast to float32; the attributes say what a dense
    field the kernel reads, as JAX's do"""
    p, kwargs, diag, src = _case_args(problems, case)
    year = t3s.build_transport3d_year_stream(
        _port(p["jc"]), p["kv"], p["dz_r"], diag, src, SPAN, N_STEPS,
        **kwargs, device="cpu")
    got = year(torch.tensor(p["y0"], dtype=F64))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor(_plain(problems, case,
                                                torch.float32)))
    jax_fn = jax_stream.build_transport3d_year_stream(
        p["jc"], p["kv"], p["dz_r"], diag, src, SPAN, N_STEPS, **kwargs)
    for attr in ("stencil", "coef_bf16", "stream_diag", "stream_src"):
        assert getattr(year, attr) == getattr(jax_fn, attr), attr
    assert year.hbm_bytes_per_step > 0 and year.est_flops_per_step > 0
    before = t3s.transport3d_stream_launches
    for bad in (torch.zeros((T, NZ, NLAT * NLON)), torch.zeros(
            (T, NZ, NLAT, NLON), dtype=torch.int32), p["y0"]):
        with pytest.raises((ValueError, TypeError)):
            year(bad)
    assert t3s.transport3d_stream_launches == before


def test_wrapper_reads_dense_only_what_does_not_factor(problems):
    """assemble_rate_fields-form rates are rebuilt from their factors; a
    random field is read dense; the byte count follows; recip_vol factors of
    the wrong shape are refused"""
    p = problems[False]
    specs = [{"name": "a", "sink_rate_per_year": 0.02,
              "surf_restore_pv_cm_s": 2.0e-4, "surf_restore_target": 1.0},
             {"name": "b", "source_per_year": 1.0e-3}]
    diag, src, _ = t3.assemble_rate_fields(
        specs, p["wet"].reshape(NZ, -1), float(p["circ"]["dz"][0]), YEAR)
    tc = _port(p["jc"])
    fac = t3s.build_transport3d_year_stream(tc, p["kv"], p["dz_r"], diag, src,
                                            SPAN, N_STEPS, device="cpu")
    dense = t3s.build_transport3d_year_stream(
        tc, p["kv"], p["dz_r"], diag, src, SPAN, N_STEPS, factor_rates=False,
        device="cpu")
    messy = t3s.build_transport3d_year_stream(
        tc, p["kv"], p["dz_r"], p["diag"], src, SPAN, N_STEPS, device="cpu")
    assert not fac.stream_diag and not fac.stream_src
    assert dense.stream_diag and dense.stream_src
    assert messy.stream_diag and not messy.stream_src
    assert fac.operands["rates"].shape == (4, T)
    field = 4 * T * NZ * NLAT * NLON
    assert dense.hbm_bytes_per_step - fac.hbm_bytes_per_step == (
        2 * field - 4 * NZ * NLAT * NLON)
    y0 = torch.tensor(p["y0"], dtype=torch.float32)
    assert torch.equal(fac(y0), dense(y0))
    # the kernel reads the recip_vol factors without bounds checks: a row
    # that would broadcast is refused
    with pytest.raises(ValueError, match="factor"):
        t3s.build_transport3d_year_stream(
            tc, p["kv"], p["dz_r"], None, None, SPAN, N_STEPS,
            recip_area=p["recip_area"][:1], recip_dz=p["recip_dz"], t_dim=T,
            device="cpu")
    assert t3s.cuda_launches_per_year(N_STEPS) == 1 + N_STEPS


def test_season_samples_honour_the_period():
    """a seasonal cycle shorter than the year samples its months at the
    fraction of that period, the plain year's own arithmetic"""
    period = 0.5 * YEAR
    m0, m1, w = t3c.season_samples(SPAN, 8, 4, period)
    half = t3c.season_samples((0.0, period), 4, 4, period)
    # the two halves of the year repeat the half-year cycle's samples
    assert list(m0[:9]) == list(half[0]) and list(m1[:9]) == list(half[1])
    np.testing.assert_allclose(w[:9], half[2], atol=1e-6)
    assert list(m0[8:]) == list(m0[:9]) and list(m1[8:]) == list(m1[:9])
    # the default period is the year
    year = t3c.season_samples(SPAN, 8, 4)
    assert list(year[0]) == list(t3c.season_samples(SPAN, 8, 4, YEAR)[0])
    assert list(year[0]) != list(m0)
