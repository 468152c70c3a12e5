"""the port's Radau IIA(5) (newton_krylov_ooc_tpu_torch/ops/radau.py) held
against the JAX package's radau5_integrate on the same inputs, on the CPU.

On JAX's own test problems (tests/test_radau.py) the port takes the JAX
step sequence exactly: equal step attempts, tendency evaluations and LUs.
On test_problem's tendencies at the model's rtol = atol = 1e-12 the
sequence is decided by rounding: the error estimates of the first, tiny
steps are rounding noise, so a one-ulp change of one entry of y0 changes
the JAX integrator's own step sequence over 30 days of iage
(test_jax_step_sequence_is_rounding_decided).  Two implementations whose
arithmetic differs in the last bit (XLA's and PyTorch's) cannot share that
sequence, so there the values are held within 1e-10 of max|y| and the
counts within COUNT_BOUNDS of JAX's, bounds set from these readings over
30 days (t_eval of 4 points):

    iage        JAX 1336 attempts, 9398 nfev, 164 LUs; the port 1322, 9306,
                154 (-1.05%, -0.98%, -6.10%); JAX's own under 40 one-ulp
                nudges of one entry of y0: 1319-1340, 9244-9445, 148-169
    phosphorus  JAX 616, 4433, 143; the port 619, 4403, 147 (+0.49%,
                -0.68%, +2.80%); JAX's own under 40 nudges: 599-620,
                4273-4520, 125-154

In banded mode (jac_bands, the py_driver_2d modules' analytic row-band
Jacobians) on JAX's phosphorus test (tests/test_phosphorus_bands.py:102,
a month at rtol = atol = 1e-8, z-major at 8 x 4 and y-major at 4 x 8) the
port takes JAX's step sequence exactly: 41 attempts, 291 nfev, 17 LUs at
8 x 4 and 31, 222, 14 at 4 x 8, values within 1e-15 of max|y|.

The CPU runs the branch-free stages that a card replays from its graphs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newton_krylov_ooc_tpu.core.spatial_axis import (
    spatial_axis_defn_dict as jax_axis_defn_dict,
    spatial_axis_from_defn_dict as jax_axis_from_defn_dict,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.phosphorus import (
    phosphorus as jax_phosphorus,
)
from newton_krylov_ooc_tpu.models.test_problem import physics as jax_physics
from newton_krylov_ooc_tpu.ops.radau import radau5_integrate as jax_radau
from newton_krylov_ooc_tpu_torch.core.spatial_axis import (
    spatial_axis_defn_dict,
    spatial_axis_from_defn_dict,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import grid_from_numpy
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.phosphorus import phosphorus
from newton_krylov_ooc_tpu_torch.models.test_problem import physics
from newton_krylov_ooc_tpu_torch.ops import banded, radau
from newton_krylov_ooc_tpu_torch.ops.radau import Radau5, radau5_integrate

YEAR = 365.0 * 86400.0
COUNTS = ("n_attempts", "nfev", "nlu")
# test_problem's counts, as a fraction of JAX's (see the module docstring)
COUNT_BOUNDS = {"n_attempts": 0.02, "nfev": 0.02, "nlu": 0.08}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """the Radau's tensors are tiny: one intra-op thread, so that on a busy
    machine (the suite's parallel workers) no thread pool spins for them"""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def _jax_linear(t, y):
    return -y


def _port_linear(t, y):
    return -y


def _jax_robertson(t, y):
    return jnp.array(
        [
            -0.04 * y[0] + 1e4 * y[1] * y[2],
            0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
            3e7 * y[1] ** 2,
        ]
    )


def _port_robertson(t, y):
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    return torch.stack(
        [
            -0.04 * y0 + 1e4 * y1 * y2,
            0.04 * y0 - 1e4 * y1 * y2 - 3e7 * y1 ** 2,
            3e7 * y1 ** 2,
        ],
        dim=-1,
    )


_NLEV = 20
_DZ = 900.0 / _NLEV


def _jax_column(t, y):
    frac = 0.5 + 0.5 * jnp.cos(2 * jnp.pi * t / YEAR)
    k = 10.0 ** (-5.0 + 5.0 * frac) / _DZ
    flux = jnp.zeros(_NLEV + 1, y.dtype)
    flux = flux.at[1:-1].set(k * (y[1:] - y[:-1]))
    flux = flux.at[0].set(24.0 / 86400.0 * 10.0 * y[0])
    return (flux[1:] - flux[:-1]) / _DZ + 1.0 / YEAR


def _port_column(t, y):
    frac = 0.5 + 0.5 * torch.cos(2 * math.pi * t / YEAR)
    k = (10.0 ** (-5.0 + 5.0 * frac) / _DZ)[..., None]
    top = 24.0 / 86400.0 * 10.0 * y[..., :1]
    flux = torch.cat([top, k * (y[..., 1:] - y[..., :-1]), torch.zeros_like(top)],
                     dim=-1)
    return (flux[..., 1:] - flux[..., :-1]) / _DZ + 1.0 / YEAR


# JAX's problems (tests/test_radau.py:12-95): funs, span, y0, t_eval, tol
PROBLEMS = {
    "linear": (_jax_linear, _port_linear, (0.0, 2.0), [1.0], [0.0, 1.0, 2.0],
               1e-10, 1e-10),
    "robertson": (_jax_robertson, _port_robertson, (0.0, 100.0), [1.0, 0.0, 0.0],
                  [0.0, 1.0, 10.0, 100.0], 1e-8, 1e-10),
    "column": (_jax_column, _port_column, (0.0, YEAR),
               np.linspace(0.0, 100.0, _NLEV), np.linspace(0.0, YEAR, 5),
               1e-10, 1e-10),
}


def _run_jax(fun, span, y0, t_eval, dtype, **kwargs):
    ys, info = jax_radau(fun, span, jnp.asarray(y0, dtype), jnp.asarray(t_eval, dtype),
                         **kwargs)
    assert bool(info["success"])
    return np.asarray(ys, np.float64), {key: int(info[key]) for key in COUNTS}


def _run_port(fun, span, y0, t_eval, dtype, **kwargs):
    ys, info = radau5_integrate(fun, span, torch.tensor(np.asarray(y0), dtype=dtype),
                                np.asarray(t_eval), **kwargs)
    assert info["success"]
    return ys.double().numpy(), {key: info[key] for key in COUNTS}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_jax_problems_step_sequence(name):
    """float64: the JAX step sequence exactly, values within 1e-10"""
    jax_fun, port_fun, span, y0, t_eval, rtol, atol = PROBLEMS[name]
    ys_jax, counts_jax = _run_jax(jax_fun, span, y0, t_eval, jnp.float64,
                                  rtol=rtol, atol=atol)
    ys, counts = _run_port(port_fun, span, y0, t_eval, torch.float64,
                           rtol=rtol, atol=atol)
    assert counts == counts_jax
    np.testing.assert_allclose(ys, ys_jax, rtol=1e-10, atol=1e-10 * np.abs(ys_jax).max())


@pytest.mark.parametrize("name", ["linear"])
def test_jax_problems_float32(name):
    """float32 at rtol = atol = 1e-5: values within 1e-5 of JAX's; float32
    rounding decides the step sequence here (counts within 10%)"""
    jax_fun, port_fun, span, y0, t_eval, _rtol, _atol = PROBLEMS[name]
    ys_jax, counts_jax = _run_jax(jax_fun, span, y0, t_eval, jnp.float32,
                                  rtol=1e-5, atol=1e-5)
    ys, counts = _run_port(port_fun, span, y0, t_eval, torch.float32,
                           rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ys, ys_jax, rtol=1e-5, atol=1e-5 * np.abs(ys_jax).max())
    for key in COUNTS:
        assert abs(counts[key] - counts_jax[key]) <= 0.1 * counts_jax[key]


def _depths():
    defn = dict(nlevs=_NLEV)
    return (jax_axis_from_defn_dict(jax_axis_defn_dict(**defn)),
            spatial_axis_from_defn_dict(spatial_axis_defn_dict(**defn)))


def _tendencies(name, jax_depth, depth):
    """(JAX tendency, port tendency, y0 from the gen_init_iterate profiles)"""
    jax_grid = jax_physics.column_grid(jax_depth)
    grid = physics.column_grid(depth, device="cpu")
    mid = depth.mid
    if name == "iage":
        return (jax_physics.make_iage_tend(jax_grid), physics.make_iage_tend(grid),
                np.interp(mid, [125.0, 650.0], [0.0, 1000.0]))
    if name == "dye_decay":
        return (jax_physics.make_dye_decay_tend(jax_grid, 0.005),
                physics.make_dye_decay_tend(grid, 0.005), np.zeros(_NLEV))
    profiles = [([125.0, 375.0], [0.0, 4.1]), ([100.0, 250.0], [7.3e-2, 0.0]),
                ([175.0, 425.0], [1.8e-2, 0.0])]
    y0 = np.concatenate([np.interp(mid, d, v) for d, v in profiles * 2])
    restoring_opt = 1 if name == "phosphorus" else 0
    return (jax_physics.make_phosphorus_tend(jax_grid, restoring_opt),
            physics.make_phosphorus_tend(grid, restoring_opt), y0)


@pytest.mark.parametrize("name", ["iage", "dye_decay", "phosphorus", "phosphorus_opt0"])
def test_tendencies_match_jax(name):
    """each tendency at seeded states and times, one at a time and as a
    batch of three, within 1e-13 of max|F| of JAX's"""
    jax_fun, fun, y0 = _tendencies(name, *_depths())
    rng = np.random.default_rng(0)
    times = rng.uniform(0.0, YEAR, 3)
    states = np.abs(y0 + rng.normal(size=(3, y0.size)))
    ref = np.stack([np.asarray(jax_fun(jnp.asarray(t), jnp.asarray(y)))
                    for t, y in zip(times, states)])
    batch = fun(torch.tensor(times), torch.tensor(states)).numpy()
    single = np.stack([fun(torch.tensor(t), torch.tensor(y)).numpy()
                       for t, y in zip(times, states)])
    scale = np.abs(ref).max()
    assert np.abs(batch - ref).max() <= 1e-13 * scale
    # vectorised and scalar CPU math may round the last bit differently
    assert np.abs(batch - single).max() <= 1e-15 * scale


def test_jax_step_sequence_is_rounding_decided():
    """the premise of COUNT_BOUNDS: JAX's own integrator takes
    another step sequence over test_problem's 30 days of iage when one
    entry of y0 moves by one ulp, with values within 1e-10"""
    jax_fun, _fun, y0 = _tendencies("iage", *_depths())
    span = (0.0, 30 * 86400.0)
    t_eval = jnp.asarray(np.linspace(*span, 4))
    run = jax.jit(lambda y: jax_radau(jax_fun, span, y, t_eval, rtol=1e-12, atol=1e-12))
    nudged = y0.copy()
    nudged[8] = np.nextafter(nudged[8], np.inf)
    (ys, info), (ys_nudged, info_nudged) = run(jnp.asarray(y0)), run(jnp.asarray(nudged))
    assert int(info["n_attempts"]) != int(info_nudged["n_attempts"])
    np.testing.assert_allclose(np.asarray(ys_nudged), np.asarray(ys), rtol=1e-10,
                               atol=1e-10 * float(np.abs(ys).max()))


@pytest.mark.parametrize("name", ["iage", "phosphorus"])
def test_test_problem_tendencies_30_days(name):
    """30 days from the gen_init_iterate profiles at the model's
    rtol = atol = 1e-12: values within 1e-10 of max|y| of JAX's, counts
    within COUNT_BOUNDS (the sequence is rounding-decided; see the module
    docstring)"""
    jax_fun, fun, y0 = _tendencies(name, *_depths())
    span = (0.0, 30 * 86400.0)
    t_eval = np.linspace(*span, 4)
    ys_jax, counts_jax = _run_jax(jax_fun, span, y0, t_eval, jnp.float64,
                                  rtol=1e-12, atol=1e-12)
    ys, counts = _run_port(fun, span, y0, t_eval, torch.float64,
                           rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ys, ys_jax, rtol=1e-10, atol=1e-10 * np.abs(ys_jax).max())
    for key in COUNTS:
        assert abs(counts[key] - counts_jax[key]) <= COUNT_BOUNDS[key] * counts_jax[key]


@pytest.mark.parametrize("name", ["robertson", "phosphorus"])
def test_branch_free_stages_match_cpu_path(name, monkeypatch):
    """the branch-free stages (every branch computed, masks selecting), as
    the CPU and a card run them, take one step sequence bit for bit at 2
    fast attempts a replay (the default) and at 8, where the attempts past
    the end of a run are no-ops"""
    if name == "robertson":
        _jax, fun, span, y0, t_eval, rtol, atol = PROBLEMS[name]
    else:
        _jax, fun, y0 = _tendencies(name, *_depths())
        span, rtol, atol = (0.0, 86400.0), 1e-12, 1e-12
        t_eval = np.linspace(*span, 3)
    results = []
    for per_replay in (2, 8):
        monkeypatch.setattr(radau, "ATTEMPTS_PER_REPLAY", per_replay)
        solver = Radau5(fun, len(y0), span, t_eval, device="cpu", rtol=rtol,
                        atol=atol)
        ys, info = solver.integrate(torch.tensor(np.asarray(y0, dtype=np.float64)))
        results.append((ys.numpy(), info, solver.runs["attempts"]))
        assert solver.runs["attempts"] > 0 and solver.runs["refresh_jac"] > 0
    (ys2, info2, runs2), (ys8, info8, runs8) = results
    assert np.array_equal(ys8, ys2)
    assert info8 == info2
    assert runs8 < runs2


def test_integrator_reuse_and_refusals():
    """a Radau5 integrates again from a new y0 on its fixed buffers; a
    wrong-sized y0 is refused, and the device must be named"""
    _jax, fun, span, y0, t_eval, rtol, atol = PROBLEMS["robertson"]
    solver = Radau5(fun, 3, span, t_eval, device="cpu", rtol=rtol, atol=atol)
    first = solver.integrate(torch.tensor(y0))
    solver.integrate(torch.tensor([0.5, 0.0, 0.5]))
    again = solver.integrate(torch.tensor(y0))
    assert np.array_equal(first[0].numpy(), again[0].numpy())
    assert first[1] == again[1]
    with pytest.raises(ValueError):
        solver.integrate(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError):
        Radau5(fun, 3, span, t_eval, rtol=rtol, atol=atol)
    assert jax.config.jax_enable_x64


# -- banded mode ------------------------------------------------------------------


def _phosphorus_banded(nz, ny, with_jax=True):
    """tests/test_phosphorus_bands.py's month of phosphorus at (nz, ny):
    JAX's banded integration (with_jax), and the port's tendency, banded
    Jacobian, permutation and y0 on the same grid"""
    from tests.test_phosphorus_bands import SPY, _setup

    grid, static_args = _setup(nz, ny)
    port_grid = grid_from_numpy({k: np.asarray(v) for k, v in grid._asdict().items()},
                                device="cpu", dtype=torch.float64)
    dm = np.asarray(grid.depth_mid)
    y0 = np.stack([np.broadcast_to(np.interp(dm, xp, fp)[:, None], (nz, ny))
                   for xp, fp in (([130.0, 260.0], [5.5e-3, 4.1]),
                                  ([95.0, 140.0], [7.1e-2, 1.5e-4]),
                                  ([170.0, 250.0], [1.8e-2, 7.9e-4]))]).reshape(-1)
    t1 = SPY / 12
    bw, perm = jax_phosphorus.band_info(grid)
    inv = np.argsort(perm)
    fun = jax_phosphorus.build_tend(grid, static_args, jnp.zeros(0))
    jac_b = jax_phosphorus.build_jac_bands(grid, static_args, jnp.zeros(0))
    perm_j, inv_j = jnp.asarray(perm), jnp.asarray(inv)
    y_jax = counts_jax = None
    if with_jax:
        ys_j, info_j = jax.jit(lambda y: jax_radau(
            lambda t, yb: fun(t, yb[inv_j])[perm_j], (0.0, t1), y,
            jnp.linspace(0.0, t1, 2), rtol=1e-8, atol=1e-8, jac_bands=jac_b,
            bandwidth=bw))(jnp.asarray(y0[perm]))
        y_jax = np.asarray(ys_j[-1])[inv]
        counts_jax = {k: int(info_j[k]) for k in COUNTS}
    port_fun = phosphorus.build_tend(port_grid, static_args, None)
    perm_t, inv_t = torch.as_tensor(perm), torch.as_tensor(inv)

    def fun_banded(t, yb):
        return port_fun(t, yb[..., inv_t])[..., perm_t]

    port = dict(fun=fun_banded, t1=t1, y0=y0[perm], bw=bw, inv=inv,
                jac_bands=phosphorus.build_jac_bands(port_grid, static_args, None),
                dense=(port_fun, phosphorus.build_jac(port_grid, static_args, None),
                       y0))
    return y_jax, counts_jax, port


@pytest.mark.parametrize("nz, ny", [(8, 4), (4, 8)])
def test_banded_mode_matches_jax_and_dense(nz, ny):
    """the banded Radau year against JAX's banded one: the same attempts,
    nfev and LUs, values within 1e-10 of max|y|; z-major against the
    port's dense mode within JAX's 1e-7 (tests/test_phosphorus_bands.py)"""
    y_jax, counts_jax, port = _phosphorus_banded(nz, ny)
    solver = Radau5(port["fun"], len(port["y0"]), (0.0, port["t1"]),
                    np.linspace(0.0, port["t1"], 2), device="cpu", rtol=1e-8,
                    atol=1e-8, jac_bands=port["jac_bands"], bandwidth=port["bw"])
    ys, info = solver.integrate(torch.as_tensor(port["y0"]))
    assert info["success"]
    assert {k: info[k] for k in COUNTS} == counts_jax
    y_b = ys[-1].numpy()[port["inv"]]
    assert np.abs(y_b - y_jax).max() < 1e-10 * np.abs(y_jax).max()
    if nz < ny:
        return
    fun, jac, y0 = port["dense"]
    ys_d, info_d = radau5_integrate(fun, (0.0, port["t1"]), torch.as_tensor(y0),
                                    np.linspace(0.0, port["t1"], 2), rtol=1e-8,
                                    atol=1e-8, jac=jac)
    assert info_d["success"]
    y_d = ys_d[-1].numpy()
    assert np.abs(y_b - y_d).max() / np.abs(y_d).max() < 1e-7


def test_banded_pair_launches_change_no_step(monkeypatch):
    """Radau's banded mode through the pair forms (both stage systems'
    factors in one call, a Newton iteration's two solves in one) against the
    single calls it made before, real then complex: the same attempts, nfev
    and LUs, and bit-identical states"""
    _y_jax, _counts, port = _phosphorus_banded(8, 4, with_jax=False)

    def run():
        solver = Radau5(port["fun"], len(port["y0"]), (0.0, port["t1"]),
                        np.linspace(0.0, port["t1"], 3), device="cpu",
                        rtol=1e-8, atol=1e-8, jac_bands=port["jac_bands"],
                        bandwidth=port["bw"])
        return solver.integrate(torch.as_tensor(port["y0"]))

    ys, info = run()

    def factor_pair(bands_r, bands_c, *, out_r=None, out_c=None, due=None):
        return (banded.banded_lu_factor_blocks(bands_r, out=out_r, due=due),
                banded.banded_lu_factor_blocks(bands_c, out=out_c, due=due))

    def solve_stages(self, st, rhs_real, rhs_c, active):
        return (self._solve_lu(st, "r", rhs_real, active),
                self._solve_lu(st, "c", rhs_c, active))

    monkeypatch.setattr(radau, "banded_lu_factor_pair", factor_pair)
    monkeypatch.setattr(Radau5, "_solve_stages", solve_stages)
    ys_s, info_s = run()
    assert info == info_s
    assert torch.equal(ys, ys_s)


def test_banded_mode_refusals():
    _y_jax, _counts, port = _phosphorus_banded(4, 3, with_jax=False)
    args = (port["fun"], len(port["y0"]), (0.0, 86400.0), [0.0, 86400.0])
    with pytest.raises(ValueError, match="bandwidth"):
        Radau5(*args, device="cpu", jac_bands=port["jac_bands"])
    solver = Radau5(*args, device="cpu", jac_bands=port["jac_bands"],
                    bandwidth=port["bw"] + 1)
    with pytest.raises(ValueError, match="jac_bands gave shape"):
        solver.integrate(torch.as_tensor(port["y0"]))
