"""the 3D slice as a whole: the port's ShardedTransport3dKernel against the
JAX package's on a 1-CPU mesh (its solver hooks in float64, a float64
Newton-Krylov spin-up, float32 F against the JAX kernel B4 in interpret
mode), and the port's irf3d_spinup entry point on the CPU on one shard,
2 shards and 2 x 2 shards"""

import contextlib
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.parallel.sharded_transport3d import (  # noqa: E402
    ShardedTransport3dKernel as JaxKernel,
)
from newton_krylov_ooc_tpu_torch.cli import irf3d_spinup  # noqa: E402
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic  # noqa: E402
from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (  # noqa: E402
    ShardedTransport3dKernel,
)

torch.set_num_threads(1)

NZ, NLAT, NLON = 4, 8, 6
N_STEPS = 480
CPU = torch.device("cpu")
F64 = torch.float64
# the two-module family of tests/transport3d_fixtures.py, on two regions
FAMILY = [
    [{"sink_rate_per_year": 0.5, "source_per_year": 1.0}],
    [{"surf_restore_pv_cm_s": 5.0, "surf_restore_target": 2.0,
      "sink_rate_per_year": 0.1}],
]
# the DYE module of tests/test_transport3d_pallas.py's solve
DYE = [[{"name": "DYE", "source_per_year": 0.1, "sink_rate_per_year": 0.5,
         "surf_restore_pv_cm_s": 5.0e-3}]]
SOLVER = {"newton_rel_tol": 1e-8, "krylov_rel_tol": 1e-2,
          "newton_max_iter": 6, "krylov_max_dim": 12}


def _setup():
    mask = np.ones((NZ, NLAT, NLON), np.int32)
    mask[:, 3, 2] = 0
    mask[2:, 5, 4] = 0
    circ = synthetic.gen_circulation(NZ, NLAT, NLON, mask=mask)
    region_mask = circ["mask"].copy()
    north = region_mask[:, NLAT // 2:, :]
    north[north > 0] = 2
    return circ, region_mask


def _mesh():
    return Mesh(np.asarray(jax.devices("cpu")[:1]), ("space",))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def family():
    """the float64 family kernel in both packages, two regions"""
    circ, region_mask = _setup()
    jk = JaxKernel(_mesh(), circ, FAMILY, n_steps=N_STEPS, dtype=jnp.float64,
                   region_mask=region_mask)
    tk = ShardedTransport3dKernel(circ, FAMILY, N_STEPS, device="cpu",
                                  dtype=F64, region_mask=region_mask)
    rng = np.random.default_rng(13)
    wet = (circ["mask"] > 0).astype(np.float64)
    shape = (2, 1, NZ, NLAT, NLON)
    x = rng.uniform(0.0, 2.0, shape) * wet
    v = rng.standard_normal(shape) * wet
    return jk, tk, x, v


OPS = ("comp_fcn", "jvp", "dot", "norm", "region_broadcast", "precond_apply")


def _apply(kernel, op, x, v):
    if op == "comp_fcn":
        return kernel.comp_fcn(x)
    if op == "jvp":
        return kernel.jvp(x, None, v)
    if op == "dot":
        return kernel.dot(x, v)
    if op == "norm":
        return kernel.norm(v)
    if op == "region_broadcast":
        return kernel.region_broadcast(np.array([[0.5, 2.0], [3.0, -1.0]]))
    return kernel.precond_apply(kernel.precond_setup(x), v)


@pytest.mark.parametrize("op", OPS)
def test_kernel_hooks_match_jax(family, op):
    jk, tk, x, v = family
    expected = np.asarray(_apply(jk, op, jnp.asarray(x), jnp.asarray(v)))
    got = _apply(tk, op, torch.tensor(x), torch.tensor(v)).numpy()
    assert got.shape == expected.shape
    assert _rel(got, expected) <= 1e-10


def test_kernel_setup_matches_jax(family):
    jk, tk, _, _ = family
    assert (tk.module_batch, tk.t_dim, tk.region_cnt) == (2, 1, 2)
    assert not tk.use_kernel
    np.testing.assert_array_equal(tk.init_iterate().numpy(),
                                  np.asarray(jk.init_iterate()))
    x = tk.init_iterate()
    assert tk.scale(x, 2.0).equal(2.0 * x)
    factors = np.array([[0.5, 2.0], [1.0, 3.0]])
    assert tk.lin_comb([x, x], [factors, factors]).equal(
        2.0 * tk.scale(x, factors))
    np.testing.assert_array_equal(tk.apply_limiter(x, x), np.ones((2, 2)))


class _CountingJaxSolver(JaxNewtonKrylovInCore):
    """the JAX host-driven solver, recording Krylov iterations per step"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.krylov_iterations = []

    def _gmres(self, x, fcn):
        increment, its = super()._gmres(x, fcn)
        self.krylov_iterations.append(its)
        return increment, its


def test_f64_solve_matches_jax():
    circ, _ = _setup()
    jk = JaxKernel(_mesh(), circ, DYE, n_steps=N_STEPS, dtype=jnp.float64)
    solver_ref = _CountingJaxSolver(jk, **SOLVER)
    x_ref, _, info_ref = solver_ref.solve(jk.init_iterate())

    tk = ShardedTransport3dKernel(circ, DYE, N_STEPS, device="cpu", dtype=F64)
    x, _, info = NewtonKrylovInCore(tk, **SOLVER).solve(tk.init_iterate())
    assert info["iterations"] == info_ref["iterations"] >= 2
    assert list(info["krylov_iterations"]) == solver_ref.krylov_iterations
    assert _rel(x.numpy(), x_ref) <= 1e-8
    assert (info["fcn_norm"] / info["x_norm"] < SOLVER["newton_rel_tol"]).all()


def test_f32_fcn_matches_jax_b4():
    """float32 F on the CPU (the plain year) against the JAX kernel B4 in
    interpret mode, through the kernel interface"""
    circ, _ = _setup()
    jk = JaxKernel(_mesh(), circ, DYE, n_steps=N_STEPS, dtype=jnp.float32,
                   use_pallas=True, pallas_interpret=True)
    expected = np.asarray(jk.comp_fcn(jk.init_iterate()))
    tk = ShardedTransport3dKernel(circ, DYE, N_STEPS, device="cpu",
                                  dtype=torch.float32)
    got = tk.comp_fcn(tk.init_iterate()).numpy()
    assert np.abs(got - expected).max() <= 2e-5 * np.abs(expected).max()


def test_more_than_one_device_raises():
    """several devices are a mesh's (parallel/mesh.py), not a device list's;
    a mesh that does not split the grid is refused"""
    circ, _ = _setup()
    with pytest.raises(ValueError, match="mesh="):
        ShardedTransport3dKernel(circ, DYE, N_STEPS, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="does not split"):
        irf3d_spinup.main(["4", "8", "6", "3", "0", "--device", "cpu"])


@pytest.fixture(scope="module")
def cli_results():
    """the CLI's two spin-ups and its printout on one shard, 2 shards and
    2 x 2 shards"""
    out = {}
    for shards in ("1", "2", "2x2"):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            results = irf3d_spinup.main(["4", "8", "6", shards, "0",
                                         "--device", "cpu"])
        out[shards] = (results, printed.getvalue())
    return out


@pytest.mark.parametrize("shards", ["1", "2", "2x2"])
def test_cli_spins_up_on_cpu(cli_results, shards):
    """N and NYxNX shards (examples/irf3d_spinup.py:59-87); the meshes'
    float32 solutions agree with one shard's"""
    results, printed = cli_results[shards]
    assert len(results) == 2
    assert "DIC14/DIC ratio" in printed
    for (kernel, x, fcn, info), (_, x1, _, _) in zip(results,
                                                     cli_results["1"][0]):
        assert x.device == CPU and x.dtype == torch.float32
        assert not kernel.use_kernel
        assert (kernel.mesh is None) == (shards == "1")
        assert torch.isfinite(x).all() and torch.isfinite(fcn).all()
        rel = info["fcn_norm"] / info["x_norm"]
        assert (rel < irf3d_spinup.SOLVER["newton_rel_tol"]).all()
        assert float((x - x1).abs().max()) <= 1e-5 * float(x1.abs().max())


def test_cli_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        irf3d_spinup.main(["4", "8", "6"])
