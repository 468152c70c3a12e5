"""the slice as a whole: the port's in-core Newton-Krylov spin-up against
the JAX package's, float64, on the 10x6 grid; checkpoints across packages;
the port imports neither jax nor the JAX package; TF32 stays off"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.core.incore import (  # noqa: E402
    NewtonKrylovInCore as JaxNewtonKrylovInCore,
)
from newton_krylov_ooc_tpu.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel as JaxIageKernel,
)
from newton_krylov_ooc_tpu_torch.cli.incore_spinup import (  # noqa: E402
    MODELINFO,
    build_axes,
)
from newton_krylov_ooc_tpu_torch.core.incore import NewtonKrylovInCore  # noqa: E402
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.convert import (  # noqa: E402
    grid_from_numpy,
    state_from_numpy,
)
from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import (  # noqa: E402
    IageKernel,
)

torch.set_num_threads(1)

NZ, NY, N_STEPS = 10, 6, 146
SOLVER = {"newton_rel_tol": 1e-8, "krylov_rel_tol": 1e-2, "newton_max_iter": 8}
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CountingJaxSolver(JaxNewtonKrylovInCore):
    """the JAX host-driven solver, recording Krylov iterations per step"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.krylov_iterations = []

    def _gmres(self, x, fcn):
        increment, its = super()._gmres(x, fcn)
        self.krylov_iterations.append(its)
        return increment, its


@pytest.fixture(scope="module")
def models():
    depth, ypos = build_axes(NZ, NY)
    jk = JaxIageKernel(depth, ypos, MODELINFO, dtype=jnp.float64,
                       n_steps=N_STEPS, use_pallas=False)
    grid = grid_from_numpy(
        {k: np.asarray(v) for k, v in jk.grid._asdict().items()},
        device=CPU, dtype=torch.float64,
    )
    tk = IageKernel(depth, ypos, MODELINFO, device=CPU, dtype=torch.float64,
                    n_steps=N_STEPS, grid=grid)
    return jk, tk


@pytest.fixture(scope="module")
def jax_solve(models):
    jk, _ = models
    solver = _CountingJaxSolver(jk, **SOLVER)
    x, _, info = solver.solve(jk.init_iterate())
    return np.asarray(x), info, solver


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_solve_matches_jax(models, jax_solve):
    _, tk = models
    x_ref, info_ref, solver_ref = jax_solve
    solver = NewtonKrylovInCore(tk, **SOLVER)
    x, fcn, info = solver.solve(tk.init_iterate())

    assert info["iterations"] == info_ref["iterations"] >= 2
    assert list(info["krylov_iterations"]) == solver_ref.krylov_iterations
    hist = np.array([st["fcn_norm"] for st in info["stats"]])
    hist_ref = np.array([st["fcn_norm"] for st in info_ref["stats"]])
    assert hist.shape == hist_ref.shape
    assert (np.abs(hist - hist_ref) <= 1e-6 * hist_ref).all()
    assert _rel(x.numpy(), x_ref) < 1e-8
    assert (info["fcn_norm"] / info["x_norm"] < SOLVER["newton_rel_tol"]).all()


def test_jax_checkpoint_resumes_in_port(models, jax_solve, tmp_path):
    """a JAX in-core npz checkpoint, taken after one Newton step, resumes in
    the port at that iteration and finishes where the JAX solve did"""
    jk, tk = models
    x_ref, info_ref, _ = jax_solve
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="maximum Newton iterations"):
        JaxNewtonKrylovInCore(jk, **{**SOLVER, "newton_max_iter": 1}).solve(
            jk.init_iterate(), checkpoint_dir=ckpt
        )
    with np.load(os.path.join(ckpt, "incore_state.npz")) as data:
        assert int(data["iteration"]) == 1

    solver = NewtonKrylovInCore(tk, **SOLVER)
    x, _, info = solver.solve(tk.init_iterate(), checkpoint_dir=ckpt)
    assert solver.stats[0]["iteration"] == 1
    assert info["iterations"] == info_ref["iterations"]
    assert _rel(x.numpy(), x_ref) < 1e-8
    # the port's own snapshot reads back as the converged iterate
    with np.load(os.path.join(ckpt, "incore_state.npz")) as data:
        assert int(data["iteration"]) == info["iterations"]
        back = state_from_numpy(data["x"], device=CPU, dtype=torch.float64)
    assert torch.equal(back, x)


def test_unported_modes_raise(models):
    """the orbax backend is not ported and raises; the fused solves
    (jit_gmres, jit_newton) are ported (tests/test_torch_gmres.py,
    tests/test_torch_newton_jit.py) and no longer raise"""
    _, tk = models
    for flag in ("jit_gmres", "jit_newton"):
        NewtonKrylovInCore(tk, **{flag: True})
    with pytest.raises(NotImplementedError, match="A5.5"):
        NewtonKrylovInCore(tk).solve(tk.init_iterate(), checkpoint_dir="unused",
                                     checkpoint_backend="orbax")


def test_port_imports_no_jax():
    """every module of the port, and chip_smoke.py, load without jax and
    without the JAX package, and the phosphorus and 3D paths' hooks and a
    stream year run without loading either"""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import torch\n"
        "import newton_krylov_ooc_tpu_torch as pkg\n"
        "import newton_krylov_ooc_tpu_torch.cli.incore_spinup\n"
        "import newton_krylov_ooc_tpu_torch.models.py_driver_2d.phosphorus\n"
        "for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from newton_krylov_ooc_tpu_torch.cli.incore_spinup import MODELINFO, build_axes\n"
        "from newton_krylov_ooc_tpu_torch.models.py_driver_2d.incore import PhosphorusKernel\n"
        "k = PhosphorusKernel(*build_axes(4, 3), MODELINFO, device='cpu', n_steps=8)\n"
        "x = k.init_iterate()\n"
        "f = k.comp_fcn(x)\n"
        "k.precond_apply(k.precond_setup(x), k.jvp(x, f, f))\n"
        "from newton_krylov_ooc_tpu_torch.cli.irf3d_spinup import ABIO_SPECS\n"
        "from newton_krylov_ooc_tpu_torch.models.irf_offline import synthetic\n"
        "from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (\n"
        "    ShardedTransport3dKernel)\n"
        "circ = synthetic.gen_circulation(3, 4, 4, n_seasons=2)\n"
        "k = ShardedTransport3dKernel(circ, ABIO_SPECS, 8, device='cpu')\n"
        "x = k.init_iterate()\n"
        "f = k.comp_fcn(x)\n"
        "k.precond_apply(k.precond_setup(x), k.jvp(x, f, f))\n"
        "from newton_krylov_ooc_tpu_torch.ops import transport3d_stream_cuda\n"
        "from newton_krylov_ooc_tpu_torch.parallel.sharded_transport3d import (\n"
        "    family_year_inputs)\n"
        "c, kv, dz_r, d, s, cp = family_year_inputs(\n"
        "    synthetic.gen_circulation(3, 4, 4), ABIO_SPECS)\n"
        "year = transport3d_stream_cuda.build_transport3d_year_stream(\n"
        "    c, kv, dz_r, d, s, (0.0, 1.0e6), 8, cp, stencil=True, device='cpu')\n"
        "year(torch.zeros((2, 3, 4, 4)))\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                ('jax', 'jaxlib', 'newton_krylov_ooc_tpu'))\n"
        "assert not loaded, loaded\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("helper", ["spatial_axis", "region_mean_weights",
                                    "eval_expr"])
def test_copied_helpers_match_jax_package(helper):
    """the port's own copies of the JAX package's framework-free helpers
    give the JAX package's results"""
    if helper == "spatial_axis":
        from newton_krylov_ooc_tpu.core import spatial_axis as jax_axis
        from newton_krylov_ooc_tpu_torch.core import spatial_axis as axis

        for kwargs in ({"nlevs": 40, "edge_end": 4000.0,
                        "delta_ratio_max": 19.0},
                       {"axisname": "ypos", "nlevs": 6, "edge_start": 0.0,
                        "edge_end": 50.0e5, "delta_start": 1.0e5}):
            got = axis.spatial_axis_from_defn_dict(
                axis.spatial_axis_defn_dict(**kwargs))
            ref = jax_axis.spatial_axis_from_defn_dict(
                jax_axis.spatial_axis_defn_dict(**kwargs))
            for name in ("edges", "mid", "delta", "delta_r", "delta_mid",
                         "delta_mid_r"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(ref, name))
            assert (len(got), got.units, got.defn_dict_values) == (
                len(ref), ref.units, ref.defn_dict_values)
        with pytest.raises(ValueError, match="unknown key"):
            axis.spatial_axis_defn_dict(nlev=3)
    elif helper == "region_mean_weights":
        from newton_krylov_ooc_tpu.utils.regions import (
            region_mean_weights as jax_weights,
        )
        from newton_krylov_ooc_tpu_torch.utils.regions import (
            region_mean_weights,
        )

        rng = np.random.default_rng(2)
        mask = rng.integers(0, 4, (5, 7))
        weight = rng.uniform(0.5, 2.0, (5, 7))
        np.testing.assert_array_equal(region_mean_weights(mask, weight),
                                      jax_weights(mask, weight))
    else:
        from newton_krylov_ooc_tpu.utils.helpers import eval_expr as jax_eval
        from newton_krylov_ooc_tpu_torch.utils.helpers import eval_expr

        for expr in ("1.0 / (365.0 * 86400.0)", "-2 ** 3 + 4", "0.5e-3"):
            assert eval_expr(expr) == jax_eval(expr)
        with pytest.raises(TypeError):
            eval_expr("__import__('os')")


def _import_roots(tree):
    """the top-level package of every absolute import in a parsed module"""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_package():
    """no source file of the port, nor chip_smoke.py, imports jax or the
    JAX package (newton_krylov_ooc_tpu), even a module of it that would
    load without jax"""
    root = pathlib.Path(REPO)
    files = sorted((root / "newton_krylov_ooc_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    found = {
        str(path.relative_to(root)): roots
        for path in files
        if (roots := sorted(
            set(_import_roots(ast.parse(path.read_text())))
            & {"jax", "jaxlib", "newton_krylov_ooc_tpu"}
        ))
    }
    assert not found, found
    # the scan itself sees such an import
    probe = "from newton_krylov_ooc_tpu.utils import helpers\nimport jax.numpy\n"
    assert sorted(_import_roots(ast.parse(probe))) == [
        "jax", "newton_krylov_ooc_tpu"]


def test_tf32_off_after_compute_import():
    from newton_krylov_ooc_tpu_torch.ops import compute

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    compute.check_no_tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            compute.check_no_tf32()
    finally:
        compute.disable_tf32()
