"""the port's ops/probing.py and cli/irf_coloring.py held against the JAX
package's on the CPU: the distance-2 graph identical, the colorings
identical for the same algorithm and library (both load the native gCol
library; the same seeds), the python DSatur fallback identical, and exact
Jacobian recovery (bit for bit against JAX's recovery through the same
products).
"""

import os

import numpy as np
import pytest
import torch
from scipy import sparse as sp

import newton_krylov_ooc_tpu.ops.probing as jax_probing
import newton_krylov_ooc_tpu_torch.ops.probing as port_probing
from newton_krylov_ooc_tpu_torch.cli import irf_coloring

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
needs_native = pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "native", "build", "libgcol.so")),
    reason="native components not built",
)

ALGORITHMS = ["greedy", "dsatur", "rlf", "backtracking", "hybrid_ea",
              "hillclimber", "antcol"]


def _patterns():
    rng = np.random.default_rng(3)
    random = sp.random(40, 30, density=0.08, random_state=rng, format="csr")
    return {"stencil 6x7": irf_coloring.transport_sparsity(6, 7),
            "random 40x30": random}


@pytest.mark.parametrize("name", list(_patterns()))
def test_distance2_graph_identical(name):
    pattern = _patterns()[name]
    for got, ref in zip(port_probing.build_distance2_graph(pattern),
                        jax_probing.build_distance2_graph(pattern)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@needs_native
@pytest.mark.parametrize("algorithm", ALGORITHMS + ["tabucol", "partialcol"])
def test_colorings_identical(algorithm):
    """the same library, algorithm and seed: the same coloring"""
    row_ptr, col_ind = jax_probing.build_distance2_graph(
        irf_coloring.transport_sparsity(6, 7))
    kwargs = {"max_iters": 5000}
    if algorithm in ("tabucol", "partialcol"):
        kwargs["target_k"] = 7
    n_p, colors_p = port_probing.color_graph(row_ptr, col_ind,
                                             algorithm=algorithm, **kwargs)
    n_j, colors_j = jax_probing.color_graph(row_ptr, col_ind,
                                            algorithm=algorithm, **kwargs)
    assert n_p == n_j
    np.testing.assert_array_equal(colors_p, colors_j)
    assert port_probing.gcol_library()[1] in port_probing.GCOL_LIB_PATHS


@needs_native
def test_color_graph_refusals():
    row_ptr, col_ind = jax_probing.build_distance2_graph(
        irf_coloring.transport_sparsity(3, 3))
    for kwargs, match in (({"algorithm": "tabucol"}, "target_k"),
                          ({"algorithm": "partialcol", "target_k": 0},
                           "target_k"),
                          ({"algorithm": "nope"}, "unknown")):
        with pytest.raises(ValueError, match=match):
            port_probing.color_graph(row_ptr, col_ind, **kwargs)
    assert port_probing.color_graph(np.zeros(1, np.int64),
                                    np.zeros(0, np.int32))[0] == 0


def test_python_fallback_identical(monkeypatch):
    """without a native library both packages run the same python DSatur"""
    monkeypatch.setattr(port_probing, "gcol_library", lambda: (None, None))
    monkeypatch.setattr(jax_probing, "_GCOL_LIB", None)
    monkeypatch.setattr(jax_probing, "_GCOL_CHECKED", True)
    row_ptr, col_ind = jax_probing.build_distance2_graph(
        irf_coloring.transport_sparsity(5, 6))
    n_p, colors_p = port_probing.color_graph(row_ptr, col_ind)
    n_j, colors_j = jax_probing.color_graph(row_ptr, col_ind)
    assert n_p == n_j
    np.testing.assert_array_equal(colors_p, colors_j)
    for v in range(len(row_ptr) - 1):
        for u in col_ind[row_ptr[v]:row_ptr[v + 1]]:
            assert colors_p[v] != colors_p[u]


@pytest.mark.parametrize("name", list(_patterns()))
def test_probe_jacobian_recovers_exactly(name):
    """one product a color recovers the Jacobian exactly, as JAX's does;
    the port's probe is a float64 tensor on the named device"""
    pattern = _patterns()[name].tocsr()
    rng = np.random.default_rng(7)
    jac = pattern.multiply(rng.normal(size=pattern.shape)).tocsr()
    jac_t = torch.as_tensor(jac.toarray())
    seen = []

    def jvp(v):
        seen.append((v.dtype, v.device.type))
        return jac_t @ v

    got, n_p = port_probing.probe_jacobian(jvp, pattern != 0, device="cpu")
    ref, n_j = jax_probing.probe_jacobian(lambda v: jac @ v, pattern != 0)
    assert n_p == n_j == len(seen)
    assert set(seen) == {(torch.float64, "cpu")}
    np.testing.assert_array_equal(got, jac.toarray())
    np.testing.assert_array_equal(got, ref)


def test_probe_jacobian_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        port_probing.probe_jacobian(lambda v: v, np.eye(3))


def test_irf_coloring_cli_matches_example(capsys):
    """the CLI's color counts are the JAX example's on the same grid, and
    its recovery is exact"""
    counts, n_colors, err = irf_coloring.main(["6", "8", "--device", "cpu"])
    row_ptr, col_ind = jax_probing.build_distance2_graph(
        irf_coloring.transport_sparsity(6, 8))
    for algorithm, n in counts.items():
        assert n == jax_probing.color_graph(row_ptr, col_ind,
                                            algorithm=algorithm)[0]
    assert n_colors == counts["dsatur"]
    assert err == 0.0
    assert "max recovery error 0.0e+00" in capsys.readouterr().out
