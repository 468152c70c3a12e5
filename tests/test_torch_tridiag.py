"""the port's tridiagonal solvers against the JAX package's and against
the numpy Thomas oracle, float64, on diagonally dominant batches"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from newton_krylov_ooc_tpu.ops import tridiag as jax_tridiag  # noqa: E402
from newton_krylov_ooc_tpu_torch.ops import tridiag  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-12  # relative to max|x|: float64 roundoff of O(n) recurrences


def _systems(seed, shape):
    """diagonally dominant tridiagonal systems of shape (..., n)"""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-1.0, 1.0, shape)
    du = rng.uniform(-1.0, 1.0, shape)
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.5, 2.0, shape)
    b = rng.normal(size=shape)
    return dl, d, du, b


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _torch(*arrs):
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrs]


@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_pcr_matches_jax_and_numpy(n):
    args = _systems(n, (5, 3, n))
    x = tridiag.pcr_solve(*_torch(*args)).numpy()
    x_jax = jax_tridiag.pcr_solve(*[jnp.asarray(a) for a in args])
    x_np = jax_tridiag.thomas_solve_np(*args)
    assert _rel(x, x_jax) < TOL
    assert _rel(x, x_np) < TOL


@pytest.mark.parametrize("n", [1, 5, 40])
def test_thomas_batch_matches_jax_and_numpy(n):
    args = _systems(100 + n, (6, n))
    x = tridiag.thomas_solve_batch(*_torch(*args)).numpy()
    x_jax = jax_tridiag.thomas_solve_batch(*[jnp.asarray(a) for a in args])
    assert _rel(x, x_jax) < TOL
    assert _rel(x, jax_tridiag.thomas_solve_np(*args)) < TOL


def test_thomas_batches_leading_axes():
    """thomas_solve solves along the last axis under any leading batch,
    as the JAX version does under vmap"""
    args = _systems(7, (2, 3, 12))
    x = tridiag.thomas_solve(*_torch(*args)).numpy()
    one = jax_tridiag.thomas_solve(*[jnp.asarray(a[1, 2]) for a in args])
    assert _rel(x[1, 2], one) < TOL
    assert _rel(x, jax_tridiag.thomas_solve_np(*args)) < TOL
    with pytest.raises(ValueError):
        tridiag.thomas_solve_batch(*_torch(*args))
