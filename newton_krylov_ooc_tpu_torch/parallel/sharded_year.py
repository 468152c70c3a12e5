"""solver-interface methods shared by the in-core family kernels.

Port of newton_krylov_ooc_tpu/parallel/sharded_year.py::
_ShardedKernelInterface, on tensors of one device with no mesh: the
per-(module, region) dot products and broadcasts, scaling, linear
combinations and the preconditioner hooks that NewtonKrylovInCore calls.
The JAX module's sharded iage, phosphorus and forced-family kernels, and
the mesh itself, are ROADMAP A5.2.
"""

from __future__ import annotations

import numpy as np
import torch


class _ShardedKernelInterface:
    """solver-interface methods shared by the family kernels.

    Subclass __init__ sets module_batch, region_cnt, dtype and device, the
    maps _comp_fcn, _dot and _region_broadcast, and _precond_factor (or
    None) and _precond_apply; the interface then serves NewtonKrylovInCore
    identically for every kernel."""

    def comp_fcn(self, x):
        return self._comp_fcn(x)

    def dot(self, a, b):
        return self._dot(a, b)

    def norm(self, v):
        return torch.sqrt(self._dot(v, v))

    @staticmethod
    def add(a, b):
        return a + b

    def scale(self, v, factor):
        """scale by a scalar or by per-(module, region) factors"""
        if isinstance(factor, torch.Tensor):
            factor = factor.detach().cpu().numpy()
        factor = np.asarray(factor)
        if factor.ndim == 0:
            return v * float(factor)
        return v * self._region_broadcast(factor)

    def region_broadcast(self, scalars):
        """(module, region) scalars -> a field broadcastable over the state,
        1 outside every region"""
        return self._region_broadcast(scalars)

    def apply_limiter(self, x, increment):
        """no bounds on these tracers; factors are 1"""
        return np.ones((self.module_batch, self.region_cnt))

    def lin_comb(self, basis, coeff):
        res = self.scale(basis[0], coeff[0])
        for j in range(1, len(basis)):
            res = res + self.scale(basis[j], coeff[j])
        return res

    def precond_setup(self, x):
        factor = getattr(self, "_precond_factor", None)
        return None if factor is None else factor(x)

    def precond_apply(self, data, r):
        return self._precond_apply(data, r)
