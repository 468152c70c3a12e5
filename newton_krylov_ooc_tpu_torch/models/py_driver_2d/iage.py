"""iage tracer module constants for py_driver_2d: ideal age with fast and
slow surface restoring (2 tracers).

Port of the constants in newton_krylov_ooc_tpu/models/py_driver_2d/iage.py
that the in-core kernel needs.  The file-backed `iage` tracer-module state
belongs to the file-backed CLI slice.
"""

from __future__ import annotations

SURF_SLOW_FACTOR = 0.01


def surf_restore_rate(depth):
    """surface restoring rate: 24/day over 10 m, scaled to the surface layer"""
    return 24.0 / 86400.0 * 10.0 / depth.delta[0]
