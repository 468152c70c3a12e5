"""newton_krylov_ooc_tpu_torch: the PyTorch/CUDA port of newton_krylov_ooc_tpu.

The same Newton-Krylov spin-up mathematics as the JAX package beside it, with
plain PyTorch on tensors around hand-written CUDA kernels for NVIDIA Hopper
(csrc/).  The JAX package is the reference this port is held against; the
port itself never imports jax.  Its first slice is the py_driver_2d iage
in-core spin-up (cli/incore_spinup.py).
"""

__version__ = "0.1.0"
