"""compute placement and float32 matmul precision.

Port of newton_krylov_ooc_tpu/ops/compute.py.  The JAX module pins the
float64 precision path to the host CPU and keeps a persistent XLA cache;
neither applies here.  What carries over is device resolution -- explicit,
and never dropping to the CPU when a card was asked for -- and full-precision
float32 linear algebra: the JAX package traces its preconditioner under
"highest" matmul precision (models/py_driver_2d/incore.py::_matmul_highest)
because reduced-precision products stall Newton.  On an NVIDIA card the same
trap is TF32, so importing this module turns it off for matmuls and cuDNN.
"""

from __future__ import annotations

import torch


def disable_tf32():
    """run float32 matmuls and convolutions in full float32 (process-global)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_no_tf32()


def check_no_tf32():
    """raise if either TF32 switch is on: solver linear algebra needs full f32"""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}); "
            "the dense-LU preconditioner and GMRES need full float32"
        )


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", or a torch.device)

    A CUDA request raises when no card is visible: a run that asked for the
    card never silently measures or solves on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cpu or cuda")
    return dev


disable_tf32()
