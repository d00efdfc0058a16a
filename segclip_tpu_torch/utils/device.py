"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: Optional[str] = None) -> torch.device:
    """The device to run on: `name` if given ("cuda", "cuda:1", "cpu"),
    else the first CUDA card if there is one, else the CPU. A CUDA device
    that is not there raises. Turns TF32 off for both matmuls and cuDNN, so
    that float32 means float32 (the JAX package's eval runs its float32 dots
    at full precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name is None:
        name = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return device
