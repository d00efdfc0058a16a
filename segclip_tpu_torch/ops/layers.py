"""Elementwise and normalisation primitives (segclip_tpu/ops/layers.py).

LayerNorm always computes in float32 and casts back to the input dtype;
QuickGELU is x · sigmoid(1.702 x).
"""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x · sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)
