"""Shared building blocks (segclip_tpu/models/layers.py).

Parameters are fp32 and named as in the reference torch state dict
(`ln_1.weight`, `attn.in_proj_weight`, `mlp.c_fc.weight`, …). Activations
and matmuls run in `compute_dtype`, cast explicitly where the JAX code casts;
LayerNorm computes in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from segclip_tpu_torch.ops.attention import multi_head_attention
from segclip_tpu_torch.ops.layers import layer_norm, quick_gelu


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """x @ Wᵀ + b in `dtype`, as flax Dense(dtype=compute_dtype)."""
    x = x.to(dtype) @ layer.weight.to(dtype).t()
    return x + layer.bias.to(dtype)


class LayerNormFP32(nn.Module):
    """LayerNorm with fp32 internals whatever the activation dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class MHAttention(nn.Module):
    """Packed-QKV multi-head attention (self or cross), torch
    nn.MultiheadAttention's parameter names."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, q_in: torch.Tensor, kv_in: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(
            q_in, kv_in, self.in_proj_weight, self.in_proj_bias,
            self.out_proj.weight, self.out_proj.bias, self.heads, bias=bias,
            compute_dtype=self.compute_dtype)


class Mlp(nn.Module):
    """fc → act → fc. CLIP blocks use QuickGELU; the SemanticLearner's
    projection uses exact (erf) GELU. `names` are the two layers'
    state-dict names (`c_fc`/`c_proj` in blocks, `fc1`/`fc2` elsewhere)."""

    def __init__(self, width: int, hidden: int, act: str = "quick_gelu",
                 compute_dtype=torch.bfloat16,
                 names: Tuple[str, str] = ("c_fc", "c_proj")):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"act must be quick_gelu or gelu, got {act!r}")
        self.act = act
        self.compute_dtype = compute_dtype
        self.names = names
        self.add_module(names[0], nn.Linear(width, hidden))
        self.add_module(names[1], nn.Linear(hidden, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc, proj = (getattr(self, n) for n in self.names)
        x = _linear(x, fc, self.compute_dtype)
        x = quick_gelu(x) if self.act == "quick_gelu" else F.gelu(x)
        return _linear(x, proj, self.compute_dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.ln_1 = LayerNormFP32(width)
        self.attn = MHAttention(width, heads, compute_dtype)
        self.ln_2 = LayerNormFP32(width)
        self.mlp = Mlp(width, 4 * width, "quick_gelu", compute_dtype)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias=bias)
        return x + self.mlp(self.ln_2(x))


class GroupedLinear(nn.Module):
    """Block-diagonal linear over channels: the reference's grouped 1×1
    Conv1d, with its weight layout (groups·d_out, d_in, 1)."""

    def __init__(self, width: int, groups: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.groups = groups
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(width, width // groups, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        g = self.groups
        w = self.weight.reshape(g, d // g, d // g).to(self.compute_dtype)
        xg = x.reshape(b, l, g, d // g).to(self.compute_dtype)
        return torch.einsum("blgi,goi->blgo", xg, w).reshape(b, l, d)
