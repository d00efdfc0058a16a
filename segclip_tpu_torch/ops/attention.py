"""Multi-head attention over a packed QKV projection
(segclip_tpu/ops/attention.py).

Semantics of torch nn.MultiheadAttention as the reference uses it: one
(3d, d) in-projection giving q|k|v, q scaled by head_dim**−0.5, an additive
float mask (causal: −inf above the diagonal; padding: (1−m)·−1e6), softmax
in fp32, an output projection back to d.

Weights are in torch's (out, in) layout; the projections are `x @ Wᵀ + b`
in the compute dtype, as the JAX code's `x @ W + b`. Two routes compute
softmax(qkᵀ)v, chosen by the module that owns the attention:

  - "kernel" (the default): the attention kernel (ops/kernels/attention.py)
    on the q|k|v column views of the projection, without copies. It takes
    64-dim heads only, which is what every tower of the model has
    (width // 64 heads); another head dim raises.
  - "plain": `sdpa` per head in torch ops, any head dim. Only the MAE
    decoders take it (48- and 32-dim heads at ViT-B/16), as the JAX package
    computes those in XLA outside its Pallas kernel
    (segclip_tpu/ops/attention.py:121-129). `plain_route.calls` counts its
    calls the way the kernels count their launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from segclip_tpu_torch.ops.kernels.attention import (
    HEAD_DIM, merge_heads, split_heads, attention, sdpa)

ROUTES = ("kernel", "plain")


def causal_mask(length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask: 0 on and below the diagonal, −inf above."""
    mask = torch.full((length, length), float("-inf"), dtype=dtype,
                      device=device)
    return torch.triu(mask, diagonal=1)


def padding_bias(attention_mask: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Additive padding bias from a {0,1} mask (B, L): (1 − m)·−1e6,
    broadcast over queries → (B, 1, 1, L)."""
    bias = (1.0 - attention_mask.to(dtype)) * -1e6
    return bias[:, None, None, :]


def _attend(q, k, v, num_heads: int, bias: Optional[torch.Tensor]):
    d = q.shape[-1]
    if d != num_heads * HEAD_DIM:
        raise ValueError(f"{num_heads} heads over width {d}: the attention "
                         f"kernel takes {HEAD_DIM}-dim heads only")
    bias2d = biasb = None
    if bias is not None:
        if bias.dim() == 2:
            bias2d = bias.float()
        elif bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
            biasb = bias[:, 0, 0, :].float()
        else:
            raise ValueError(f"unsupported bias shape {tuple(bias.shape)}")
    return attention(q, k, v, bias2d, biasb, HEAD_DIM ** -0.5)


def plain_route(q, k, v, num_heads: int, bias: Optional[torch.Tensor]):
    """`sdpa` per head (any head dim, scale head_dim**−0.5) on (B, L, D)
    operands; bias None, (Lq, Lk) or (B, 1, 1, Lk)."""
    plain_route.calls += 1
    return merge_heads(sdpa(split_heads(q, num_heads), split_heads(k, num_heads),
                             split_heads(v, num_heads), bias))


plain_route.calls = 0


def multi_head_attention(q_in: torch.Tensor, kv_in: Optional[torch.Tensor],
                         in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor,
                         out_proj_weight: torch.Tensor,
                         out_proj_bias: torch.Tensor, num_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         compute_dtype=torch.bfloat16,
                         route: str = "kernel") -> torch.Tensor:
    """Packed-projection MHA: self-attention when kv_in is None, else
    cross-attention with the packed weight split into Wq | Wk,v as torch's
    in_proj split. bias: None, (Lq, Lk), or (B, 1, 1, Lk). route: "kernel"
    (64-dim heads) or "plain" (any head dim)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    d = q_in.shape[-1]
    w = in_proj_weight.to(compute_dtype)
    bqkv = in_proj_bias.to(compute_dtype)
    q_in = q_in.to(compute_dtype)
    if kv_in is None:
        qkv = q_in @ w.t() + bqkv
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        kv_in = kv_in.to(compute_dtype)
        q = q_in @ w[:d].t() + bqkv[:d]
        kv = kv_in @ w[d:].t() + bqkv[d:]
        k, v = kv[..., :d], kv[..., d:]
    attend = _attend if route == "kernel" else plain_route
    o = attend(q, k, v, num_heads, bias)
    return o @ out_proj_weight.to(compute_dtype).t() + \
        out_proj_bias.to(compute_dtype)
