"""Shared building blocks (segclip_tpu/models/layers.py).

Parameters are fp32 and named as in the reference torch state dict
(`ln_1.weight`, `attn.in_proj_weight`, `mlp.c_fc.weight`, …). Activations
and matmuls run in `compute_dtype`, cast explicitly where the JAX code casts;
LayerNorm computes in fp32.

Under tensor parallelism (parallel/gspmd.py) an attention, an MLP and the
token embedding hold their slices of the sharded weights, and their
`model_group` is the model row: the attention and the first MLP layer take
their input through `copy_to_model_group`, the output projection and the
second MLP layer sum their partial products with `reduce_from_model_group`
before the replicated bias. With no group (tensor parallelism 1) they run
as before, with no added op.

`run_blocks` runs a stack of blocks, each under activation checkpointing
when the model's `remat` is on (ModelConfig.remat, JAX's `nn.remat` around
the block class): the stacks that call it are the ones JAX wraps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from segclip_tpu_torch.ops.attention import multi_head_attention
from segclip_tpu_torch.ops.layers import layer_norm, quick_gelu
from segclip_tpu_torch.parallel.gspmd import (copy_to_model_group,
                                              reduce_from_model_group,
                                              vocab_parallel_embedding)


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
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
    nn.MultiheadAttention's parameter names. `route` is the attention
    route of ops/attention.py: "kernel" (64-dim heads) or "plain". `heads`
    is this rank's head count (all of them unless sharded)."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.bfloat16,
                 route: str = "kernel"):
        super().__init__()
        self.heads = heads
        self.model_group = None
        self.compute_dtype = compute_dtype
        self.route = route
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, q_in: torch.Tensor, kv_in: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(
            q_in, kv_in, self.in_proj_weight, self.in_proj_bias,
            self.out_proj.weight, self.out_proj.bias, self.heads, bias=bias,
            compute_dtype=self.compute_dtype, route=self.route,
            model_group=self.model_group)


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
        self.model_group = None
        self.add_module(names[0], nn.Linear(width, hidden))
        self.add_module(names[1], nn.Linear(hidden, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc, proj = (getattr(self, n) for n in self.names)
        cd = self.compute_dtype
        if self.model_group is not None:
            x = copy_to_model_group(x.to(cd), self.model_group)
        x = linear(x, fc, cd)
        x = quick_gelu(x) if self.act == "quick_gelu" else F.gelu(x)
        if self.model_group is None:
            return linear(x, proj, cd)
        x = reduce_from_model_group(x.to(cd) @ proj.weight.to(cd).t(), self.model_group)
        return x + proj.bias.to(cd)


class VocabParallelEmbedding(nn.Embedding):
    """nn.Embedding whose table may be split by rows over the model row:
    then this rank holds rows [vocab_start, vocab_start + its rows) and the
    lookup is gspmd.vocab_parallel_embedding."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__(num_embeddings, embedding_dim)
        self.model_group = None
        self.vocab_start = 0

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return super().forward(ids)
        return vocab_parallel_embedding(ids, self.weight, self.vocab_start,
                                        self.model_group)


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


def run_blocks(blocks, x: torch.Tensor, remat: bool = False, **kw) -> torch.Tensor:
    """x through each block in turn, `blk(x, **kw)`. With `remat`, while
    gradients are recorded, each block runs under non-reentrant
    `torch.utils.checkpoint`: the forward keeps the block's input only and
    the backward recomputes the rest, the same ops on the same inputs, so
    no value changes (JAX's `nn.remat`). Under `no_grad` (eval, the text
    bank, the studies) the blocks run as they are.

    The reentrant form would drop the `bias=` keyword and inputs that need
    no grad. No block draws random numbers (the masking and Gumbel noise
    are drawn outside the stacks), so the RNG state is not saved for the
    recompute. The recompute stops once the last saved tensor is back
    (non-reentrant early stop): it runs the attention again, the kernel
    forward with P and, under tensor parallelism, the out-projection's
    model-row all-reduce, and stops at the second MLP layer's product,
    before that layer's all-reduce."""
    recompute = remat and torch.is_grad_enabled()
    for blk in blocks:
        x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False, **kw)
             if recompute else blk(x, **kw))
    return x


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
