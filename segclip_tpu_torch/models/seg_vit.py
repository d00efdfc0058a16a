"""SegViT: the two-stage visual transformer with the semantic grouping
bottleneck (segclip_tpu/models/seg_vit.py), on the grouping path.

  - `layers0` blocks run over the patch tokens (CLS split off first);
  - the SemanticLearner cross-attends G learnable centres over the patches
    and assigns each patch to one centre through the group-assignment
    kernel (eval: no Gumbel noise, so no temperature);
  - `layers2` blocks run over the G group tokens; CLS = max over groups.

`layers_mae2` and `reconstruct_layer2` (the MAE path) exist as parameters so
that a full state dict loads strictly; their forward belongs to training.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from segclip_tpu_torch.models.layers import (GroupedLinear, LayerNormFP32,
                                             MHAttention, Mlp,
                                             ResidualAttentionBlock)
from segclip_tpu_torch.ops.kernels.grouping import group_assign
from segclip_tpu_torch.ops.layers import quick_gelu


class CrossAttentionBlock(nn.Module):
    """q += attn(ln_x(q), ln_k(kv)); q += mlp(ln_2(q)). ln_k normalises the
    raw kv, which is [centres; patches]. Each image attends on its own (the
    reference's batch-1 semantics, docs/PARITY.md quirk 2)."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.ln_x = LayerNormFP32(width)
        self.ln_k = LayerNormFP32(width)
        self.attn = MHAttention(width, heads, compute_dtype)
        self.ln_2 = LayerNormFP32(width)
        self.mlp = Mlp(width, 4 * width, "quick_gelu", compute_dtype)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        q = q + self.attn(self.ln_x(q), self.ln_k(kv))
        return q + self.mlp(self.ln_2(q))


class ProjOut(nn.Module):
    """ln → MLP(erf-GELU): the SemanticLearner's output projection
    (`proj_o.ln`, `proj_o.mlp.fc1`/`fc2`)."""

    def __init__(self, width: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.ln = LayerNormFP32(width)
        self.mlp = Mlp(width, 4 * width, "gelu", compute_dtype,
                       names=("fc1", "fc2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.ln(x))


class SemanticLearner(nn.Module):
    """Aggregates L patch tokens into `num_tokens` group tokens: centres →
    cross-attention blocks over [centres; raw patches] → cross_ln; keys and
    values from grouped channel mixes of the normed patches; logits q·kᵀ
    (unscaled); hard assignment over centres; count-normalised aggregation;
    out = quick_gelu(proj_o(q + grouped))."""

    def __init__(self, width: int, num_tokens: int, heads: int,
                 cross_layer: int = 2, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNormFP32(width)
        self.semantic_center = nn.Parameter(torch.empty(num_tokens, width))
        self.cross_att = nn.ModuleList(
            CrossAttentionBlock(width, heads, compute_dtype)
            for _ in range(cross_layer))
        self.cross_ln = LayerNormFP32(width)
        self.k_conv = GroupedLinear(width, heads, compute_dtype)
        self.k_ln = LayerNormFP32(width)
        self.v_conv = GroupedLinear(width, heads, compute_dtype)
        self.proj_o = ProjOut(width, compute_dtype)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """inputs (B, L, D) → (groups (B, G, D), hard (B, G, L),
        soft (B, G, L), centres after the cross blocks (B, G, D))."""
        b = inputs.shape[0]
        cd = self.compute_dtype
        in_feature = self.norm(inputs)
        q = self.semantic_center.to(cd)[None].expand(b, -1, -1)
        for blk in self.cross_att:
            q = blk(q, torch.cat([q, inputs.to(cd)], dim=1))
        q = self.cross_ln(q)

        k = self.k_ln(self.k_conv(in_feature))
        v = self.v_conv(in_feature)
        grouped, hard, soft = group_assign(q, k, v)
        out = quick_gelu(self.proj_o(q + grouped))
        return out, hard, soft, q


class ReconstructLayer(nn.Module):
    """Parameters of the MAE path's scatter of G group tokens back to patch
    positions (`rec_proj_a.a_fc`); the forward belongs to training."""

    def __init__(self, num_tokens: int):
        super().__init__()
        self.rec_proj_a = nn.Module()
        self.rec_proj_a.a_fc = nn.Linear(num_tokens, num_tokens)


class SegViT(nn.Module):
    """Two-stage ViT over a (B, 1+L, D) token sequence (CLS first), grouping
    path."""

    def __init__(self, width: int, layers: int = 12, first_stage_layer: int = 10,
                 group_num: int = 8, cross_layer: int = 2,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        heads = width // 64
        second = layers - first_stage_layer

        def blocks(n):
            return nn.ModuleList(ResidualAttentionBlock(width, heads, compute_dtype)
                                 for _ in range(n))

        self.layers0 = blocks(first_stage_layer)
        self.semantic_layer2 = SemanticLearner(
            width, group_num, heads, cross_layer=cross_layer,
            compute_dtype=compute_dtype)
        self.layers2 = blocks(second)
        self.layers_mae2 = blocks(second)
        self.reconstruct_layer2 = ReconstructLayer(group_num)

    def forward(self, x: torch.Tensor):
        """Returns (tokens (B, 1+G, D), mid) with mid = {"hard_attn",
        "soft_attn": (B, G, L)}."""
        x_ = x[:, 1:]
        for blk in self.layers0:
            x_ = blk(x_)
        gx, hard, soft, _ = self.semantic_layer2(x_)
        for blk in self.layers2:
            gx = blk(gx)
        cls = gx.amax(dim=1, keepdim=True)
        mid = {"hard_attn": hard, "soft_attn": soft}
        return torch.cat([cls, gx], dim=1), mid
