"""CLIP dual towers with the SegViT visual backbone
(segclip_tpu/models/clip.py).

  - patchify + projection is a reshape and one matmul against conv1 in
    torch's (c, ph, pw) flatten order — the JAX formulation, no convolution;
  - the learned visual position embedding is bicubic-resized for grids other
    than the training one, at eval only (whole-image mode);
  - text pooling takes the EOT position, the argmax of the token ids;
  - with a mask ratio (the MAE losses' second forward), tokens are dropped
    by `random_masking` after ln_pre (vision, CLS kept) or after the
    position embedding (text, BOS and each row's EOT kept).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from segclip_tpu_torch.models.layers import LayerNormFP32, ResidualAttentionBlock
from segclip_tpu_torch.models.seg_vit import SegViT
from segclip_tpu_torch.ops.attention import causal_mask
from segclip_tpu_torch.ops.masking import random_masking
from segclip_tpu_torch.ops.pos_embed import interpolate_pos_embed


class VisionOutput(NamedTuple):
    pooled: torch.Tensor             # (B, E) projected CLS feature
    hidden: torch.Tensor             # (B, 1+T, E) projected token features
    mid: dict                        # SegViT mid-state: hidden, hard / soft attn
    mae_mask: Optional[torch.Tensor] = None       # (B, 1+L), 1 = removed
    ids_restore: Optional[torch.Tensor] = None    # (B, 1+L)


class TextOutput(NamedTuple):
    pooled: torch.Tensor             # (B, E) EOT-pooled projected feature
    hidden: torch.Tensor             # (B, L_kept, E)
    mae_mask: Optional[torch.Tensor] = None       # (B, L), 1 = removed
    ids_restore: Optional[torch.Tensor] = None    # (B, L)


class VisualTower(nn.Module):
    """Patchify → CLS + pos → ln_pre → SegViT (→ ln_post → proj in
    CLIPModule.encode_image)."""

    def __init__(self, width: int, patch_size: int, input_resolution: int,
                 layers: int, output_dim: int, first_stage_layer: int = 10,
                 group_num: int = 8, cross_layer: int = 2, tau: float = 0.9,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.width = width
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        grid = input_resolution // patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormFP32(width)
        self.transformer = SegViT(width, layers=layers,
                                  first_stage_layer=first_stage_layer,
                                  group_num=group_num, cross_layer=cross_layer,
                                  tau=tau, compute_dtype=compute_dtype)
        self.ln_post = LayerNormFP32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def patch_embed(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, gh·gw, width); trailing pixels past a patch
        multiple are dropped, as a stride-p convolution drops them."""
        b, h, w, c = image.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = image[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)
        wmat = self.conv1.weight.reshape(self.width, c * p * p)
        cd = self.compute_dtype
        return x.to(cd) @ wmat.to(cd).t()

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                training: bool = False, mask_noise: Optional[torch.Tensor] = None,
                gumbel_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """image (B, H, W, 3) normalised → (tokens (B, 1+T, W), mid,
        mae_mask, ids_restore). mask_noise (B, 1+L) and gumbel_noise override
        the draws from `generator`."""
        b, h, w, _ = image.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        cd = self.compute_dtype
        x = self.patch_embed(image)
        cls = self.class_embedding.to(cd)[None, None].expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = self.positional_embedding
        if not training:
            pos = interpolate_pos_embed(pos, gh, gw)
        x = self.ln_pre(x + pos.to(cd))
        mae_mask = ids_restore = None
        if mask_ratio > 0.0:
            x, mae_mask, ids_restore, _ = random_masking(
                x, mask_ratio, generator=generator, keep_cls=True, noise=mask_noise)
        tokens, mid = self.transformer(x, mae_path=mask_ratio > 0.0,
                                       training=training, noise=gumbel_noise,
                                       generator=generator)
        return tokens, mid, mae_mask, ids_restore


class TextTransformer(nn.Module):
    def __init__(self, width: int, layers: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, width // 64, compute_dtype)
            for _ in range(layers))

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, bias=bias)
        return x


class CLIPModule(nn.Module):
    """Dual-encoder CLIP with the grouping visual tower; parameter names are
    the reference state dict's under `clip.`."""

    def __init__(self, embed_dim: int, image_resolution: int, vision_layers: int,
                 vision_width: int, vision_patch_size: int, context_length: int,
                 vocab_size: int, transformer_width: int, transformer_layers: int,
                 first_stage_layer: int = 10, group_num: int = 8,
                 cross_layer: int = 2, tau: float = 0.9,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.visual = VisualTower(
            vision_width, vision_patch_size, image_resolution, vision_layers,
            embed_dim, first_stage_layer=first_stage_layer, group_num=group_num,
            cross_layer=cross_layer, tau=tau, compute_dtype=compute_dtype)
        self.transformer = TextTransformer(transformer_width, transformer_layers,
                                           compute_dtype)
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, transformer_width))
        self.ln_final = LayerNormFP32(transformer_width)
        self.text_projection = nn.Parameter(torch.empty(transformer_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image: torch.Tensor, mask_ratio: float = 0.0,
                     training: bool = False,
                     mask_noise: Optional[torch.Tensor] = None,
                     gumbel_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> VisionOutput:
        tokens, mid, mae_mask, ids_restore = self.visual(
            image, mask_ratio, training, mask_noise, gumbel_noise, generator)
        hidden_ln = self.visual.ln_post(tokens)
        hidden = hidden_ln @ self.visual.proj.to(hidden_ln.dtype)
        return VisionOutput(pooled=hidden[:, 0], hidden=hidden, mid=mid,
                            mae_mask=mae_mask, ids_restore=ids_restore)

    def encode_text(self, text: torch.Tensor, mask_ratio: float = 0.0,
                    mask_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> TextOutput:
        """text (B, L) int token ids, 0-padded; EOT is each row's max id.
        With a mask ratio, BOS and each row's EOT are kept."""
        length = text.shape[1]
        cd = self.compute_dtype
        x = self.token_embedding(text).to(cd)
        x = x + self.positional_embedding[:length].to(cd)
        mae_mask = ids_restore = None
        if mask_ratio > 0.0:
            x, mae_mask, ids_restore, ids_keep = random_masking(
                x, mask_ratio, generator=generator, keep_cls=True, keep_sep=True,
                sep_pos=text.argmax(dim=-1), noise=mask_noise)
            text = torch.gather(text, 1, ids_keep)
        x = self.transformer(x, bias=causal_mask(x.shape[1], device=x.device))
        hidden_ln = self.ln_final(x)
        hidden = hidden_ln @ self.text_projection.to(hidden_ln.dtype)
        eot = text.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
        return TextOutput(pooled=pooled, hidden=hidden, mae_mask=mae_mask,
                          ids_restore=ids_restore)
