"""MAE decoders for the masked-reconstruction losses
(segclip_tpu/models/mae_decoder.py).

  - VisionMAEDecoder: embed → append mask tokens → unshuffle by ids_restore
    → fixed 2D sin-cos positions → `depth` timm-style blocks (LayerNorm eps
    1e-6, erf GELU) → per-patch pixel prediction → MSE on removed patches;
  - TextMAEDecoder: the same front end → 1D sinusoid positions → blocks
    (LayerNorm eps 1e-5) with the text padding mask → vocab logits → CE
    with ignore index −1 on positions that were masked and are real tokens.

Their attention heads are 48-dim (vision: 384 / 8) and 32-dim (text:
256 / 8) at ViT-B/16, which the attention kernel does not take, so their
blocks take the plain route (ops/attention.py), as the JAX package computes
them in XLA. Parameter names are the reference's, as
segclip_tpu/checkpoint/torch_export.py writes them: `decoder_embed`,
`mask_token` (1, 1, dec), `decoder_blocks.N.{norm1, attn, norm2, mlp}`,
`decoder_norm`, `decoder_pred`; the vision blocks' attention is timm's
(`attn.qkv`, `attn.proj`), the text blocks' torch's MultiheadAttention
(`attn.in_proj_weight`, `attn.out_proj`). The position tables are fixed
buffers, not parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from segclip_tpu_torch.models.layers import (LayerNormFP32, MHAttention, Mlp, linear,
                                             run_blocks)
from segclip_tpu_torch.ops.attention import multi_head_attention, padding_bias
from segclip_tpu_torch.ops.pos_embed import sincos_2d, sinusoid_table


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) → (B, L, P·P·3) in (ph, pw, c) flatten order."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over labels != ignore_index, in fp32 (torch CrossEntropyLoss
    semantics; 0 when every label is ignored)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    denom = valid.sum().clamp(min=1)
    return (nll * valid).sum() / denom


class TimmAttention(nn.Module):
    """timm's Attention parameters (`qkv`, `proj`) over the plain route."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.model_group = None           # the model row when sharded (parallel/gspmd.py)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, kv_in=None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(x, None, self.qkv.weight, self.qkv.bias,
                                    self.proj.weight, self.proj.bias, self.heads,
                                    bias=bias, compute_dtype=self.compute_dtype,
                                    route="plain", model_group=self.model_group)


class MAEBlock(nn.Module):
    """Pre-LN block with erf GELU: x += attn(norm1(x)); x += mlp(norm2(x))."""

    def __init__(self, width: int, heads: int, ln_eps: float, timm: bool,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNormFP32(width, eps=ln_eps)
        self.attn = (TimmAttention(width, heads, compute_dtype) if timm else
                     MHAttention(width, heads, compute_dtype, route="plain"))
        self.norm2 = LayerNormFP32(width, eps=ln_eps)
        self.mlp = Mlp(width, 4 * width, "gelu", compute_dtype, names=("fc1", "fc2"))

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), bias=bias)
        return x + self.mlp(self.norm2(x))


class _DecoderCore(nn.Module):
    """Embed / mask-token / unshuffle front end, the blocks and the final
    norm, shared by both decoders. With `remat`, the blocks run under
    activation checkpointing while gradients are recorded, the embed, the
    norm and the prediction head do not (JAX mae_decoder.py:99)."""

    def __init__(self, in_dim: int, dec_dim: int, depth: int, heads: int,
                 ln_eps: float, timm: bool, pos_table,
                 compute_dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.decoder_embed = nn.Linear(in_dim, dec_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec_dim))
        self.decoder_blocks = nn.ModuleList(
            MAEBlock(dec_dim, heads, ln_eps, timm, compute_dtype)
            for _ in range(depth))
        self.decoder_norm = LayerNormFP32(dec_dim, eps=ln_eps)
        self.register_buffer("pos_table", torch.from_numpy(pos_table),
                             persistent=False)

    def embed_unshuffle(self, hidden: torch.Tensor,
                        ids_restore: torch.Tensor) -> torch.Tensor:
        """hidden (B, kept, in) → (B, L, dec) in the original order, with
        mask tokens at the removed positions, plus the position table."""
        x = linear(hidden, self.decoder_embed, self.compute_dtype)
        b, kept, d = x.shape
        n_mask = ids_restore.shape[1] - kept
        x = torch.cat([x, self.mask_token.to(x.dtype).expand(b, n_mask, d)], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(-1, -1, d))
        return x + self.pos_table.to(x.dtype)

    def blocks_and_norm(self, x: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder_norm(run_blocks(self.decoder_blocks, x, self.remat, bias=bias))


class VisionMAEDecoder(_DecoderCore):
    def __init__(self, in_dim: int, dec_dim: int, image_resolution: int,
                 patch_size: int, depth: int = 3, heads: int = 8,
                 compute_dtype=torch.bfloat16, remat: bool = False):
        grid = image_resolution // patch_size
        super().__init__(in_dim, dec_dim, depth, heads, 1e-6, True,
                         sincos_2d(dec_dim, grid, cls_token=True), compute_dtype, remat)
        self.patch_size = patch_size
        self.decoder_pred = nn.Linear(dec_dim, patch_size ** 2 * 3)

    def forward(self, image: torch.Tensor, hidden: torch.Tensor,
                mae_mask: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) normalised; hidden (B, 1+K, W) kept tokens,
        CLS first; mae_mask and ids_restore over the (1+L)-token sequence.
        Returns the MSE over the removed patches."""
        x = self.blocks_and_norm(self.embed_unshuffle(hidden, ids_restore))
        pred = linear(x, self.decoder_pred, self.compute_dtype)[:, 1:]
        target = patchify(image, self.patch_size)
        loss = (pred.float() - target.float()).square().mean(dim=-1)     # (B, L)
        patch_mask = mae_mask[:, 1:].float()
        return (loss * patch_mask).sum() / torch.maximum(
            patch_mask.sum(), torch.ones((), device=loss.device))


class TextMAEDecoder(_DecoderCore):
    def __init__(self, in_dim: int, dec_dim: int, seq_len: int, vocab_size: int,
                 depth: int = 3, heads: int = 8, compute_dtype=torch.bfloat16,
                 remat: bool = False):
        super().__init__(in_dim, dec_dim, depth, heads, 1e-5, False,
                         sinusoid_table(seq_len, dec_dim), compute_dtype, remat)
        self.vocab_size = vocab_size
        self.decoder_pred = nn.Linear(dec_dim, vocab_size)

    def forward(self, input_ids: torch.Tensor, hidden: torch.Tensor,
                recon_mask: torch.Tensor, ids_restore: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """recon_mask: bool (B, L), the positions that were masked and are
        real tokens. Returns the CE of the vocab prediction there."""
        x = self.embed_unshuffle(hidden, ids_restore)
        x = self.blocks_and_norm(x, bias=padding_bias(attention_mask))
        pred = linear(x, self.decoder_pred, self.compute_dtype)
        m = recon_mask.to(input_ids.dtype)
        labels = input_ids * m - (1 - m)                 # −1 where not scored
        return cross_entropy_ignore(pred.reshape(-1, self.vocab_size),
                                    labels.reshape(-1))
