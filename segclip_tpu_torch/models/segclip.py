"""SegCLIP: the container that owns the CLIP towers
(segclip_tpu/models/segclip.py), and its seeded random init.

The pretraining losses and the MAE decoders belong to the training slice;
this container holds `clip` only, so its state dict is the reference's
`clip.*` keys.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from segclip_tpu.config import ModelConfig
from segclip_tpu_torch.models.clip import CLIPModule
from segclip_tpu_torch.models.layers import LayerNormFP32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SegCLIP(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.clip = CLIPModule(
            embed_dim=cfg.embed_dim, image_resolution=cfg.image_resolution,
            vision_layers=cfg.vision_layers, vision_width=cfg.vision_width,
            vision_patch_size=cfg.vision_patch_size,
            context_length=cfg.context_length, vocab_size=cfg.vocab_size,
            transformer_width=cfg.transformer_width,
            transformer_layers=cfg.transformer_layers,
            first_stage_layer=cfg.first_stage_layer, group_num=cfg.group_num,
            cross_layer=cfg.cross_layer, compute_dtype=DTYPES[cfg.compute_dtype])

    def encode_image(self, image: torch.Tensor):
        return self.clip.encode_image(image)

    def encode_text(self, text: torch.Tensor):
        return self.clip.encode_text(text)


def _init_param(name: str, p: torch.Tensor, is_norm: bool,
                gen: torch.Generator) -> None:
    """The JAX package's initialisers, by parameter name: LayerNorm ones and
    zeros, zero biases, truncated normal(0.02) for new linear weights, and
    CLIP's scaled normals for the embeddings and projections."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "logit_scale":
        p.fill_(math.log(1 / 0.07))
    elif is_norm:
        p.fill_(1.0 if leaf == "weight" else 0.0)
    elif leaf.endswith("bias"):
        p.zero_()
    elif name.endswith("visual.conv1.weight"):
        p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)       # fan-in
    elif name.endswith(("visual.class_embedding",
                        "visual.positional_embedding")):
        p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
    elif name.endswith(("visual.proj", "text_projection")):
        p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
    elif name.endswith("token_embedding.weight"):
        p.normal_(0.0, 0.02, generator=gen)
    elif name == "clip.positional_embedding":
        p.normal_(0.0, 0.01, generator=gen)
    else:
        nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)


def init_segclip(cfg: ModelConfig, seed: int = 0,
                 device: torch.device | str = "cpu") -> SegCLIP:
    """A SegCLIP with random weights from `seed`, drawn on the CPU (so a seed
    gives the same weights on every device), then moved to `device`."""
    model = SegCLIP(cfg)
    gen = torch.Generator().manual_seed(seed)
    norms = {f"{m_name}.{p_name}"
             for m_name, m in model.named_modules()
             if isinstance(m, LayerNormFP32) for p_name, _ in m.named_parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            _init_param(name, p, name in norms, gen)
    return model.to(device).eval()
