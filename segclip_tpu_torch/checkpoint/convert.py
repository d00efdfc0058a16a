"""Weights into the port's state dict, which is the reference torch key
layout (`clip.visual.transformer.layers0.N.*`, `…k_conv.weight` of shape
(g·d_out, d_in, 1), `clip.visual.conv1.weight` (W, 3, p, p),
`vis_mae_decoder.decoder_blocks.N.attn.qkv.weight`, …).

Two sources:
  - JAX params (the flax tree as numpy arrays) through
    `export_state_dict` (checkpoint/torch_export.py, the port's numpy-only
    copy of the JAX package's exporter);
  - a reference-layout `.bin` / `.pt` state dict read with `torch.load`.

`load_into` loads every key of the model strictly: `clip.*` and the MAE
decoders the configuration builds (`vis_mae_decoder.*`, `seq_mae_decoder.*`).
A decoder the configuration does not build (the text one, off at the
defaults) is dropped and reported. The reference also stores each decoder's
fixed position table (`decoder_pos_embed`); the port builds that table
itself, so the key is checked against it and dropped. The surgery that turns OpenAI's ViT-B-16.pt
resblocks into layers0/layers2 is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from segclip_tpu_torch.checkpoint.torch_export import export_state_dict

DECODERS = ("vis_mae_decoder.", "seq_mae_decoder.")
POS_TABLE_KEY = "decoder_pos_embed"
POS_TABLE_TOL = 1e-5          # the reference builds the same table in float64 → float32


def state_dict_from_jax(params: dict, vision_patch_size: int = 16
                        ) -> Dict[str, torch.Tensor]:
    """JAX SegCLIP params (a nested dict of arrays, e.g. `{"clip": …}`) →
    the reference-layout state dict as fp32 torch tensors."""
    sd = export_state_dict(params, vision_patch_size=vision_patch_size)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict saved with torch.save (`.bin`/`.pt`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor)
                                           for v in sd.values()):
        raise ValueError(f"{path} is not a state dict of tensors")
    return sd


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Load `sd` into a SegCLIP: `clip.*` and the decoders the model builds,
    every key strictly. Returns what was dropped, sorted: the prefix of a
    decoder the configuration does not build (e.g. "seq_mae_decoder." under
    the default use_text_mae_recon=False), and each reference position-table
    key checked against the port's fixed table. Raises on a missing or
    unknown key, and on a table that differs from the port's."""
    sd = dict(sd)
    dropped = []
    for prefix in DECODERS:
        if not hasattr(model, prefix[:-1]) and any(k.startswith(prefix) for k in sd):
            sd = {k: v for k, v in sd.items() if not k.startswith(prefix)}
            dropped.append(prefix)
    for key in sorted(k for k in sd if k.endswith("." + POS_TABLE_KEY)):
        decoder = getattr(model, key.split(".", 1)[0], None)
        if decoder is None:
            raise KeyError(f"{key}: the model has no such decoder")
        table = sd.pop(key).reshape(decoder.pos_table.shape).float()
        err = (table - decoder.pos_table.cpu()).abs().max().item()
        if err > POS_TABLE_TOL:
            raise ValueError(f"{key} differs from the port's fixed table by {err}")
        dropped.append(key)
    unknown = sorted(set(sd) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"state dict keys the model does not have: {unknown[:5]}")
    model.load_state_dict(sd, strict=True)
    return sorted(dropped)
