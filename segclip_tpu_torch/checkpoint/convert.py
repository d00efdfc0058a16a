"""Weights into the port's state dict, which is the reference torch key
layout (`clip.visual.transformer.layers0.N.*`, `…k_conv.weight` of shape
(g·d_out, d_in, 1), `clip.visual.conv1.weight` (W, 3, p, p), …).

Two sources:
  - JAX params (the flax tree as numpy arrays) through
    `segclip_tpu.checkpoint.torch_export.export_state_dict`, which is numpy
    only;
  - a reference-layout `.bin` / `.pt` state dict read with `torch.load`.

`load_into` loads the `clip.*` keys strictly. The MAE decoders' keys
(`vis_mae_decoder.`, `seq_mae_decoder.`) are left for the training slice and
reported; any other key is an error. The surgery that turns OpenAI's
ViT-B-16.pt resblocks into layers0/layers2 is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from segclip_tpu.checkpoint.torch_export import export_state_dict

LEFT_FOR_TRAINING = ("vis_mae_decoder.", "seq_mae_decoder.")


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
    """Load `sd` into a SegCLIP: `clip.*` strictly; returns the prefixes of
    the keys left for the training slice. Raises on any other key."""
    clip = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
    left = sorted({p for k in sd for p in LEFT_FOR_TRAINING if k.startswith(p)})
    unknown = [k for k in sd if not k.startswith(("clip.",) + LEFT_FOR_TRAINING)]
    if unknown:
        raise KeyError(f"state dict keys outside clip.* and the MAE "
                       f"decoders: {unknown[:5]}")
    model.clip.load_state_dict(clip, strict=True)
    return left
