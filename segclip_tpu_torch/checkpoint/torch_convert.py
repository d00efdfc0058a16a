"""Torch checkpoints of the reference, OpenAI CLIP's `ViT-B-16.pt` and
SegCLIP's `segclip.bin`, into the port's SegCLIP
(segclip_tpu/checkpoint/torch_convert.py).

Two behaviours of the reference loader:
  - the resblocks → layers0/layers2 key surgery that splits the 12-block
    visual transformer at `first_stage_layer` (modeling.py:50-68);
  - the architecture inferred from the checkpoint's tensor shapes
    (modeling.py:89-109).

The port's state dict already has the reference's key layout, so after the
surgery a key needs only the `clip.` prefix that OpenAI's file lacks; the
JAX package's flax translation has no counterpart here. Weights absent
from the checkpoint (the semantic learner, the MAE decoders and layers_mae2
for a raw CLIP file) keep their seeded random init, as init_preweight's
strict=False load does (util_module.py:91-147); missing and unexpected keys
are reported, and a shape that differs raises.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from segclip_tpu_torch.checkpoint.convert import DECODERS, drop_position_tables
from segclip_tpu_torch.config import ModelConfig
from segclip_tpu_torch.utils.logging import get_logger

METADATA = ("input_resolution", "context_length", "vocab_size")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A TorchScript archive (OpenAI's `.pt`) or a `torch.save`d state dict
    (`.bin`, the port's `model.pt`) → {key: float32 tensor on the CPU}.
    OpenAI ships fp16 tensors."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().to(torch.float32) for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def strip_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop a leading 'clip.' (segclip.bin stores the assembled model) and
    OpenAI's metadata scalars."""
    return {(k[5:] if k.startswith("clip.") else k): v
            for k, v in sd.items() if k not in METADATA}


def apply_layer_surgery(sd: Mapping[str, torch.Tensor],
                        first_stage_layer: int) -> Dict[str, torch.Tensor]:
    """visual.transformer.resblocks.N → layers0.N (N < split) or
    layers2.(N-split). Keys already in layers0/layers2 form pass through."""
    out = {}
    pat = re.compile(r"^visual\.transformer\.resblocks\.(\d+)\.(.*)$")
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            n, rest = int(m.group(1)), m.group(2)
            if n >= first_stage_layer:
                k = f"visual.transformer.layers2.{n - first_stage_layer}.{rest}"
            else:
                k = f"visual.transformer.layers0.{n}.{rest}"
        out[k] = v
    return out


def infer_model_config(sd: Mapping[str, torch.Tensor], first_stage_layer: int = 10,
                       base: Optional[ModelConfig] = None, **overrides) -> ModelConfig:
    """Architecture hyperparameters from the checkpoint's tensor shapes.

    The split point: an already-split SegCLIP checkpoint encodes it as its
    `layers0.*` block count, which wins over the `first_stage_layer`
    argument (a disagreeing argument is logged and ignored); `**overrides`
    win over both. Pre-surgery OpenAI dicts (`resblocks.*`) use the
    argument. The fields neither inferred nor overridden come from `base`
    (default: `ModelConfig()`, which is what the JAX package always takes)."""
    sd = strip_prefix(sd)
    conv1 = sd["visual.conv1.weight"]
    # Only tower blocks count: semantic_layer2.cross_att.* and layers_mae2.*
    # carry attention weights too.
    tower = re.compile(r"^visual\.transformer\.(resblocks|layers0|layers2)"
                       r"\.\d+\.attn\.in_proj_weight$")
    split = re.compile(r"^visual\.transformer\.layers0\.\d+\.attn\.in_proj_weight$")
    n_layers0 = sum(1 for k in sd if split.match(k))
    if n_layers0:
        if first_stage_layer not in (10, n_layers0):
            get_logger().warning(
                "first_stage_layer=%d disagrees with the checkpoint's layers0 block "
                "count (%d); using the checkpoint's split (pass first_stage_layer "
                "via **overrides to force)", first_stage_layer, n_layers0)
        first_stage_layer = n_layers0
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    kw = dict(
        image_resolution=conv1.shape[-1] * grid,
        vision_patch_size=conv1.shape[-1],
        vision_width=conv1.shape[0],
        vision_layers=sum(1 for k in sd if tower.match(k)),
        first_stage_layer=first_stage_layer,
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}))
    # A SegCLIP checkpoint also carries the semantic learner: its group
    # count and cross-attention depth.
    sl = "visual.transformer.semantic_layer2"
    if f"{sl}.semantic_center" in sd:
        kw["group_num"] = sd[f"{sl}.semantic_center"].shape[0]
        cross = {k.split(".")[4] for k in sd if k.startswith(f"{sl}.cross_att.")}
        if cross:
            kw["cross_layer"] = len(cross)
    kw.update(overrides)
    return dataclasses.replace(base or ModelConfig(), **kw)


def to_port_layout(sd: Mapping[str, torch.Tensor],
                   first_stage_layer: int) -> Dict[str, torch.Tensor]:
    """Any of raw OpenAI CLIP, surgically renamed, or segclip.bin → the
    port's keys: the surgery, then `clip.` before every key outside the MAE
    decoders."""
    sd = apply_layer_surgery(strip_prefix(sd), first_stage_layer)
    return {(k if k.startswith(DECODERS) else f"clip.{k}"): v for k, v in sd.items()}


def merge_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                     log_fn: Optional[Callable[[str], None]] = None
                     ) -> Tuple[List[str], List[str]]:
    """Copy every tensor of `sd` (port layout) that the model has into it,
    cast to the parameter's dtype; the rest of the model keeps its init.
    The decoders' fixed position tables are checked against the model's
    and dropped (the JAX package never reads them). Returns (missing,
    unexpected), sorted; raises on a shape that differs."""
    sd = dict(sd)
    drop_position_tables(model, sd)
    target = model.state_dict()
    missing = sorted(set(target) - set(sd))
    unexpected = sorted(set(sd) - set(target))
    if log_fn:
        if missing:
            log_fn(f"weights not found in checkpoint (kept random): {len(missing)} "
                   f"tensors, e.g. {missing[:5]}")
        if unexpected:
            log_fn(f"checkpoint tensors with no destination: {len(unexpected)}, "
                   f"e.g. {unexpected[:5]}")
    for key in sorted(set(sd) & set(target)):
        if sd[key].shape != target[key].shape:
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(sd[key].shape)} "
                             f"vs model {tuple(target[key].shape)}")
    with torch.no_grad():
        for key in sorted(set(sd) & set(target)):
            target[key].copy_(sd[key])
    return missing, unexpected
