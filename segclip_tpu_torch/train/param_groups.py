"""Parameter groups and freezing (segclip_tpu/train/param_groups.py), on the
reference's torch parameter names (`clip.visual.transformer.layers0.3.…`).

Groups, each split into decay / no_decay by the substring "bias" in the
leaf name (the reference's no_decay list also names "LayerNorm.*", which
never occurs in its parameter names, so only "bias" matches):
  clip_freeze       lower_lr       pretrained CLIP towers (layers0, text
                                   resblocks, embeddings, ln_pre/ln_final,
                                   logit_scale, text_projection)
  clip_text_freeze  lower_text_lr  text token / position embeddings
  clip_train        lr             new or retrained CLIP parts (layers2,
                                   layers_mae2, semantic learner,
                                   reconstruct, ln_post, proj)
  other             lr             MAE decoders

Frozen parameters (the reference's three passes) get requires_grad=False,
as the reference does; the JAX package's stop_gradient is the same thing:
no gradient, and no share of the clip norm.
"""
from __future__ import annotations

from typing import Dict, List

from torch import nn

from segclip_tpu_torch.config import OptimConfig

_CLIP_FREEZE_PREFIXES = (
    "clip.visual.class_embedding",
    "clip.visual.positional_embedding",
    "clip.visual.conv1",
    "clip.visual.ln_pre",
    "clip.logit_scale",
    "clip.ln_final",
    "clip.text_projection",
    "clip.visual.transformer.layers0.",
    "clip.transformer.resblocks.",
)
_CLIP_TEXT_FREEZE_PREFIXES = (
    "clip.positional_embedding",
    "clip.token_embedding",
)
_ALWAYS_TRAIN = (
    "clip.ln_final", "clip.text_projection", "clip.logit_scale",
    "clip.visual.ln_post", "clip.visual.proj",
    "clip.visual.transformer.semantic_layer2",
    "clip.visual.transformer.layers_mae2.",
    "clip.visual.transformer.reconstruct_layer2",
)


def group_of(name: str) -> str:
    if name.startswith("clip."):
        if name.startswith(_CLIP_FREEZE_PREFIXES):
            return "clip_freeze"
        if name.startswith(_CLIP_TEXT_FREEZE_PREFIXES):
            return "clip_text_freeze"
        return "clip_train"
    return "other"


def is_no_decay(name: str) -> bool:
    return "bias" in name.rsplit(".", 1)[-1]


def _layer_index(name: str, marker: str) -> int:
    return int(name.split(marker, 1)[1].split(".", 1)[0])


def is_frozen(name: str, cfg: OptimConfig, first_stage_layer: int = 10,
              pretrained_vit: bool = True) -> bool:
    """True if the parameter is excluded from training entirely."""
    if not name.startswith("clip."):
        return False
    # Pass (c): the stock ViT's patchify and position embedding, always.
    if pretrained_vit and name.startswith(("clip.visual.positional_embedding",
                                           "clip.visual.conv1")):
        return True
    # Pass (a): the freeze_layer_num gate (−1 turns it off). Named parts
    # train; transformer layers train from the gate up; everything else
    # under clip (embeddings, conv1, ln_pre, class embedding) is frozen.
    if cfg.freeze_layer_num > -1:
        if name.startswith(_ALWAYS_TRAIN):
            pass
        elif "transformer.layers0." in name:
            if _layer_index(name, "layers0.") < cfg.freeze_layer_num:
                return True
        elif "transformer.layers2." in name:
            if (_layer_index(name, "layers2.")
                    < cfg.freeze_layer_num - first_stage_layer):
                return True
        elif name.startswith("clip.transformer.resblocks."):
            if _layer_index(name, "resblocks.") < cfg.freeze_layer_num:
                return True
        else:
            return True
    # Pass (b): freeze_text_layer_num.
    if cfg.freeze_text_layer_num > 0:
        if name.startswith(("clip.positional_embedding", "clip.token_embedding")):
            return True
        if name.startswith("clip.transformer.resblocks."):
            if _layer_index(name, "resblocks.") < cfg.freeze_text_layer_num:
                return True
    return False


def group_lrs(cfg: OptimConfig) -> Dict[str, float]:
    lower_lr = cfg.lower_lr if cfg.lower_lr > 0 else cfg.lr * cfg.coef_lr
    lower_text_lr = cfg.lower_text_lr if cfg.lower_text_lr > 0 else lower_lr
    return {"clip_freeze": lower_lr, "clip_text_freeze": lower_text_lr,
            "clip_train": cfg.lr, "other": cfg.lr}


def freeze(model: nn.Module, cfg: OptimConfig, first_stage_layer: int = 10,
           pretrained_vit: bool = True) -> List[str]:
    """Set requires_grad=False on the frozen parameters; returns their
    names."""
    frozen = []
    for name, p in model.named_parameters():
        if is_frozen(name, cfg, first_stage_layer, pretrained_vit):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def param_groups(model: nn.Module, cfg: OptimConfig) -> List[dict]:
    """The optimizer's groups over the trainable parameters: one per
    (group, decay) pair that has any, with its peak lr and weight decay."""
    lrs = group_lrs(cfg)
    groups: Dict[tuple, dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        group, no_decay = group_of(name), is_no_decay(name)
        key = (group, no_decay)
        if key not in groups:
            groups[key] = {"name": f"{group}/{'no_decay' if no_decay else 'decay'}",
                           "params": [], "param_names": [], "lr": lrs[group],
                           "weight_decay": 0.0 if no_decay else cfg.weight_decay}
        groups[key]["params"].append(p)
        groups[key]["param_names"].append(name)
    return list(groups.values())
