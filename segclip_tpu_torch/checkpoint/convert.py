"""Weights into the port's state dict, which is the reference torch key
layout (`clip.visual.transformer.layers0.N.*`, `…k_conv.weight` of shape
(g·d_out, d_in, 1), `clip.visual.conv1.weight` (W, 3, p, p),
`vis_mae_decoder.decoder_blocks.N.attn.qkv.weight`, …).

Two sources:
  - JAX params (the flax tree as numpy arrays) through
    `export_state_dict` (checkpoint/torch_export.py, the port's numpy-only
    copy of the JAX package's exporter);
  - a reference-layout `.bin` / `.pt` state dict read with `torch.load`.

`flax_params_from_state_dict` is the inverse of `export_state_dict` (the
port's own code), for the Orbax writer (checkpoint/orbax_io.py): a state
dict back to the JAX params tree, exactly.

`load_into` loads every key of the model strictly: `clip.*` and the MAE
decoders the configuration builds (`vis_mae_decoder.*`, `seq_mae_decoder.*`).
A decoder the configuration does not build (the text one, off at the
defaults) is dropped and reported. The reference also stores each decoder's
fixed position table (`decoder_pos_embed`); the port builds that table
itself, so the key is checked against it and dropped.

OpenAI's ViT-B-16.pt, segclip.bin and other reference checkpoints, with
the resblocks → layers0/layers2 surgery, the architecture inferred from
their shapes and absent weights kept at their init, go through
`checkpoint/torch_convert.py` (`cli/common.load_model`); `load_into` is the
strict load of a state dict in the port's own layout.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

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


def drop_position_tables(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Pop each decoder's reference position table (`*.decoder_pos_embed`)
    from `sd`, checking it against the port's fixed table where the model
    builds that decoder. Returns the keys popped, sorted; raises on a table
    that differs from the port's."""
    dropped = sorted(k for k in sd if k.endswith("." + POS_TABLE_KEY))
    for key in dropped:
        table = sd.pop(key)
        decoder = getattr(model, key.split(".", 1)[0], None)
        if decoder is None:
            continue
        table = table.reshape(decoder.pos_table.shape).float()
        err = (table - decoder.pos_table.cpu()).abs().max().item()
        if err > POS_TABLE_TOL:
            raise ValueError(f"{key} differs from the port's fixed table by {err}")
    return dropped


def fit_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`sd` without what `load_into` drops (a decoder the model does not
    build, the reference position tables, checked), and the dropped keys,
    sorted. Raises on a key the model does not have, and on a table that
    differs from the port's."""
    sd = dict(sd)
    dropped = []
    for prefix in DECODERS:
        if not hasattr(model, prefix[:-1]) and any(k.startswith(prefix) for k in sd):
            sd = {k: v for k, v in sd.items() if not k.startswith(prefix)}
            dropped.append(prefix)
    dropped += drop_position_tables(model, sd)
    unknown = sorted(set(sd) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"state dict keys the model does not have: {unknown[:5]}")
    return sd, sorted(dropped)


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Load `sd` into a SegCLIP: `clip.*` and the decoders the model builds,
    every key strictly. Returns what was dropped, sorted: the prefix of a
    decoder the configuration does not build (e.g. "seq_mae_decoder." under
    the default use_text_mae_recon=False), and each reference position-table
    key checked against the port's fixed table. Raises on a missing or
    unknown key, and on a table that differs from the port's."""
    sd, dropped = fit_state_dict(model, sd)
    model.load_state_dict(sd, strict=True)
    return dropped


# The inverse of `export_state_dict`: a reference-layout key → (its path in
# the flax tree, how its array is laid out there). "T": transposed; "conv1":
# (W, 3, p, p) → (3·p·p, W); "grouped": the grouped 1×1 conv (g·d, d, 1) →
# (g, d, d), in → out.
_LN = {"weight": "scale", "bias": "bias"}
_BLOCK = {"ln_1.weight": ("ln_1/scale", None), "ln_1.bias": ("ln_1/bias", None),
          "ln_2.weight": ("ln_2/scale", None), "ln_2.bias": ("ln_2/bias", None),
          "attn.in_proj_weight": ("attn/qkv_kernel", "T"), "attn.in_proj_bias": ("attn/qkv_bias", None),
          "attn.out_proj.weight": ("attn/out_kernel", "T"), "attn.out_proj.bias": ("attn/out_bias", None),
          "mlp.c_fc.weight": ("mlp/c_fc/kernel", "T"), "mlp.c_fc.bias": ("mlp/c_fc/bias", None),
          "mlp.c_proj.weight": ("mlp/c_proj/kernel", "T"),
          "mlp.c_proj.bias": ("mlp/c_proj/bias", None)}
_CROSS = {**{f"{ln}.{w}": (f"{ln}/{_LN[w]}", None) for ln in ("ln_x", "ln_k", "ln_2") for w in _LN},
          **{k: v for k, v in _BLOCK.items() if k.startswith(("attn.", "mlp."))}}
_MAE_BLOCK = {**{f"{ln}.{w}": (f"{ln}/{_LN[w]}", None) for ln in ("norm1", "norm2") for w in _LN},
              "mlp.fc1.weight": ("mlp/c_fc/kernel", "T"), "mlp.fc1.bias": ("mlp/c_fc/bias", None),
              "mlp.fc2.weight": ("mlp/c_proj/kernel", "T"), "mlp.fc2.bias": ("mlp/c_proj/bias", None),
              "attn.qkv.weight": ("attn/qkv_kernel", "T"), "attn.qkv.bias": ("attn/qkv_bias", None),
              "attn.proj.weight": ("attn/out_kernel", "T"), "attn.proj.bias": ("attn/out_bias", None),
              **{k: v for k, v in _BLOCK.items() if k.startswith("attn.")}}
_SEMANTIC = {"semantic_center": ("semantic_center", None),
             **{f"{ln}.{w}": (f"{ln}/{_LN[w]}", None) for ln in ("norm", "cross_ln", "k_ln")
                for w in _LN},
             "k_conv.weight": ("k_conv/kernel", "grouped"), "v_conv.weight": ("v_conv/kernel", "grouped"),
             "proj_o.ln.weight": ("proj_ln/scale", None), "proj_o.ln.bias": ("proj_ln/bias", None),
             "proj_o.mlp.fc1.weight": ("proj_mlp/c_fc/kernel", "T"),
             "proj_o.mlp.fc1.bias": ("proj_mlp/c_fc/bias", None),
             "proj_o.mlp.fc2.weight": ("proj_mlp/c_proj/kernel", "T"),
             "proj_o.mlp.fc2.bias": ("proj_mlp/c_proj/bias", None)}
_TOP = {"clip.token_embedding.weight": ("clip/token_embedding/embedding", None),
        "clip.positional_embedding": ("clip/positional_embedding", None),
        "clip.text_projection": ("clip/text_projection", None),
        "clip.logit_scale": ("clip/logit_scale", None),
        "clip.ln_final.weight": ("clip/ln_final/scale", None),
        "clip.ln_final.bias": ("clip/ln_final/bias", None),
        "clip.visual.conv1.weight": ("clip/visual/conv1", "conv1"),
        "clip.visual.class_embedding": ("clip/visual/class_embedding", None),
        "clip.visual.positional_embedding": ("clip/visual/positional_embedding", None),
        "clip.visual.proj": ("clip/visual/proj", None),
        **{f"clip.visual.{ln}.{w}": (f"clip/visual/{ln}/{_LN[w]}", None)
           for ln in ("ln_pre", "ln_post") for w in _LN},
        "clip.visual.transformer.reconstruct_layer2.rec_proj_a.a_fc.weight":
            ("clip/visual/transformer/reconstruct_layer2/rec_proj_a/kernel", "T"),
        "clip.visual.transformer.reconstruct_layer2.rec_proj_a.a_fc.bias":
            ("clip/visual/transformer/reconstruct_layer2/rec_proj_a/bias", None)}
_MAE_TOP = {"decoder_embed.weight": ("core/decoder_embed/kernel", "T"),
            "decoder_embed.bias": ("core/decoder_embed/bias", None),
            "mask_token": ("core/mask_token", None),
            "decoder_norm.weight": ("core/decoder_norm/scale", None),
            "decoder_norm.bias": ("core/decoder_norm/bias", None),
            "decoder_pred.weight": ("decoder_pred/kernel", "T"),
            "decoder_pred.bias": ("decoder_pred/bias", None)}
_INDEXED = ((re.compile(r"clip\.transformer\.resblocks\.(\d+)\.(.+)"),
             "clip/transformer/resblocks_{}", _BLOCK),
            (re.compile(r"clip\.visual\.transformer\.(layers0|layers2|layers_mae2)\.(\d+)\.(.+)"),
             "clip/visual/transformer/{}_{}", _BLOCK),
            (re.compile(r"clip\.visual\.transformer\.semantic_layer2\.cross_att\.(\d+)\.(.+)"),
             "clip/visual/transformer/semantic_layer2/cross_att_{}", _CROSS),
            (re.compile(r"(vis_mae_decoder|seq_mae_decoder)\.decoder_blocks\.(\d+)\.(.+)"),
             "{}/core/blocks_{}", _MAE_BLOCK))


def _flax_path(key: str) -> Tuple[str, Optional[str]]:
    if key in _TOP:
        return _TOP[key]
    for pattern, base, table in _INDEXED:
        m = pattern.fullmatch(key)
        if m and m.groups()[-1] in table:
            path, layout = table[m.groups()[-1]]
            return base.format(*m.groups()[:-1]) + "/" + path, layout
    head, _, rest = key.partition(".")
    if head in ("vis_mae_decoder", "seq_mae_decoder") and rest in _MAE_TOP:
        path, layout = _MAE_TOP[rest]
        return f"{head}/{path}", layout
    sl = "clip.visual.transformer.semantic_layer2."
    if key.startswith(sl) and key[len(sl):] in _SEMANTIC:
        path, layout = _SEMANTIC[key[len(sl):]]
        return "clip/visual/transformer/semantic_layer2/" + path, layout
    raise KeyError(f"{key}: no place in the JAX params tree")


def flax_params_from_state_dict(sd: Dict[str, torch.Tensor]) -> dict:
    """The inverse of `export_state_dict`: a reference-layout state dict →
    the JAX SegCLIP params tree (nested dicts), each leaf a CPU tensor of
    the state dict's dtype. Raises on a key with no place in the tree."""
    tree: dict = {}
    for key, value in sd.items():
        path, layout = _flax_path(key)
        value = value.detach().cpu()
        if layout == "T":
            value = value.t()
        elif layout == "conv1":
            value = value.reshape(value.shape[0], -1).t()
        elif layout == "grouped":
            g = value.shape[0] // value.shape[1]
            value = value.reshape(g, value.shape[1], value.shape[1]).transpose(1, 2)
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        if leaf in node:
            raise KeyError(f"{key}: its place {path} is taken")
        node[leaf] = value.contiguous()
    return tree
