"""A copy of segclip_tpu/checkpoint/torch_export.py, kept in the port so that the port
imports nothing of the JAX package (tests/test_torch_vendored.py holds the
copy equal to the original).

Export a flax param tree back to a reference-layout torch state dict.

Inverse of torch_convert.convert_state_dict — produces the `clip.`-prefixed
segclip.bin key layout (layers0/layers2 naming), so checkpoints trained here
can be consumed by reference-compatible tooling. Saved with torch.save when
torch is importable, else .npz.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _walk(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, p)
        else:
            yield p, np.asarray(v, dtype=np.float32)


def _block_keys(out, src_prefix: str, dst_prefix: str, flat: Dict[str, np.ndarray]):
    """Reverse a ResidualAttentionBlock."""
    m = {
        "ln_1/scale": "ln_1.weight", "ln_1/bias": "ln_1.bias",
        "ln_2/scale": "ln_2.weight", "ln_2/bias": "ln_2.bias",
        "attn/qkv_bias": "attn.in_proj_bias",
        "attn/out_bias": "attn.out_proj.bias",
        "mlp/c_fc/bias": "mlp.c_fc.bias",
        "mlp/c_proj/bias": "mlp.c_proj.bias",
    }
    t = {  # transposed pairs
        "attn/qkv_kernel": "attn.in_proj_weight",
        "attn/out_kernel": "attn.out_proj.weight",
        "mlp/c_fc/kernel": "mlp.c_fc.weight",
        "mlp/c_proj/kernel": "mlp.c_proj.weight",
    }
    for suffix, dst in m.items():
        key = f"{src_prefix}/{suffix}"
        if key in flat:
            out[f"{dst_prefix}.{dst}"] = flat[key]
    for suffix, dst in t.items():
        key = f"{src_prefix}/{suffix}"
        if key in flat:
            out[f"{dst_prefix}.{dst}"] = flat[key].T


def export_state_dict(params: dict, vision_patch_size: int = 16,
                      vision_heads: int = 12) -> Dict[str, np.ndarray]:
    flat = dict(_walk(params))
    out: Dict[str, np.ndarray] = {}

    def put(dst, src, transform=None):
        if src in flat:
            v = flat[src]
            out[dst] = transform(v) if transform else v

    # text side
    put("clip.token_embedding.weight", "clip/token_embedding/embedding")
    put("clip.positional_embedding", "clip/positional_embedding")
    put("clip.text_projection", "clip/text_projection")
    put("clip.logit_scale", "clip/logit_scale")
    put("clip.ln_final.weight", "clip/ln_final/scale")
    put("clip.ln_final.bias", "clip/ln_final/bias")
    i = 0
    while f"clip/transformer/resblocks_{i}/ln_1/scale" in flat:
        _block_keys(out, f"clip/transformer/resblocks_{i}",
                    f"clip.transformer.resblocks.{i}", flat)
        i += 1

    # visual tower
    p = vision_patch_size
    if "clip/visual/conv1" in flat:
        w = flat["clip/visual/conv1"]          # (3·P·P, width)
        width = w.shape[1]
        out["clip.visual.conv1.weight"] = w.T.reshape(width, 3, p, p)
    put("clip.visual.class_embedding", "clip/visual/class_embedding")
    put("clip.visual.positional_embedding", "clip/visual/positional_embedding")
    put("clip.visual.proj", "clip/visual/proj")
    for ln in ("ln_pre", "ln_post"):
        put(f"clip.visual.{ln}.weight", f"clip/visual/{ln}/scale")
        put(f"clip.visual.{ln}.bias", f"clip/visual/{ln}/bias")
    vt = "clip/visual/transformer"
    for group, dst in (("layers0", "layers0"), ("layers2", "layers2"),
                       ("layers_mae2", "layers_mae2")):
        i = 0
        while f"{vt}/{group}_{i}/ln_1/scale" in flat:
            _block_keys(out, f"{vt}/{group}_{i}",
                        f"clip.visual.transformer.{dst}.{i}", flat)
            i += 1

    # semantic learner
    sl = f"{vt}/semantic_layer2"
    dst = "clip.visual.transformer.semantic_layer2"
    put(f"{dst}.semantic_center", f"{sl}/semantic_center")
    for ln in ("norm", "cross_ln", "k_ln"):
        put(f"{dst}.{ln}.weight", f"{sl}/{ln}/scale")
        put(f"{dst}.{ln}.bias", f"{sl}/{ln}/bias")
    i = 0
    while f"{sl}/cross_att_{i}/ln_x/scale" in flat:
        base, bdst = f"{sl}/cross_att_{i}", f"{dst}.cross_att.{i}"
        for ln in ("ln_x", "ln_k", "ln_2"):
            put(f"{bdst}.{ln}.weight", f"{base}/{ln}/scale")
            put(f"{bdst}.{ln}.bias", f"{base}/{ln}/bias")
        put(f"{bdst}.attn.in_proj_weight", f"{base}/attn/qkv_kernel",
            lambda v: v.T)
        put(f"{bdst}.attn.in_proj_bias", f"{base}/attn/qkv_bias")
        put(f"{bdst}.attn.out_proj.weight", f"{base}/attn/out_kernel",
            lambda v: v.T)
        put(f"{bdst}.attn.out_proj.bias", f"{base}/attn/out_bias")
        put(f"{bdst}.mlp.c_fc.weight", f"{base}/mlp/c_fc/kernel",
            lambda v: v.T)
        put(f"{bdst}.mlp.c_fc.bias", f"{base}/mlp/c_fc/bias")
        put(f"{bdst}.mlp.c_proj.weight", f"{base}/mlp/c_proj/kernel",
            lambda v: v.T)
        put(f"{bdst}.mlp.c_proj.bias", f"{base}/mlp/c_proj/bias")
        i += 1
    for conv in ("k_conv", "v_conv"):
        key = f"{sl}/{conv}/kernel"
        if key in flat:
            kern = flat[key]                   # (g, in, out)
            g, din, dout = kern.shape
            w = kern.transpose(0, 2, 1).reshape(g * dout, din, 1)
            out[f"{dst}.{conv}.weight"] = w
    put(f"{dst}.proj_o.ln.weight", f"{sl}/proj_ln/scale")
    put(f"{dst}.proj_o.ln.bias", f"{sl}/proj_ln/bias")
    put(f"{dst}.proj_o.mlp.fc1.weight", f"{sl}/proj_mlp/c_fc/kernel",
        lambda v: v.T)
    put(f"{dst}.proj_o.mlp.fc1.bias", f"{sl}/proj_mlp/c_fc/bias")
    put(f"{dst}.proj_o.mlp.fc2.weight", f"{sl}/proj_mlp/c_proj/kernel",
        lambda v: v.T)
    put(f"{dst}.proj_o.mlp.fc2.bias", f"{sl}/proj_mlp/c_proj/bias")

    # reconstruct
    put("clip.visual.transformer.reconstruct_layer2.rec_proj_a.a_fc.weight",
        f"{vt}/reconstruct_layer2/rec_proj_a/kernel", lambda v: v.T)
    put("clip.visual.transformer.reconstruct_layer2.rec_proj_a.a_fc.bias",
        f"{vt}/reconstruct_layer2/rec_proj_a/bias")

    # MAE decoders
    for name, timm in (("vis_mae_decoder", True), ("seq_mae_decoder", False)):
        if f"{name}/core/mask_token" not in flat:
            continue
        put(f"{name}.decoder_embed.weight", f"{name}/core/decoder_embed/kernel",
            lambda v: v.T)
        put(f"{name}.decoder_embed.bias", f"{name}/core/decoder_embed/bias")
        put(f"{name}.mask_token", f"{name}/core/mask_token")
        put(f"{name}.decoder_norm.weight", f"{name}/core/decoder_norm/scale")
        put(f"{name}.decoder_norm.bias", f"{name}/core/decoder_norm/bias")
        put(f"{name}.decoder_pred.weight", f"{name}/decoder_pred/kernel",
            lambda v: v.T)
        put(f"{name}.decoder_pred.bias", f"{name}/decoder_pred/bias")
        i = 0
        while f"{name}/core/blocks_{i}/norm1/scale" in flat:
            base = f"{name}/core/blocks_{i}"
            bdst = f"{name}.decoder_blocks.{i}"
            for ln in ("norm1", "norm2"):
                put(f"{bdst}.{ln}.weight", f"{base}/{ln}/scale")
                put(f"{bdst}.{ln}.bias", f"{base}/{ln}/bias")
            if timm:
                put(f"{bdst}.attn.qkv.weight", f"{base}/attn/qkv_kernel",
                    lambda v: v.T)
                put(f"{bdst}.attn.qkv.bias", f"{base}/attn/qkv_bias")
                put(f"{bdst}.attn.proj.weight", f"{base}/attn/out_kernel",
                    lambda v: v.T)
                put(f"{bdst}.attn.proj.bias", f"{base}/attn/out_bias")
            else:
                put(f"{bdst}.attn.in_proj_weight", f"{base}/attn/qkv_kernel",
                    lambda v: v.T)
                put(f"{bdst}.attn.in_proj_bias", f"{base}/attn/qkv_bias")
                put(f"{bdst}.attn.out_proj.weight", f"{base}/attn/out_kernel",
                    lambda v: v.T)
                put(f"{bdst}.attn.out_proj.bias", f"{base}/attn/out_bias")
            put(f"{bdst}.mlp.fc1.weight", f"{base}/mlp/c_fc/kernel",
                lambda v: v.T)
            put(f"{bdst}.mlp.fc1.bias", f"{base}/mlp/c_fc/bias")
            put(f"{bdst}.mlp.fc2.weight", f"{base}/mlp/c_proj/kernel",
                lambda v: v.T)
            put(f"{bdst}.mlp.fc2.bias", f"{base}/mlp/c_proj/bias")
            i += 1

    return out


def save_torch_checkpoint(path: str, params: dict,
                          vision_patch_size: int = 16) -> None:
    sd = export_state_dict(params, vision_patch_size=vision_patch_size)
    try:
        import torch
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                   path)
    except ImportError:
        np.savez(path, **sd)
