"""Shared CLI plumbing: the model from a torch checkpoint, an Orbax
directory or a seeded random init (segclip_tpu/cli/common.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from segclip_tpu_torch.checkpoint import orbax_io
from segclip_tpu_torch.checkpoint.convert import load_into
from segclip_tpu_torch.checkpoint.torch_convert import (infer_model_config,
                                                        load_torch_state_dict,
                                                        merge_state_dict, to_port_layout)
from segclip_tpu_torch.config import ModelConfig
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip
from segclip_tpu_torch.utils.logging import get_logger


def load_model(init_model: Optional[str], cfg: ModelConfig, device: torch.device,
               infer_from_ckpt: bool = True) -> Tuple[SegCLIP, ModelConfig]:
    """Build SegCLIP on `device`, in eval mode; returns it and its config.

    init_model may be:
      - a torch checkpoint: OpenAI's TorchScript `ViT-B-16.pt`, a reference
        `segclip.bin`, or the port's own `ckpt_epoch_N/model.pt` (`.pt`,
        `.bin`, `.pth`). The architecture is inferred from its tensor shapes
        unless infer_from_ckpt=False; the split point, the grouping
        bottleneck and the loss switches below stay the caller's. Weights
        the file lacks keep the seeded init (seed 0), and are reported;
      - an Orbax directory the JAX package wrote (save_params, or a whole
        training checkpoint `ckpt_epoch_N`, whose params are taken), or the
        port's orbax_io wrote: every parameter is loaded strictly (a
        decoder the configuration does not build is dropped); the
        architecture is inferred as above;
      - None: a random init from seed 0, as the JAX package's."""
    logger = get_logger()
    if not init_model:
        logger.info("random initialization (no --init-model)")
        return init_segclip(cfg, seed=0).to(device).eval(), cfg
    orbax = not init_model.endswith((".pt", ".bin", ".pth"))
    if orbax:
        sd = orbax_io.state_dict_from_tree(orbax_io.restore_params(init_model))
    else:
        sd = load_torch_state_dict(init_model)
    if infer_from_ckpt:
        cfg = infer_model_config(
            sd, first_stage_layer=cfg.first_stage_layer, base=cfg,
            group_num=cfg.group_num, cross_layer=cfg.cross_layer,
            use_vision_mae_recon=cfg.use_vision_mae_recon,
            use_text_mae_recon=cfg.use_text_mae_recon,
            use_seglabel=cfg.use_seglabel, max_words=cfg.max_words,
            compute_dtype=cfg.compute_dtype, attention_impl=cfg.attention_impl)
    model = init_segclip(cfg, seed=0)
    if orbax:
        dropped = load_into(model, sd)
        logger.info("restored Orbax params from %s%s", init_model,
                    f" (dropped {dropped})" if dropped else "")
    else:
        merge_state_dict(model, to_port_layout(sd, cfg.first_stage_layer),
                         log_fn=logger.info)
        logger.info("loaded torch checkpoint %s", init_model)
    return model.to(device).eval(), cfg
