"""Shared CLI plumbing: the model from a torch checkpoint or a seeded random
init (segclip_tpu/cli/common.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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
      - None: a random init from seed 0, as the JAX package's.
    The JAX package also reads Orbax parameter directories; the port does
    not (ROADMAP.md, 'do not port')."""
    logger = get_logger()
    if init_model and not init_model.endswith((".pt", ".bin", ".pth")):
        raise ValueError(f"--init-model must be a torch checkpoint (.pt/.bin/.pth), "
                         f"got {init_model!r}: Orbax directories are not read by the "
                         f"port (ROADMAP.md)")
    if not init_model:
        logger.info("random initialization (no --init-model)")
        return init_segclip(cfg, seed=0).to(device).eval(), cfg
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
    merge_state_dict(model, to_port_layout(sd, cfg.first_stage_layer),
                     log_fn=logger.info)
    logger.info("loaded torch checkpoint %s", init_model)
    return model.to(device).eval(), cfg
