"""Shared CLI plumbing: the model from a seeded random init or a
reference-layout torch state dict (segclip_tpu/cli/common.py)."""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from segclip_tpu_torch.config import ModelConfig
from segclip_tpu_torch.checkpoint.convert import (load_into,
                                                  load_reference_state_dict)
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip

logger = logging.getLogger("segclip_tpu_torch")


def load_model(init_model: Optional[str], cfg: ModelConfig,
               device: torch.device) -> Tuple[SegCLIP, ModelConfig]:
    """Build SegCLIP on `device`, in eval mode.

    init_model may be a reference-layout torch state dict (`.bin`, `.pt`,
    `.pth`; the architecture comes from `cfg`), or None for a random init
    from seed 0, as the JAX package's."""
    model = init_segclip(cfg, seed=0)
    if init_model:
        if not init_model.endswith((".bin", ".pt", ".pth")):
            raise ValueError(f"--init-model must be a torch state dict "
                             f"(.bin/.pt/.pth), got {init_model!r}")
        dropped = load_into(model, load_reference_state_dict(init_model))
        logger.info("loaded %s (fixed tables checked and dropped: %s)",
                    init_model, ", ".join(dropped) or "none")
    else:
        logger.info("random initialization (seed 0)")
    return model.to(device).eval(), cfg
