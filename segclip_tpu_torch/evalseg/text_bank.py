"""Class-name text-embedding bank (segclip_tpu/evalseg/text_bank.py):
tokenize template × class prompts, encode, mean over templates, then
L2-normalise (after the mean)."""
from __future__ import annotations

from typing import Sequence

import torch

from segclip_tpu.data.tokenizer import default_tokenizer
from segclip_tpu.evalseg.templates import TEMPLATE_SETS


@torch.inference_mode()
def build_text_bank(model, classnames: Sequence[str],
                    template_set: str = "simple",
                    context_length: int = 77) -> torch.Tensor:
    """(num_classes, embed_dim) normalised fp32 embeddings, on the model's
    device."""
    templates = TEMPLATE_SETS[template_set]
    prompts = [t.format(name) for name in classnames for t in templates]
    ids = default_tokenizer().batch_tokenize(prompts, context_length)
    device = next(model.parameters()).device
    emb = model.encode_text(torch.from_numpy(ids).long().to(device)).pooled
    emb = emb.float().reshape(len(classnames), len(templates), -1).mean(dim=1)
    return emb / emb.norm(dim=-1, keepdim=True)
