"""SegCLIP's zero-shot segmentation in plain PyTorch: the text bank, the
group-attention decode of a crop and the sliding window (the reference
repository's seg_segmentation, mmseg's slide_inference).

  - text bank: each class name in each template, tokenized, through the
    text tower; the mean over templates, L2-normalised;
  - a crop: the soft patch→group attention bilinearly upsampled to the
    crop's pixels, each pixel given its arg-max group; each group's class
    affinity is softmax(scale·cos) gated to the five classes the whole crop
    matches best, times the ungated softmax; a pixel's class logits are its
    group's affinities; with a background class, a pixel is background
    where its best affinity is under min(bg_thresh, the crop's largest);
  - the image: edge-aligned windows of `crop` every `stride` pixels (zero
    padding where the image is smaller), logits averaged where windows
    overlap, then resized bilinearly to the original size.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import Params, Precision, Sizes, encode_image, encode_text
from portbench.reference.tokenizer import tokenizer


def text_bank(P: Params, s: Sizes, classnames: Sequence[str], templates: Sequence[str],
              prec: Precision, device) -> torch.Tensor:
    prompts = [t.format(c) for c in classnames for t in templates]
    ids = torch.from_numpy(tokenizer().tokenize(prompts, s.context_length)).to(device)
    emb = encode_text(P, s, ids, prec).reshape(len(classnames), len(templates), -1).mean(dim=1)
    return emb / emb.norm(dim=-1, keepdim=True)


def decode_crops(P: Params, s: Sizes, crops: torch.Tensor, bank: torch.Tensor, with_bg: bool,
                 bg_thresh: float, prec: Precision) -> torch.Tensor:
    """crops (N, h, w, 3) → class logits (N, C[+1], h, w)."""
    n, h, w, _ = crops.shape
    pooled, groups, soft, _ = encode_image(P, s, crops, prec)
    g = soft.shape[1]
    attn = F.interpolate(soft.reshape(n, g, s.grid, s.grid), size=(h, w), mode="bilinear",
                         align_corners=False)
    which = F.one_hot(attn.argmax(dim=1), g).float()                  # (N, h, w, G)
    groups = groups / groups.norm(dim=-1, keepdim=True)
    pooled = pooled / pooled.norm(dim=-1, keepdim=True)
    scale = P["clip.logit_scale"].exp().clamp(max=100.0)
    group_aff = prec.mm(groups, bank.t()) * scale                       # (N, G, C)
    whole = torch.softmax(prec.mm(pooled, bank.t()) * scale, dim=-1)    # (N, C)
    top = whole.topk(min(5, bank.shape[0]), dim=-1).indices
    gate = torch.zeros_like(whole).scatter_(1, top, 1.0)
    gated = group_aff.masked_fill(gate[:, None, :] == 0, float("-inf"))
    aff = torch.softmax(gated, dim=-1) * torch.softmax(group_aff, dim=-1)
    fg = prec.mm(which.reshape(n, h * w, g), aff).reshape(n, h, w, -1)
    if with_bg:
        thresh = aff.amax(dim=(1, 2)).clamp(max=bg_thresh)[:, None, None]
        bg = (fg.amax(dim=-1) < thresh).float()[..., None]
        fg = torch.cat([bg, fg], dim=-1)
    return fg.permute(0, 3, 1, 2)


def windows(h: int, w: int, crop: int, stride: int) -> List[Tuple[int, int, int, int]]:
    rows = max(1, math.ceil((h - crop) / stride) + 1)
    cols = max(1, math.ceil((w - crop) / stride) + 1)
    out = []
    for i in range(rows):
        for j in range(cols):
            y2, x2 = min(i * stride + crop, h), min(j * stride + crop, w)
            out.append((max(y2 - crop, 0), max(x2 - crop, 0), y2, x2))
    return out


def slide_logits(P: Params, s: Sizes, image: torch.Tensor, bank: torch.Tensor, with_bg: bool,
                 bg_thresh: float, crop: int, stride: int, prec: Precision) -> torch.Tensor:
    """image (H, W, 3) normalised → the stitched logits (C, H, W)."""
    h0, w0, _ = image.shape
    padded = F.pad(image, (0, 0, 0, max(0, crop - w0), 0, max(0, crop - h0)))
    h, w = padded.shape[:2]
    wins = windows(h, w, crop, stride)
    crops = torch.stack([padded[y1:y2, x1:x2] for y1, x1, y2, x2 in wins])
    logits = decode_crops(P, s, crops, bank, with_bg, bg_thresh, prec)
    canvas = torch.zeros((logits.shape[1], h, w), device=image.device)
    count = torch.zeros((1, h, w), device=image.device)
    for lg, (y1, x1, y2, x2) in zip(logits, wins):
        canvas[:, y1:y2, x1:x2] += lg
        count[:, y1:y2, x1:x2] += 1
    return (canvas / count)[:, :h0, :w0]


def resize_logits(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    if logits.shape[1:] == (out_h, out_w):
        return logits
    return F.interpolate(logits[None], size=(out_h, out_w), mode="bilinear",
                         align_corners=False)[0]
