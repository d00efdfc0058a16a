"""Zero-shot segmentation inference (segclip_tpu/evalseg/inference.py):
group-attention decode and the sliding window.

  - one encode_image per batch of crops;
  - the soft patch→group attention is bilinearly upsampled to pixels and
    turned into a one-hot argmax over groups;
  - group↔class affinity softmax with the image-level top-5 class gate and
    the per-crop background threshold min(bg_thresh, crop max);
  - sliding window with mmseg slide_inference semantics: edge-aligned
    windows, logits averaged where they overlap.

The JAX package pads crops to power-of-two buckets and caches jitted
programs per shape; both exist only for XLA recompiles, and eager PyTorch
has no use for them.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from segclip_tpu_torch.evalseg.miou import MIoUMeter
from segclip_tpu_torch.ops.pos_embed import interp_tensor


def _upsample_attn(soft_attn: torch.Tensor, gh: int, gw: int, out_h: int,
                   out_w: int) -> torch.Tensor:
    """(N, G, gh·gw) → (N, out_h, out_w, G), bilinear with torch
    align_corners=False semantics, as two matmuls."""
    n, g, _ = soft_attn.shape
    attn = soft_attn.reshape(n, g, gh, gw).float()
    mh = interp_tensor(gh, out_h, "linear", attn.device)
    mw = interp_tensor(gw, out_w, "linear", attn.device)
    attn = torch.einsum("oh,nghw->ngow", mh, attn)
    attn = torch.einsum("pw,ngow->ngop", mw, attn)
    return attn.permute(0, 2, 3, 1)


def _resize_chw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(C, H, W) → (C, out_h, out_w) bilinear, fp32."""
    _, h, w = x.shape
    mh = interp_tensor(h, out_h, "linear", x.device)
    mw = interp_tensor(w, out_w, "linear", x.device)
    y = torch.einsum("oh,chw->cow", mh, x.float())
    return torch.einsum("pw,cow->cop", mw, y)


def _decode_crops(model, crops: torch.Tensor, text_bank: torch.Tensor,
                  with_bg: bool, bg_thresh: float, out_h: int, out_w: int,
                  gh: int, gw: int) -> torch.Tensor:
    """crops (N, h, w, 3) → per-pixel class logits (N, C[+bg], out_h, out_w)."""
    vis = model.encode_image(crops)
    attn_up = _upsample_attn(vis.mid["soft_attn"], gh, gw, out_h, out_w)
    onehot = F.one_hot(attn_up.argmax(dim=-1), attn_up.shape[-1]).float()

    groups = vis.hidden[:, 1:, :].float()                 # (N, G, E)
    pooled = vis.pooled.float()                           # (N, E)
    groups = groups / groups.norm(dim=-1, keepdim=True)
    pooled = pooled / pooled.norm(dim=-1, keepdim=True)

    scale = model.clip.logit_scale.float().exp().clamp(max=100.0)
    text = text_bank.float()                              # (C, E)

    group_aff = torch.einsum("nge,ce->ngc", groups, text) * scale
    pre_aff = torch.softmax(group_aff, dim=-1)
    avg_aff = torch.softmax(torch.einsum("ne,ce->nc", pooled, text) * scale,
                            dim=-1)
    top_idx = avg_aff.topk(min(5, text.shape[0]), dim=-1).indices
    gate = torch.zeros_like(avg_aff).scatter_(1, top_idx, 1.0)
    gated = group_aff.masked_fill(gate[:, None, :] == 0, float("-inf"))
    aff = torch.softmax(gated, dim=-1) * pre_aff          # (N, G, C)

    fg = torch.einsum("nhwg,ngc->nhwc", onehot, aff)      # (N, H, W, C)
    if with_bg:
        crop_max = aff.amax(dim=(1, 2))                   # (N,)
        thresh = crop_max.clamp(max=bg_thresh)[:, None, None]
        bg = (fg.amax(dim=-1) < thresh).float()[..., None]
        fg = torch.cat([bg, fg], dim=-1)
    return fg.permute(0, 3, 1, 2)


class ZeroShotSegmenter:
    """Zero-shot segmentation of one image at a time with a fixed text bank;
    runs on the device of `text_bank` (where the model lives)."""

    def __init__(self, model, text_bank: torch.Tensor, with_bg: bool,
                 bg_thresh: float, patch_size: int = 16, crop_size: int = 224,
                 stride: int = 224):
        self.model = model
        self.text_bank = text_bank
        self.device = text_bank.device
        self.with_bg = with_bg
        self.bg_thresh = bg_thresh
        self.patch = patch_size
        self.crop = crop_size
        self.stride = stride
        self.num_classes = text_bank.shape[0] + (1 if with_bg else 0)

    def _decode(self, crops: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(self.device)
        gh, gw = x.shape[1] // self.patch, x.shape[2] // self.patch
        return _decode_crops(self.model, x, self.text_bank, self.with_bg,
                             self.bg_thresh, out_h, out_w, gh, gw)

    def _windows(self, h: int, w: int):
        """Edge-aligned slide windows (mmseg slide_inference semantics)."""
        hs = max(1, math.ceil((h - self.crop) / self.stride) + 1)
        ws = max(1, math.ceil((w - self.crop) / self.stride) + 1)
        wins = []
        for i in range(hs):
            for j in range(ws):
                y2 = min(i * self.stride + self.crop, h)
                x2 = min(j * self.stride + self.crop, w)
                y1, x1 = max(y2 - self.crop, 0), max(x2 - self.crop, 0)
                wins.append((y1, x1, y2, x2))
        return wins

    def _slide(self, image: np.ndarray) -> torch.Tensor:
        h0, w0, _ = image.shape
        if h0 < self.crop or w0 < self.crop:
            image = np.pad(image, ((0, max(0, self.crop - h0)),
                                   (0, max(0, self.crop - w0)), (0, 0)))
        h, w, _ = image.shape
        wins = self._windows(h, w)
        crops = np.stack([image[y1:y2, x1:x2] for y1, x1, y2, x2 in wins])
        logits = self._decode(crops, self.crop, self.crop)
        canvas = torch.zeros((self.num_classes, h, w), device=self.device)
        count = torch.zeros((1, h, w), device=self.device)
        for lg, (y1, x1, y2, x2) in zip(logits, wins):
            canvas[:, y1:y2, x1:x2] += lg
            count[:, y1:y2, x1:x2] += 1.0
        return (canvas / count)[:, :h0, :w0]

    def _whole(self, image: np.ndarray) -> torch.Tensor:
        h, w, _ = image.shape
        hf = h // self.patch * self.patch
        wf = w // self.patch * self.patch
        return self._decode(image[None, :hf, :wf], h, w)[0]

    @torch.inference_mode()
    def slide(self, image: np.ndarray) -> np.ndarray:
        """image: normalised (H, W, 3) → class logits (C, H, W). Images
        smaller than the crop on a side are zero-padded to it and the
        logits cropped back."""
        return self._slide(image).cpu().numpy()

    @torch.inference_mode()
    def whole(self, image: np.ndarray) -> np.ndarray:
        """Whole-image mode: the encoder floors H and W to patch multiples;
        the attention maps are upsampled to the full (H, W)."""
        return self._whole(image).cpu().numpy()

    @torch.inference_mode()
    def group_map(self, image: np.ndarray) -> np.ndarray:
        """Hard patch→group assignment upsampled to pixels, (H, W) int32."""
        h, w, _ = image.shape
        hf = h // self.patch * self.patch
        wf = w // self.patch * self.patch
        x = torch.from_numpy(np.ascontiguousarray(image[None, :hf, :wf],
                                                  np.float32)).to(self.device)
        vis = self.model.encode_image(x)
        attn = _upsample_attn(vis.mid["soft_attn"], hf // self.patch,
                              wf // self.patch, h, w)[0]
        return attn.argmax(dim=-1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def predict(self, image: np.ndarray, orig_shape: Tuple[int, int],
                mode: str = "slide") -> np.ndarray:
        """Class prediction (H0, W0) int32 at the ORIGINAL resolution
        (mmseg rescale=True: bilinear logits upsample, then argmax)."""
        if mode not in ("slide", "whole"):
            raise ValueError(f"mode must be slide or whole, got {mode!r}")
        logits = self._slide(image) if mode == "slide" else self._whole(image)
        oh, ow = orig_shape
        if logits.shape[1:] != (oh, ow):
            logits = _resize_chw(logits, oh, ow)
        return logits.argmax(dim=0).to(torch.int32).cpu().numpy()


def evaluate_dataset(segmenter: ZeroShotSegmenter, dataset,
                     log_every: int = 50, logger=None) -> dict:
    """Zero-shot mIoU over a SegEvalDataset, one image at a time."""
    meter = MIoUMeter(segmenter.num_classes,
                      ignore_index=dataset.spec.ignore_index)
    for i, sample in enumerate(dataset):
        pred = segmenter.predict(sample.image, sample.orig_shape)
        if sample.label is not None:
            meter.update(pred, sample.label)
        if logger and (i + 1) % log_every == 0:
            logger.info("eval %d/%d  running mIoU %.2f", i + 1, len(dataset),
                        meter.results()["mIoU"])
    return meter.results(dataset.spec.classes)
