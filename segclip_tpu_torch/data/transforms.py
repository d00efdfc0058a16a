"""Train/eval image transforms with crop-coordinate tracking (a copy of the
rgb functions of segclip_tpu/data/transforms.py; held equal to them by
tests/test_torch_vendored.py and tests/test_torch_data.py).

Mirrors dataloaders/rawimage_util.py:
  - train: RandomResizedCrop(224, scale=(0.5, 1.0), bicubic) returning
    normalized crop coords [x0, y0, x1, y1] with the (W−1)/(H−1)
    denominators of the reference (rawimage_util.py:355-359); no flip (the
    reference's train transform omits its Flip classes);
  - eval: Resize(short side, bicubic) + CenterCrop;
  - CLIP mean/std normalization in [0,1] space.

The yuv420 transport's functions are not ported (ROADMAP.md, "do not
port"). Randomness is numpy-Generator-driven (no global RNG).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 RGB → normalized float32 (CLIP statistics)."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def sample_crop_window(
    width: int, height: int, rng: np.random.Generator,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[int, int, int, int, np.ndarray]:
    """Draw a RandomResizedCrop window: (i, j, h, w, coord). coord is the
    reference's normalized (W−1)/(H−1) form (rawimage_util.py:355-359)."""
    area = float(width * height)
    i = j = h = w = None
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = math.exp(rng.uniform(math.log(ratio[0]),
                                      math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= width and 0 < ch <= height:
            i = int(rng.integers(0, height - ch + 1))
            j = int(rng.integers(0, width - cw + 1))
            h, w = ch, cw
            break
    if i is None:
        # central fallback (torchvision semantics)
        in_ratio = width / height
        if in_ratio < ratio[0]:
            w = width
            h = int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            h = height
            w = int(round(h * ratio[1]))
        else:
            w, h = width, height
        i, j = (height - h) // 2, (width - w) // 2

    if width == 1 or height == 1:
        coord = np.zeros(4, np.float32)
    else:
        coord = np.array([j / (width - 1), i / (height - 1),
                          (j + w - 1) / (width - 1),
                          (i + h - 1) / (height - 1)], np.float32)
    return i, j, h, w, coord


def random_resized_crop_coord(
    img: Image.Image, size: int, rng: np.random.Generator,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (uint8 RGB (size, size, 3), coord float32 (4,))."""
    width, height = img.size
    i, j, h, w, coord = sample_crop_window(width, height, rng, scale, ratio)
    # crop() THEN resize (not resize(box=...), whose bicubic kernel reads
    # pixels outside the box — not torchvision resized_crop semantics).
    if img.mode != "RGB":
        img = img.convert("RGB")
    crop = img.crop((j, i, j + w, i + h)).resize((size, size), Image.BICUBIC)
    return np.asarray(crop), coord


def eval_transform(img: Image.Image, size: int = 224) -> np.ndarray:
    """Resize short side + center crop (eval path, rawimage_util.py:47)."""
    w, h = img.size
    s = size / min(w, h)
    img = img.resize((max(size, int(round(w * s))),
                      max(size, int(round(h * s)))), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"))
