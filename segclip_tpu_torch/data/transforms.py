"""Train/eval image transforms with crop-coordinate tracking (a copy of
segclip_tpu/data/transforms.py; held equal to it by
tests/test_torch_vendored.py, tests/test_torch_data.py and
tests/test_torch_device_aug.py).

Mirrors dataloaders/rawimage_util.py:
  - train: RandomResizedCrop(224, scale=(0.5, 1.0), bicubic) returning
    normalized crop coords [x0, y0, x1, y1] with the (W−1)/(H−1)
    denominators of the reference (rawimage_util.py:355-359); no flip (the
    reference's train transform omits its Flip classes);
  - eval: Resize(short side, bicubic) + CenterCrop;
  - CLIP mean/std normalization in [0,1] space;
  - the yuv420 transport: a YCbCr-native crop-resize and the RGB → Y +
    4:2:0 CbCr conversion.

Randomness is numpy-Generator-driven (no global RNG).
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


def random_resized_crop_yuv420(
    img: Image.Image, size: int, rng: np.random.Generator,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """YCbCr-native RandomResizedCrop for the yuv420 transport path.

    Takes a PIL image already decoded in 'YCbCr' mode (libjpeg's native
    output colorspace — `_decode_jpeg(..., mode='YCbCr')` skips the
    decoder's YCbCr→RGB conversion entirely), crops with the IDENTICAL rng
    window sequence as `random_resized_crop_coord`, and resamples Y at
    `size`² but Cb/Cr directly at (size/2)² — a quarter of the chroma
    resample work, landing straight in the 4:2:0 transport geometry.

    vs the reference-ordered path (RGB bicubic resize → rgb_to_yuv420):
    the color matrix is affine and bicubic resampling is linear, so the two
    orders agree in exact arithmetic; the measured uint8 difference on the
    reconstructed RGB is quantified in tests/test_yuv_transport.py (luma
    within rounding, chroma within the existing 4:2:0 loss envelope).

    Returns (y (size, size) u8, cbcr (size/2, size/2, 2) u8, coord).
    """
    width, height = img.size
    i, j, h, w, coord = sample_crop_window(width, height, rng, scale, ratio)
    if img.mode != "YCbCr":
        img = img.convert("YCbCr")
    crop = img.crop((j, i, j + w, i + h))
    ych, cbch, crch = crop.split()
    half = size // 2
    y = np.asarray(ych.resize((size, size), Image.BICUBIC))
    cb = np.asarray(cbch.resize((half, half), Image.BICUBIC))
    cr = np.asarray(crch.resize((half, half), Image.BICUBIC))
    return y, np.stack([cb, cr], axis=-1), coord


def rgb_to_yuv420(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGB (H, W, 3) → (Y (H, W) uint8, CbCr (H/2, W/2, 2) uint8).

    JFIF/BT.601 full-range matrix — the SAME colorspace the JPEG stored,
    with the SAME 4:2:0 chroma geometry libjpeg decoded from: shipping
    YUV420 to the device sends ~half the bytes of RGB while discarding
    (mostly) only chroma detail the JPEG never had. The device inverts it
    (ops/device_aug.yuv420_to_rgb in the train step); reconstruction error vs the decoded RGB
    is quantified in tests/test_yuv_transport.py. H and W must be even.
    """
    a = arr.astype(np.float32)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    cbcr = np.stack([cb, cr], axis=-1)
    h, w = cbcr.shape[:2]
    # 2x2 box mean (the JPEG encoder's default subsampling filter)
    sub = cbcr.reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    return (np.clip(np.round(y), 0, 255).astype(np.uint8),
            np.clip(np.round(sub), 0, 255).astype(np.uint8))


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
