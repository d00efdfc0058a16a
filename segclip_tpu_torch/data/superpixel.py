"""Felzenszwalb superpixels (native C++) and the crop-from-cache transform
(a copy of segclip_tpu/data/superpixel.py; held equal to it by
tests/test_torch_data.py).

Pretraining protocol (reference): superpixel maps are precomputed offline on
the FULL image (felzenszwalb scale=224 sigma=0.9 min_size=224,
preprocess/COCO/felzenszwalb_extraction_coco.py:31-101) and, at train time,
the random-crop window is cut out of the cached map, nearest-resized to
224², and integer ids are averaged within each 16² patch → a 14×14 per-patch
id map (rawimage_util.py:100-144 — the int-averaging quirk is reproduced
deliberately for parity).
"""
from __future__ import annotations

import ctypes
import json
import math
import struct
import zlib

import numpy as np


def felzenszwalb(image: np.ndarray, scale: float = 224.0,
                 sigma: float = 0.9, min_size: int = 224) -> np.ndarray:
    """image: uint8 or float RGB (H, W, 3). Returns int32 (H, W) labels.

    `scale` follows skimage's convention: pixels are normalized to [0, 1]
    and the threshold constant is scale/255 (skimage rescales internally
    "to behave like the reference implementation", which operated on 0-255
    ints). Passing the raw scale against [0,1] edge weights would merge
    everything into one segment.
    """
    from segclip_tpu_torch.native.build import load
    lib = load()
    img = np.ascontiguousarray(image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    h, w, _ = img.shape
    labels = np.empty((h, w), np.int32)
    n = lib.felzenszwalb_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        ctypes.c_float(scale / 255.0), ctypes.c_float(sigma), min_size,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise RuntimeError("felzenszwalb_segment failed")
    return labels


_SGM2_MAGIC = b"SGM2"


def encode_seg_map(labels: np.ndarray, binary: bool = True) -> bytes:
    """Superpixel-map payload.

    binary=True (default): "SGM2" + u16 h,w + zlib(uint16 labels).
    binary=False writes the reference's zlib(json([h, w, flat])) LMDB payload
    (felzenszwalb_extraction_coco.py) for interchange with its caches.
    """
    h, w = labels.shape
    if binary:
        if labels.max() >= 65536:
            raise ValueError(
                f"{labels.max() + 1} superpixel ids exceed the uint16 binary "
                f"format — encode with binary=False")
        return (_SGM2_MAGIC + struct.pack("<HH", h, w) +
                zlib.compress(labels.astype(np.uint16).tobytes()))
    payload = json.dumps([h, w, labels.reshape(-1).tolist()])
    return zlib.compress(payload.encode("ascii"))


def decode_seg_map(blob: bytes) -> np.ndarray:
    """Decodes both the binary SGM2 format and the reference's zlib-json."""
    if blob[:4] == _SGM2_MAGIC:
        h, w = struct.unpack_from("<HH", blob, 4)
        flat = np.frombuffer(zlib.decompress(blob[8:]), np.uint16)
        return flat.reshape(h, w).astype(np.int32)
    h, w, flat = json.loads(zlib.decompress(blob))
    return np.asarray(flat, np.int32).reshape(h, w)


def _nearest_resize(seg: np.ndarray, out: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') semantics: src = floor(dst·in/out),
    as two axis-wise `take`s."""
    h, w = seg.shape
    ys = np.floor(np.arange(out) * (h / out)).astype(np.int64)
    xs = np.floor(np.arange(out) * (w / out)).astype(np.int64)
    return seg.take(ys, axis=0).take(xs, axis=1)


def crop_seg_from_cache(seg_full: np.ndarray, coord: np.ndarray,
                        img_size: int = 224,
                        patch_size: int = 16) -> np.ndarray:
    """Cut the crop window out of a cached full-image superpixel map.

    coord: normalized (x_ul, y_ul, x_lr, y_lr); reversed order encodes a
    flip (rawimage_util.py:110-128). Returns (patch_len, patch_len) ints —
    superpixel ids averaged over each patch (the reference's integer-mean
    quirk, rawimage_util.py:135-139).
    """
    h_pic, w_pic = seg_full.shape
    x0, y0, x1, y1 = [float(c) for c in coord]

    flip_h = x0 > x1
    flip_v = y0 > y1
    if flip_h:
        x0, x1 = x1, x0
    if flip_v:
        y0, y1 = y1, y0

    xi0, xi1 = int(x0 * w_pic), math.ceil(x1 * w_pic)
    yi0, yi1 = int(y0 * h_pic), math.ceil(y1 * h_pic)

    if yi1 - yi0 < 2 or xi1 - xi0 < 2:
        window = seg_full
    else:
        window = seg_full[yi0:yi1, xi0:xi1]

    if flip_h:
        window = window[:, ::-1]
    if flip_v:
        window = window[::-1, :]

    resized = _nearest_resize(window, img_size)
    p = patch_size
    g = img_size // p
    # integer mean: labels are non-negative, so the truncated float mean is
    # exact integer floor division; an int32 accumulator is exact whenever
    # max_id · p² < 2³¹.
    acc = np.int32 if resized.max(initial=0) < (1 << 31) // (p * p) \
        else np.int64
    sums = resized.reshape(g, p, g, p).sum(axis=3, dtype=acc).sum(axis=1)
    return sums // (p * p)
