"""A copy of segclip_tpu/evalseg/visualize.py, kept in the port so that the
port imports nothing of the JAX package (tests/test_torch_demo.py holds the
copy equal to the original, byte for byte in what it writes).

Segmentation visualization: palette blending and group-assignment views.

Replaces the reference's show_result/blend_result
(seg_segmentation/evaluation/vit_seg.py:258-377) without mmcv/matplotlib:
  modes 'input', 'pred', 'input_pred', 'input_pred_label' (class names drawn
  with PIL), 'all_groups' / 'first_group' / 'final_group' (hard group
  assignment under a deterministic group palette).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


def group_palette(n: int, seed: int = 1) -> np.ndarray:
    """Deterministic bright palette for group-id visualization."""
    rng = np.random.default_rng(seed)
    hues = (np.arange(n) / max(n, 1) + rng.uniform(0, 1 / max(n, 1))) % 1.0
    out = np.zeros((n, 3), np.uint8)
    for i, h in enumerate(hues):
        out[i] = _hsv_to_rgb(h, 0.75, 0.95)
    return out


def _hsv_to_rgb(h: float, s: float, v: float):
    i = int(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
           (v, p, q)][i % 6]
    return tuple(int(c * 255) for c in rgb)


def blend(image: np.ndarray, seg: np.ndarray, palette: np.ndarray,
          opacity: float = 0.5, skip_label0: bool = False) -> np.ndarray:
    """Overlay a segmentation map on an RGB uint8 image."""
    color = palette[np.clip(seg, 0, len(palette) - 1)]
    out = image.astype(np.float32)
    mask = np.ones(seg.shape, bool) if not skip_label0 else seg != 0
    out[mask] = out[mask] * (1 - opacity) + color[mask] * opacity
    return out.astype(np.uint8)


def draw_labels(image: np.ndarray, seg: np.ndarray,
                class_names: Sequence[str], with_bg: bool) -> np.ndarray:
    """Write each present class's name at its region centroid."""
    img = Image.fromarray(image)
    draw = ImageDraw.Draw(img)
    for label in np.unique(seg):
        if with_bg and label == 0:
            continue
        ys, xs = np.nonzero(seg == label)
        cy, cx = float(ys.mean()), float(xs.mean())
        text = class_names[int(label)]
        draw.text((cx + 1, cy + 1), text, fill=(0, 0, 0))
        draw.text((cx, cy), text, fill=(255, 69, 0))
    return np.asarray(img)


def save_visualization(mode: str, out_file: str, image: np.ndarray,
                       pred: np.ndarray, palette: np.ndarray,
                       class_names: Sequence[str], with_bg: bool,
                       group_maps: Optional[Sequence[np.ndarray]] = None
                       ) -> list:
    """group_maps: list of (H, W) hard group-id maps (one per grouping
    stage) for the *_group modes. Returns the path(s) actually written —
    'pred' saves a palettized PNG regardless of out_file's extension
    (indexed-palette images can't be JPEG)."""
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)

    if mode == "input":
        Image.fromarray(image).save(out_file)
        return [out_file]
    if mode == "pred":
        out = Image.fromarray(pred.astype(np.uint8)).convert("P")
        out.putpalette(palette.astype(np.uint8).flatten())
        target = os.path.splitext(out_file)[0] + ".png"
        out.save(target)
        return [target]
    if mode == "input_pred":
        Image.fromarray(blend(image, pred, palette, 0.8,
                              skip_label0=with_bg)).save(out_file)
        return [out_file]
    if mode == "input_pred_label":
        blended = blend(image, pred, palette, 0.6, skip_label0=with_bg)
        Image.fromarray(draw_labels(blended, pred, class_names,
                                    with_bg)).save(out_file)
        return [out_file]
    if mode in ("all_groups", "first_group", "final_group"):
        assert group_maps, "group modes need group_maps"
        indices = range(len(group_maps))
        if mode == "first_group":
            indices = [0]
        elif mode == "final_group":
            indices = [len(group_maps) - 1]
        written = []
        for li in indices:
            gmap = group_maps[li]
            pal = group_palette(int(gmap.max()) + 1)
            target = out_file
            if mode == "all_groups":
                root, ext = os.path.splitext(out_file)
                target = f"{root}_layer{li}{ext}"
            Image.fromarray(blend(image, gmap, pal, 0.6)).save(target)
            written.append(target)
        return written
    raise ValueError(f"unknown vis mode {mode!r}")
