"""Pixel-level margin probe: WHO beats a minority class at its own pixels?
(scripts/spatial_margin_probe.py)

The decode gives each pixel its group's class affinity and a background
indicator `max_fg_aff < bg_thresh`, so a minority class can lose its own
pixels two ways: another class out-scores it among the foreground channels
(confusion), or it is the foreground argmax but its affinity sits below
the threshold and the pixel falls to background (threshold). Per GT class
this reports the foreground argmax at the class's own pixels, where the
final prediction went (background / own / another class) and the mean
affinities of the own channel and of the best other one.

    python -m segclip_tpu_torch.studies.spatial_margin_probe \
        --ckpt run/ckpt_best/model.pt --data-root shapes_corpus/eval \
        [--out runR_marginprobe.json] [--device cpu]

The best other channel is chosen by index (the top-2 value where the own
channel is the foreground argmax, else the top-1), where the JAX script
compares values (`np.isclose(own, top1)`): the two agree unless the own
channel ties or nearly ties the argmax. The logits are upsampled to the
original size as cv2.resize(INTER_LINEAR) does on float32, without cv2.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.studies.common import (add_device_arg, load_study_model, sync,
                                              write_report)


def linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of cv2's INTER_LINEAR along one
    axis: half-pixel centres, the source coordinate rounded to float32 as
    cv2 computes it, edges clamped, two taps (no antialias when
    shrinking)."""
    fx = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    sx = np.floor(fx)
    fx = fx - sx
    sx = sx.astype(np.int64)
    low, high = sx < 0, sx >= in_size - 1
    fx[low | high] = 0.0
    sx = np.clip(sx, 0, in_size - 1)
    rows = np.arange(out_size)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[rows, sx] = np.float32(1.0) - fx
    mat[rows[~high], sx[~high] + 1] = fx[~high]
    return mat


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(C, H, W) → (C, out_h, out_w) float32, as cv2.resize(INTER_LINEAR)
    of the (H, W, C) array: along the width first, then the height."""
    _, h, w = x.shape
    mw = torch.from_numpy(linear_matrix(w, out_w)).to(x.device)
    mh = torch.from_numpy(linear_matrix(h, out_h)).to(x.device)
    y = torch.einsum("pw,chw->chp", mw, x.float())
    return torch.einsum("oh,chp->cop", mh, y)


def best_other(fg: np.ndarray, c: int) -> np.ndarray:
    """Per pixel of the foreground affinities `fg` (n, C − 1), the largest
    affinity among the channels other than class c's (channel c − 1)."""
    top = np.sort(fg, axis=-1)
    own_is_top = fg.argmax(axis=-1) + 1 == c
    return np.where(own_is_top, top[:, -2], top[:, -1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-root", required=True,
                    help="standard eval dir (VOC layout, shapes spec)")
    ap.add_argument("--template", default="simple")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--opts", nargs="*", default=[])
    add_device_arg(ap)
    args = ap.parse_args(argv)

    model, cfg, device = load_study_model(args.ckpt, args.device, args.opts)
    spec = DATASET_SPECS["shapes"]
    dataset = SegEvalDataset(spec, args.data_root, limit=args.limit)
    t0 = time.perf_counter()
    seg = build_segmenter(model, cfg, spec, template_set=args.template)
    classes = list(spec.classes)           # ['background', 6 shapes]
    n_cls = len(classes)
    print(f"{len(dataset)} images, bg_thresh={seg.bg_thresh}")

    # per GT class: counts of (fg argmax == own), the final prediction's
    # histogram, and the affinity sums of the own and the best other channel
    fg_own = np.zeros(n_cls, np.int64)
    npix = np.zeros(n_cls, np.int64)
    pred_hist = np.zeros((n_cls, n_cls), np.int64)
    own_aff_sum = np.zeros(n_cls, np.float64)
    best_other_sum = np.zeros(n_cls, np.float64)

    for i, s in enumerate(dataset):
        oh, ow = s.orig_shape
        with torch.inference_mode():
            logits = seg._slide(s.image)                    # (C, h, w)
            up = resize_linear(logits, oh, ow).permute(1, 2, 0).cpu().numpy()
        pred = up.argmax(axis=-1)
        fg = up[..., 1:]                                    # the shape channels
        fg_arg = fg.argmax(axis=-1) + 1
        label = s.label
        for c in range(1, n_cls):
            m = label == c
            k = int(m.sum())
            if not k:
                continue
            npix[c] += k
            fg_own[c] += int((fg_arg[m] == c).sum())
            pred_hist[c] += np.bincount(pred[m], minlength=n_cls)
            own_aff_sum[c] += float(fg[..., c - 1][m].sum())
            best_other_sum[c] += float(best_other(fg[m], c).sum())
        if (i + 1) % 50 == 0:
            print(f"  {i + 1}/{len(dataset)}")
    sync(device)
    print(f"spatial_margin_probe: {len(dataset)} images, "
          f"{time.perf_counter() - t0:.2f} s (text bank, decode and probe)")

    report = {"ckpt": args.ckpt, "bg_thresh": seg.bg_thresh, "per_class": {}}
    for c in range(1, n_cls):
        if not npix[c]:
            continue
        n = float(npix[c])
        report["per_class"][classes[c]] = {
            "gt_pixels": int(npix[c]),
            "fg_argmax_is_own": round(fg_own[c] / n, 4),
            "pred_background": round(pred_hist[c, 0] / n, 4),
            "pred_own": round(pred_hist[c, c] / n, 4),
            "pred_other_fg": round((n - pred_hist[c, 0] - pred_hist[c, c]) / n, 4),
            "mean_own_aff": round(own_aff_sum[c] / n, 4),
            "mean_best_other_fg_aff": round(best_other_sum[c] / n, 4),
        }
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    main()
