"""Batched eval (several images per decode call) against the one-image
default (scripts/eval_ipd_study.py).

Runs both over an eval split and reports, per path, mIoU / mAcc / aAcc and
the steady-state img/s (each path makes two passes; the second is timed,
image loading included), the mIoU difference, and the share of evaluated
pixels whose prediction differs between the two paths: at bfloat16 a
larger decode batch may flip near-tie pixels.

    python -m segclip_tpu_torch.studies.eval_ipd_study --data-root shapes_corpus/eval \
        [--ckpt run/ckpt_best/model.pt] [--ipd 4] [--dtype float32] [--device cpu]

Without --ckpt the model is the seeded random init, a harsher test: its
near-uniform affinities give the most near-tie pixels. The batched path is
`ZeroShotSegmenter.predict_batch` over --ipd images at a time in dataset
order (the JAX script's padded-shape buckets exist only for XLA
recompiles).
"""
from __future__ import annotations

import argparse
import time

import torch

from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.evalseg.miou import MIoUMeter
from segclip_tpu_torch.studies.common import (add_device_arg, load_study_model, sync,
                                              write_report)


def collect_sequential(segmenter, dataset):
    """Every image's prediction by `predict`, and the seconds it took."""
    sync(segmenter.device)
    t0 = time.perf_counter()
    preds = {i: segmenter.predict(s.image, s.orig_shape) for i, s in enumerate(dataset)}
    sync(segmenter.device)
    return preds, time.perf_counter() - t0


def collect_batched(segmenter, dataset, ipd: int):
    """Every image's prediction by `predict_batch` over `ipd` images at a
    time, in dataset order, and the seconds it took."""
    preds, group = {}, []

    def flush():
        out = segmenter.predict_batch([s.image for _, s in group],
                                      [s.orig_shape for _, s in group])
        preds.update((i, p) for (i, _), p in zip(group, out))
        group.clear()

    sync(segmenter.device)
    t0 = time.perf_counter()
    for i, s in enumerate(dataset):
        group.append((i, s))
        if len(group) == ipd:
            flush()
    if group:
        flush()
    sync(segmenter.device)
    return preds, time.perf_counter() - t0


def miou_of(preds, dataset, num_classes):
    meter = MIoUMeter(num_classes, ignore_index=dataset.spec.ignore_index)
    for i, s in enumerate(dataset):
        if s.label is not None:
            meter.update(preds[i], s.label)
    return meter.results(dataset.spec.classes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default=None,
                    help="torch checkpoint (.pt/.bin/.pth); omit for the seeded random "
                         "init (near-uniform affinities: the most near-tie pixels)")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--dataset", default="shapes")
    ap.add_argument("--ipd", type=int, default=4)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="model.compute_dtype of the encode; float32 is the "
                         "reference's eval precision")
    ap.add_argument("--matmul-precision", default="highest", choices=["highest", "high"],
                    help="float32 matrix products on the card: highest (full float32, "
                         "TF32 off: the default) or high (TF32)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    model, cfg, device = load_study_model(args.ckpt, args.device, compute_dtype=args.dtype)
    if args.matmul_precision == "high":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    spec = DATASET_SPECS[args.dataset]
    dataset = SegEvalDataset(spec, args.data_root, limit=args.limit)
    print(f"{len(dataset)} images, ipd comparison 1 vs {args.ipd} "
          f"(dtype={args.dtype}, matmul={args.matmul_precision})")

    segmenter = build_segmenter(model, cfg, spec)
    collect_sequential(segmenter, dataset)            # pass 1 warms, pass 2 is timed
    preds_seq, dt_seq = collect_sequential(segmenter, dataset)
    collect_batched(segmenter, dataset, args.ipd)
    preds_b, dt_b = collect_batched(segmenter, dataset, args.ipd)
    print(f"eval_ipd_study: timed pass, one image per call {dt_seq:.3f} s, {args.ipd} per "
          f"call {dt_b:.3f} s ({len(dataset)} images each)")

    r_seq = miou_of(preds_seq, dataset, segmenter.num_classes)
    r_b = miou_of(preds_b, dataset, segmenter.num_classes)
    flipped = total = 0
    for i in preds_seq:
        a, b = preds_seq[i], preds_b[i]
        assert a.shape == b.shape, (i, a.shape, b.shape)
        flipped += int((a != b).sum())
        total += a.size
    out = {
        "n_images": len(dataset),
        "seq": {"mIoU": r_seq["mIoU"], "mAcc": r_seq["mAcc"], "aAcc": r_seq["aAcc"],
                "img_s": round(len(dataset) / dt_seq, 2)},
        f"ipd{args.ipd}": {"mIoU": r_b["mIoU"], "mAcc": r_b["mAcc"], "aAcc": r_b["aAcc"],
                           "img_s": round(len(dataset) / dt_b, 2)},
        "d_miou": round(r_b["mIoU"] - r_seq["mIoU"], 4),
        "flipped_pixel_frac": round(flipped / max(total, 1), 8),
    }
    write_report(out, args.out)
    return out


if __name__ == "__main__":
    main()
