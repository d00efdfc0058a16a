"""Open-vocabulary compositional-generalization study
(scripts/holdout_study.py).

Open vocabulary means class names are chosen at eval time. From scratch,
held-out *words* are untestable (no language prior), but held-out
*compositions* of seen words are: train with some color × shape pairs kept
out of every image and caption (`prepare_data shapes --holdout`), then
probe a checkpoint on the per-pair split two ways:

  (a) the standard shape-name bank: per-class IoU on images whose pair was
      held out of training against images of the same shape in seen
      colors;
  (b) composed queries: a bank of the 48 "{color} {shape}" names through
      the same templates, the GT remapped per image to its pair id.

    python -m segclip_tpu_torch.studies.holdout_study \
        --ckpt run/ckpt_epoch_3/model.pt --data-root shapes_holdout_corpus \
        [--out runH6_holdout.json] [--device cpu]

It reads the corpus's holdout.json and pair_eval/ (pairs.json and a
VOC-layout split), as the port's `cli.prepare_data shapes --holdout`
writes them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
from segclip_tpu_torch.data.procgen import COLORS, SHAPE_CLASSES
from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
from segclip_tpu_torch.evalseg.miou import MIoUMeter
from segclip_tpu_torch.evalseg.text_bank import build_text_bank
from segclip_tpu_torch.studies.common import (add_device_arg, load_study_model, sync,
                                              write_report)


def load_manifests(data_root: str):
    with open(os.path.join(data_root, "holdout.json")) as f:
        holdout = {tuple(p) for p in json.load(f)["holdout_pairs"]}
    with open(os.path.join(data_root, "pair_eval", "pairs.json")) as f:
        pairs = json.load(f)
    return holdout, pairs


def eval_standard_bank(segmenter, dataset, pairs, holdout, spec):
    """(a): the shape-name bank, meters split by held-out against seen pair."""
    meters = {"held_out": MIoUMeter(segmenter.num_classes, spec.ignore_index),
              "seen": MIoUMeter(segmenter.num_classes, spec.ignore_index)}
    for s in dataset:
        p = pairs[s.name]
        pred = segmenter.predict(s.image, s.orig_shape)
        key = "held_out" if (p["color"], p["shape"]) in holdout else "seen"
        meters[key].update(pred, s.label)
    return {k: m.results(spec.classes) for k, m in meters.items()}


def eval_composed_bank(model, cfg, dataset, pairs, holdout, spec,
                       template_set: str = "simple"):
    """(b): one bank over every '{color} {shape}' name; each image's GT is its
    binary shape mask remapped to the image's pair id."""
    pair_names = [f"{c} {k}" for k in SHAPE_CLASSES for c in COLORS]
    # keyed (color, shape) like the manifests; 0 is background
    pair_id = {tuple(n.split(" ", 1)): i + 1 for i, n in enumerate(pair_names)}
    bank = build_text_bank(model, pair_names, template_set,
                           context_length=cfg.context_length)
    seg = ZeroShotSegmenter(model, bank, with_bg=True, bg_thresh=spec.bg_thresh,
                            patch_size=cfg.vision_patch_size)
    meters = {"held_out": MIoUMeter(seg.num_classes, spec.ignore_index),
              "seen": MIoUMeter(seg.num_classes, spec.ignore_index)}
    per_pair = {}
    for s in dataset:
        p = pairs[s.name]
        pid = pair_id[(p["color"], p["shape"])]
        label = np.where(s.label > 0, pid, 0).astype(s.label.dtype)
        pred = seg.predict(s.image, s.orig_shape)
        key = "held_out" if (p["color"], p["shape"]) in holdout else "seen"
        meters[key].update(pred, label)
        m = per_pair.setdefault((p["color"], p["shape"]),
                                MIoUMeter(seg.num_classes, spec.ignore_index))
        m.update(pred, label)
    names = ["background"] + pair_names
    out = {k: m.results(names) for k, m in meters.items()}
    out["per_pair_iou"] = {
        f"{c} {k}": (None if np.isnan(v) else round(float(v), 2))
        for (c, k), m in sorted(per_pair.items())
        for v in [m.results()["IoU"][pair_id[(c, k)]]]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-root", required=True,
                    help="corpus dir with holdout.json and pair_eval/")
    ap.add_argument("--template", default="simple")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="ModelConfig overrides key=value")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    model, cfg, device = load_study_model(args.ckpt, args.device, args.opts)
    holdout, pairs = load_manifests(args.data_root)
    spec = DATASET_SPECS["shapes"]
    dataset = SegEvalDataset(spec, os.path.join(args.data_root, "pair_eval"))
    print(f"{len(dataset)} probe images, holdout={sorted(holdout)}")

    t0 = time.perf_counter()
    segmenter = build_segmenter(model, cfg, spec, template_set=args.template)
    std = eval_standard_bank(segmenter, dataset, pairs, holdout, spec)
    sync(device)
    t1 = time.perf_counter()
    composed = eval_composed_bank(model, cfg, dataset, pairs, holdout, spec,
                                  template_set=args.template)
    sync(device)
    print(f"holdout_study: standard bank {t1 - t0:.2f} s, composed bank "
          f"{time.perf_counter() - t1:.2f} s ({len(dataset)} images each, text bank "
          f"and decode included)")

    report = {"holdout_pairs": sorted(map(list, holdout)),
              "standard_bank": {k: {"mIoU": v["mIoU"], "mAcc": v["mAcc"],
                                    "per_class": v.get("per_class")}
                                for k, v in std.items()},
              "composed_bank": {k: {"mIoU": composed[k]["mIoU"],
                                    "mAcc": composed[k]["mAcc"]}
                                for k in ("held_out", "seen")},
              "composed_per_pair_iou": composed["per_pair_iou"]}
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    main()
