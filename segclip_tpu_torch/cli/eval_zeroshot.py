"""Zero-shot segmentation mIoU evaluation on one device
(segclip_tpu/cli/eval_zeroshot.py).

    python -m segclip_tpu_torch.cli.eval_zeroshot --dataset voc \
        --data-root /data/VOC2012 --init-model segclip.bin

Runs on the first CUDA card when there is one, else on the CPU (with the
kernels' plain versions). Prints one JSON line with the results last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from segclip_tpu.config import ModelConfig, apply_overrides
from segclip_tpu.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter, evaluate_dataset
from segclip_tpu_torch.evalseg.text_bank import build_text_bank
from segclip_tpu_torch.utils.device import resolve_device


def build_segmenter(model, cfg: ModelConfig, spec, template_set: str = "simple",
                    bg_thresh: float | None = None) -> ZeroShotSegmenter:
    classnames = spec.classes[1:] if spec.with_bg else spec.classes
    bank = build_text_bank(model, classnames, template_set,
                           context_length=cfg.context_length)
    return ZeroShotSegmenter(
        model, bank, with_bg=spec.with_bg,
        bg_thresh=spec.bg_thresh if bg_thresh is None else bg_thresh,
        patch_size=cfg.vision_patch_size)


def _logger(output_dir: str) -> logging.Logger:
    logger = logging.getLogger("segclip_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in list(logger.handlers):                 # one run's handlers at a time
        logger.removeHandler(h)
        h.close()
    os.makedirs(output_dir, exist_ok=True)
    for h in (logging.StreamHandler(sys.stderr),
              logging.FileHandler(os.path.join(output_dir, "log.txt"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=sorted(DATASET_SPECS), default="voc")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--init-model", default=None,
                    help="reference-layout torch state dict (.bin/.pt); "
                         "default: random init")
    ap.add_argument("--template", default="simple",
                    choices=["simple", "subset", "full", "identity"])
    ap.add_argument("--bg-thresh", type=float, default=None,
                    help="override the per-dataset background threshold")
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N images")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="encode dtype; default keeps the model config's "
                         "(bfloat16). float32 is the reference's eval "
                         "precision")
    ap.add_argument("--output-dir", default="output/eval")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="model config overrides key=value")
    args = ap.parse_args(argv)

    logger = _logger(args.output_dir)
    device = resolve_device()
    cfg = ModelConfig()
    for item in args.opts:
        cfg = apply_overrides(cfg, [item])
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)

    model, cfg = load_model(args.init_model, cfg, device)
    spec = DATASET_SPECS[args.dataset]
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump({"model": dataclasses.asdict(cfg), "dataset": args.dataset,
                   "template": args.template, "bg_thresh": args.bg_thresh,
                   "device": str(device)}, f, indent=2)
    logger.info("device=%s dataset=%s classes=%d bg_thresh=%.2f", device,
                spec.name, len(spec.classes),
                spec.bg_thresh if args.bg_thresh is None else args.bg_thresh)

    dataset = SegEvalDataset(spec, args.data_root, limit=args.limit)
    logger.info("evaluating %d images", len(dataset))
    segmenter = build_segmenter(model, cfg, spec, template_set=args.template,
                                bg_thresh=args.bg_thresh)
    results = evaluate_dataset(segmenter, dataset, logger=logger)
    logger.info("mIoU=%.2f mAcc=%.2f aAcc=%.2f", results["mIoU"],
                results["mAcc"], results["aAcc"])
    per_class = results.get("per_class", {})
    for name, iou in per_class.items():
        logger.info("  IoU %-16s %s", name, "n/a" if iou is None else f"{iou:.2f}")
    print(json.dumps({"dataset": spec.name, "mIoU": results["mIoU"],
                      "mAcc": results["mAcc"], "aAcc": results["aAcc"],
                      "per_class": {k: (None if v is None else round(v, 2))
                                    for k, v in per_class.items()}}))
    return results


if __name__ == "__main__":
    main()
