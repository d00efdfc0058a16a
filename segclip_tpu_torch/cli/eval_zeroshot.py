"""Zero-shot segmentation mIoU evaluation (segclip_tpu/cli/eval_zeroshot.py).

    python -m segclip_tpu_torch.cli.eval_zeroshot --dataset voc \
        --data-root /data/VOC2012 --init-model segclip.bin

Several images per decode call (`--images-per-device`) and several
processes (`--dist-*`, each on its strided share of the dataset, the
metrics summed across them) go through the sharded evaluator.

Runs on the CUDA card (`--device cuda`, the default) and raises when there
is none; `--device cpu` runs on the CPU with the kernels' plain versions.
Prints one JSON line with the results last (on every rank).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from segclip_tpu_torch.config import ModelConfig, apply_overrides
from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.evalseg.inference import (ZeroShotSegmenter, evaluate_dataset,
                                                 evaluate_dataset_sharded)
from segclip_tpu_torch.evalseg.text_bank import build_text_bank
from segclip_tpu_torch.models.segclip import check_kernel_fields
from segclip_tpu_torch.parallel import dist
from segclip_tpu_torch.utils.logging import get_logger


def build_segmenter(model, cfg: ModelConfig, spec, template_set: str = "simple",
                    bg_thresh: float | None = None) -> ZeroShotSegmenter:
    classnames = spec.classes[1:] if spec.with_bg else spec.classes
    bank = build_text_bank(model, classnames, template_set,
                           context_length=cfg.context_length)
    return ZeroShotSegmenter(
        model, bank, with_bg=spec.with_bg,
        bg_thresh=spec.bg_thresh if bg_thresh is None else bg_thresh,
        patch_size=cfg.vision_patch_size)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=sorted(DATASET_SPECS), default="voc")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--init-model", default=None,
                    help="reference-layout torch state dict (.bin/.pt) or an "
                         "Orbax directory; default: random init")
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
    ap.add_argument("--sharded", choices=["auto", "on", "off"], default="auto",
                    help="the sharded evaluator (auto: when there is more than "
                         "one process or more than one image per device)")
    ap.add_argument("--images-per-device", type=int, default=1,
                    help=">1 decodes the windows of several images in one call; "
                         "at bfloat16 a larger batch may flip near-tie pixels "
                         "(PERF.md), at float32 with TF32 off it does not")
    ap.add_argument("--matmul-precision", default="highest",
                    choices=["highest", "high"],
                    help="float32 matrix products on the card: highest (full "
                         "float32, TF32 off: the default) or high (TF32). The "
                         "JAX package's TPU default is bf16 passes; the port "
                         "keeps float32 exact so that a float32 eval does not "
                         "depend on the batching (README)")
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous of a multi-process eval (see cli.train)")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu; the CPU runs the "
                         "kernels' plain versions and is used only when named")
    ap.add_argument("--output-dir", default="output/eval")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="model config overrides key=value")
    args = ap.parse_args(argv)
    if args.sharded == "off" and args.images_per_device > 1:
        raise SystemExit("--images-per-device > 1 requires the sharded eval path; "
                         "drop --sharded off (or use --images-per-device 1)")

    device = dist.init_distributed(args.device, args.dist_coordinator,
                                   args.dist_num_processes, args.dist_process_id)
    try:
        return _evaluate(args, device)
    finally:
        dist.shutdown()


def _evaluate(args, device):
    lead = dist.rank() == 0
    logger = get_logger(args.output_dir if lead else None)
    if args.matmul_precision == "high":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    cfg = ModelConfig()
    for item in args.opts:
        cfg = apply_overrides(cfg, [item])
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)

    check_kernel_fields(cfg, logger.info)
    model, cfg = load_model(args.init_model, cfg, device)
    spec = DATASET_SPECS[args.dataset]
    world = dist.world_size()
    if lead:
        with open(os.path.join(args.output_dir, "config.json"), "w") as f:
            json.dump({"model": dataclasses.asdict(cfg), "dataset": args.dataset,
                       "template": args.template, "bg_thresh": args.bg_thresh,
                       "device": str(device), "world_size": world,
                       "images_per_device": args.images_per_device,
                       "sharded": args.sharded,
                       "matmul_precision": args.matmul_precision}, f, indent=2)
    logger.info("device=%s dataset=%s classes=%d bg_thresh=%.2f", device,
                spec.name, len(spec.classes),
                spec.bg_thresh if args.bg_thresh is None else args.bg_thresh)

    dataset = SegEvalDataset(spec, args.data_root, limit=args.limit)
    logger.info("evaluating %d images", len(dataset))
    segmenter = build_segmenter(model, cfg, spec, template_set=args.template,
                                bg_thresh=args.bg_thresh)
    sharded = args.sharded == "on" or args.images_per_device > 1 or (
        args.sharded == "auto" and world > 1)
    if sharded:
        results = evaluate_dataset_sharded(segmenter, dataset, logger=logger,
                                           images_per_device=args.images_per_device)
    else:                       # --sharded off: each rank evaluates every image
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
