"""Zero-shot segmentation demo (segclip_tpu/cli/demo.py, the reference's
main_seg_vis.py).

Single image:
    python -m segclip_tpu_torch.cli.demo --input examples/voc.jpg \
        --init-model segclip.bin --vis input_pred_label --dataset voc

Dataset mode (the reference's dataset-keyword input, main_seg_vis.py:145-148
— first N val images, whole-image inference):
    python -m segclip_tpu_torch.cli.demo --dataset voc --data-root /data/VOC2012 \
        --first-n 10 --vis input_pred_label

Runs on the CUDA card (`--device cuda`, the default) and raises when there
is none; `--device cpu` runs on the CPU with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.cli.eval_zeroshot import build_segmenter
from segclip_tpu_torch.config import ModelConfig, apply_overrides
from segclip_tpu_torch.evalseg.datasets import (DATASET_SPECS, PIXEL_MEAN, PIXEL_STD,
                                                SegEvalDataset, keep_ratio_resize,
                                                normalize_pixels)
from segclip_tpu_torch.evalseg.visualize import save_visualization
from segclip_tpu_torch.models.segclip import check_kernel_fields
from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import get_logger

VIS_MODES = ("input", "pred", "input_pred", "input_pred_label",
             "all_groups", "first_group", "final_group")


def _run_one(segmenter, spec, norm, show, stem, vis_modes, mode, output_dir, logger):
    pred = segmenter.predict(norm, orig_shape=(show.shape[0], show.shape[1]), mode=mode)
    groups = [segmenter.group_map(norm)]
    for vis in vis_modes:
        out_file = os.path.join(output_dir, vis, f"{stem}.jpg")
        written = save_visualization(vis, out_file, show, pred, spec.palette,
                                     spec.classes, spec.with_bg, group_maps=groups)
        for path in written:
            logger.info("wrote %s", path)
    labels = sorted(int(l) for l in np.unique(pred))
    logger.info("%s predicted classes: %s", stem, [spec.classes[l] for l in labels])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", default=None, help="input image path")
    ap.add_argument("--data-root", default=None,
                    help="dataset root — visualize the first N val images "
                         "instead of --input")
    ap.add_argument("--first-n", type=int, default=10,
                    help="images to visualize in dataset mode")
    ap.add_argument("--init-model", default=None,
                    help="torch checkpoint: OpenAI ViT-B-16.pt, segclip.bin or a "
                         "model.pt; default: random init")
    ap.add_argument("--dataset", choices=sorted(DATASET_SPECS), default="voc",
                    help="class vocabulary to segment against")
    ap.add_argument("--vis", nargs="+", default=["input_pred"], choices=VIS_MODES)
    ap.add_argument("--mode", choices=["slide", "whole"], default=None,
                    help="default: slide for --input, whole for dataset "
                         "mode (main_seg_vis.py:145-148)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu; the CPU runs the "
                         "kernels' plain versions and is used only when named")
    ap.add_argument("--output-dir", default="output/vis_imgs")
    ap.add_argument("--opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    if (args.input is None) == (args.data_root is None):
        ap.error("give exactly one of --input or --data-root")

    logger = get_logger(args.output_dir)
    device = resolve_device(args.device)
    cfg = ModelConfig()
    for item in args.opts:
        cfg = apply_overrides(cfg, [item])

    check_kernel_fields(cfg, logger.info)
    model, cfg = load_model(args.init_model, cfg, device)
    spec = DATASET_SPECS[args.dataset]
    segmenter = build_segmenter(model, cfg, spec)

    if args.input:
        img = Image.open(args.input).convert("RGB")
        resized = keep_ratio_resize(img)
        norm = normalize_pixels(np.asarray(resized))
        show = np.asarray(resized)
        stem = os.path.splitext(os.path.basename(args.input))[0]
        _run_one(segmenter, spec, norm, show, stem, args.vis, args.mode or "slide",
                 args.output_dir, logger)
        return

    # dataset mode: first N val images, whole-image inference at the
    # RESIZED resolution (the reference visualizes the network input)
    dataset = SegEvalDataset(spec, args.data_root, limit=args.first_n)
    for sample in dataset:
        show = np.clip(sample.image * PIXEL_STD + PIXEL_MEAN, 0, 255).astype(np.uint8)
        _run_one(segmenter, spec, sample.image, show, sample.name, args.vis,
                 args.mode or "whole", args.output_dir, logger)


if __name__ == "__main__":
    main()
