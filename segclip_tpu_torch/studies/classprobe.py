"""Image-level grounding probe: does the POOLED feature know each class?
(scripts/classprobe.py)

Per shape class, the ROC-AUC of sim(text "a photo of a {shape}.", pooled
image feature) against the class's presence in the image (eval-split
masks), with no training. AUC ≈ 0.5 for every class but the segmentation
winner says the contrastive optimum itself grounds one class; a high AUC
for several says the pooled features ground them and the spatial pathway
picks one.

    python -m segclip_tpu_torch.studies.classprobe --ckpt run/ckpt_best/model.pt \
        --data-root shapes_corpus [--out runQ_classprobe.json] [--device cpu]

The AUC ranks with midranks (a tie counts one half), where the JAX script
ranks ties in argsort order: the two agree unless scores tie.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from segclip_tpu_torch.data.procgen import SHAPE_CLASSES
from segclip_tpu_torch.evalseg.datasets import DATASET_SPECS, SegEvalDataset
from segclip_tpu_torch.evalseg.text_bank import build_text_bank
from segclip_tpu_torch.studies.common import (add_device_arg, load_study_model, sync,
                                              write_report)


def midranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of `x`, each group of equal values at the mean of the
    ranks it spans."""
    order = np.argsort(x, kind="stable")
    _, first, counts = np.unique(x[order], return_index=True, return_counts=True)
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    return ranks


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC as the Mann-Whitney U over n₊·n₋, on midranks."""
    pos, neg = scores[labels], scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    ranks = midranks(np.concatenate([pos, neg]))
    u = ranks[:len(pos)].sum() - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))


def center_crop(arr: np.ndarray, res: int) -> np.ndarray:
    """The centre res × res of a normalised image, zero-padded where a side
    is shorter."""
    h, w = arr.shape[:2]
    top, left = max((h - res) // 2, 0), max((w - res) // 2, 0)
    arr = arr[top:top + res, left:left + res]
    if arr.shape[:2] != (res, res):
        pad = np.zeros((res, res, 3), np.float32)
        pad[:arr.shape[0], :arr.shape[1]] = arr
        arr = pad
    return arr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-root", required=True,
                    help="corpus dir with an eval/ VOC-layout split")
    ap.add_argument("--template", default="simple")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--opts", nargs="*", default=[])
    add_device_arg(ap)
    args = ap.parse_args(argv)

    model, cfg, device = load_study_model(args.ckpt, args.device, args.opts)
    spec = DATASET_SPECS["shapes"]
    dataset = SegEvalDataset(spec, os.path.join(args.data_root, "eval"))
    t0 = time.perf_counter()
    bank = build_text_bank(model, list(SHAPE_CLASSES), args.template,
                           context_length=cfg.context_length)
    res = cfg.image_resolution

    sims, present, buf_img, buf_lbl = [], [], [], []

    @torch.inference_mode()
    def flush():
        if not buf_img:
            return
        x = torch.from_numpy(np.stack(buf_img)).to(device)
        v = model.clip.encode_image(x, training=False).pooled.float()
        v = v / v.norm(dim=-1, keepdim=True)
        sims.append((v @ bank.T).cpu().numpy())              # (b, 6)
        present.extend(buf_lbl)
        buf_img.clear()
        buf_lbl.clear()

    for s in dataset:
        # SegEvalSample.image is CLIP-normalised float32 with short side 224
        buf_img.append(center_crop(s.image, res))
        ids = set(np.unique(s.label).tolist())
        buf_lbl.append([(k + 1) in ids for k in range(len(SHAPE_CLASSES))])
        if len(buf_img) == args.batch:
            flush()
    flush()
    sync(device)
    sims = np.concatenate(sims)                              # (N, 6)
    present = np.asarray(present)                            # (N, 6) bool
    print(f"classprobe: {sims.shape[0]} images in batches of {args.batch}, "
          f"{time.perf_counter() - t0:.2f} s (text bank, decode and encode)")
    report = {"ckpt": args.ckpt, "n_images": int(sims.shape[0]), "per_class": {}}
    for k, name in enumerate(SHAPE_CLASSES):
        sc, lb = sims[:, k], present[:, k]
        report["per_class"][name] = {
            "auc": round(auc(sc, lb), 4),
            "n_present": int(lb.sum()),
            "mean_sim_present": round(float(sc[lb].mean()), 4),
            "mean_sim_absent": round(float(sc[~lb].mean()), 4),
        }
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    main()
