"""A copy of segclip_tpu/evalseg/miou.py, kept in the port so that the port
imports nothing of the JAX package (tests/test_torch_vendored.py holds the
copy equal to the original).

Confusion-matrix mIoU with mmseg-compatible conventions.

Equivalent of mmseg's dataset.evaluate(metric='mIoU') as invoked by the
reference (main_seg_zeroshot.py:156-161): per-class intersection/union
accumulated over all images, pixels labeled `ignore_index` (255) excluded,
mean over classes with nanmean (classes absent from GT and prediction are
excluded from the average).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class MIoUMeter:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.intersect = np.zeros(num_classes, np.float64)
        self.union = np.zeros(num_classes, np.float64)
        self.pred_area = np.zeros(num_classes, np.float64)
        self.label_area = np.zeros(num_classes, np.float64)

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred/label: int (H, W) maps at the same resolution."""
        assert pred.shape == label.shape, (pred.shape, label.shape)
        valid = label != self.ignore_index
        pred = pred[valid]
        label = label[valid]

        inter = pred[pred == label]
        self.intersect += np.bincount(inter, minlength=self.num_classes
                                      )[:self.num_classes]
        p_area = np.bincount(pred, minlength=self.num_classes
                             )[:self.num_classes]
        l_area = np.bincount(label, minlength=self.num_classes
                             )[:self.num_classes]
        self.pred_area += p_area
        self.label_area += l_area
        self.union += p_area + l_area
        self.union -= np.bincount(inter, minlength=self.num_classes
                                  )[:self.num_classes]

    def state(self) -> np.ndarray:
        """Accumulator snapshot (4, C) — summable across shards/hosts."""
        return np.stack([self.intersect, self.union, self.pred_area,
                         self.label_area])

    def set_state(self, state: np.ndarray) -> None:
        self.intersect, self.union, self.pred_area, self.label_area = \
            (np.asarray(row, np.float64) for row in state)

    def results(self, class_names: Sequence[str] = ()) -> Dict:
        with np.errstate(divide='ignore', invalid='ignore'):
            iou = self.intersect / self.union
            acc = self.intersect / self.label_area
        miou = float(np.nanmean(iou) * 100)
        macc = float(np.nanmean(acc) * 100)
        aacc = float(self.intersect.sum() / max(self.label_area.sum(), 1)
                     * 100)
        out = {"mIoU": miou, "mAcc": macc, "aAcc": aacc,
               "IoU": (iou * 100).tolist()}
        if class_names:
            out["per_class"] = {n: (None if np.isnan(v) else float(v * 100))
                                for n, v in zip(class_names, iou)}
        return out
