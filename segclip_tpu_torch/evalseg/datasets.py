"""A copy of segclip_tpu/evalseg/datasets.py, kept in the port so that the port
imports nothing of the JAX package (tests/test_torch_vendored.py holds the
copy equal to the original).

Zero-shot segmentation eval datasets: class lists, palettes, file-system
loading, and per-dataset eval protocol (bg_thresh, dirs, label conventions).

Class lists are public dataset metadata matching the reference
(seg_segmentation/datasets/{pascal_voc,pascal_context,coco_object}.py); the
eval protocol (slide 224/224, per-dataset bg_thresh) comes from
seg_segmentation/configs/_base_/datasets/*.py.

Replaces mmseg dataset classes: images are loaded with PIL, keep-ratio
resized so short side = 224 (long side capped at 2048 — mmseg
MultiScaleFlipAug(img_scale=(2048, 224)) semantics), normalized with CLIP
statistics (the reference's pixel-space mean/std are exactly CLIP's ×255).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

# Normalization: CLIP stats in 0-255 pixel space
# (configs/_base_/datasets/pascal_voc12.py:19).
PIXEL_MEAN = np.array([122.7709383, 116.7460125, 104.09373615], np.float32)
PIXEL_STD = np.array([68.5005327, 66.6321579, 70.32316305], np.float32)

VOC_CLASSES = (
    'background', 'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
    'car', 'cat', 'chair', 'cow', 'table', 'dog', 'horse', 'motorbike',
    'person', 'plant', 'sheep', 'sofa', 'train', 'monitor')

CONTEXT_CLASSES = (
    'background', 'airplane', 'bag', 'bed', 'bedclothes', 'bench', 'bicycle',
    'bird', 'boat', 'book', 'bottle', 'building', 'bus', 'cabinet', 'car',
    'cat', 'ceiling', 'chair', 'cloth', 'computer', 'cow', 'cup', 'curtain',
    'dog', 'door', 'fence', 'floor', 'flower', 'food', 'grass', 'ground',
    'horse', 'keyboard', 'light', 'motorbike', 'mountain', 'mouse', 'person',
    'plate', 'platform', 'plant', 'road', 'rock', 'sheep', 'shelves',
    'sidewalk', 'sign', 'sky', 'snow', 'sofa', 'table', 'track', 'train',
    'tree', 'truck', 'monitor', 'wall', 'water', 'window', 'wood')

COCO_OBJECT_CLASSES = (
    'background', 'person', 'bicycle', 'car', 'motorcycle', 'airplane',
    'bus', 'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
    'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'backpack',
    'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop',
    'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
    'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase', 'scissors',
    'teddy bear', 'hair drier', 'toothbrush')


def voc_colormap(n: int) -> np.ndarray:
    """Standard VOC bit-interleaved palette generator, (n, 3) uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


@dataclass(frozen=True)
class SegDatasetSpec:
    name: str
    classes: Tuple[str, ...]
    bg_thresh: float
    img_dir: str
    ann_dir: str
    split: Optional[str]             # split txt (relative) or None = glob
    img_suffix: str = '.jpg'
    seg_suffix: str = '.png'
    ignore_index: int = 255

    @property
    def with_bg(self) -> bool:
        return self.classes[0] == 'background'

    @property
    def palette(self) -> np.ndarray:
        return voc_colormap(len(self.classes))


#: Procedural captioned-shapes corpus (data/procgen.py) — the from-scratch
#: learnability proof. VOC directory layout; class ids are written raw into
#: the PNG so the unchanged loader reads them directly.
SHAPES_CLASSES = ('background', 'circle', 'square', 'triangle', 'star',
                  'cross', 'heart')

DATASET_SPECS = {
    'voc': SegDatasetSpec(
        name='voc', classes=VOC_CLASSES, bg_thresh=0.80,
        img_dir='JPEGImages', ann_dir='SegmentationClass',
        split='ImageSets/Segmentation/val.txt'),
    'shapes': SegDatasetSpec(
        name='shapes', classes=SHAPES_CLASSES, bg_thresh=0.50,
        img_dir='JPEGImages', ann_dir='SegmentationClass',
        split='ImageSets/Segmentation/val.txt'),
    'context': SegDatasetSpec(
        name='context', classes=CONTEXT_CLASSES, bg_thresh=0.25,
        img_dir='JPEGImages', ann_dir='SegmentationClassContext',
        split='ImageSets/SegmentationContext/val.txt'),
    'coco': SegDatasetSpec(
        name='coco', classes=COCO_OBJECT_CLASSES, bg_thresh=0.65,
        img_dir='images/val2017', ann_dir='annotations/val2017',
        split=None, seg_suffix='_instanceTrainIds.png'),
}


def keep_ratio_resize(img: Image.Image, short: int = 224,
                      long_cap: int = 2048) -> Image.Image:
    """mmseg Resize(img_scale=(2048, 224), keep_ratio=True): scale so the
    short side is `short`, capping the long side at `long_cap`; size
    rounding is mmcv's int(x·scale + 0.5).

    Resampling uses cv2 INTER_LINEAR — the exact mmcv imrescale kernel the
    reference evaluates with (mmseg loading pipeline); PIL BILINEAR differs
    at the pixel level (mIoU targets are quoted to ±0.2). PIL is the
    fallback when cv2 is unavailable."""
    w, h = img.size
    scale = min(short / min(w, h), long_cap / max(w, h))
    new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
    try:
        import cv2
        arr = cv2.resize(np.asarray(img), (new_w, new_h),
                         interpolation=cv2.INTER_LINEAR)
        return Image.fromarray(arr)
    except ImportError:
        return img.resize((new_w, new_h), Image.BILINEAR)


def normalize_pixels(arr: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) → normalized float32."""
    return (arr.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD


@dataclass
class SegEvalSample:
    image: np.ndarray            # normalized float32 (H, W, 3), short side 224
    label: Optional[np.ndarray]  # int32 (H0, W0) original-resolution GT
    orig_shape: Tuple[int, int]  # (H0, W0)
    name: str


class SegEvalDataset:
    """Iterates (image, label) pairs from a standard dataset layout."""

    def __init__(self, spec: SegDatasetSpec, data_root: str,
                 limit: Optional[int] = None):
        self.spec = spec
        self.root = data_root
        self.items = self._list_items()
        if limit:
            self.items = self.items[:limit]

    def _list_items(self) -> List[str]:
        if self.spec.split is not None:
            path = os.path.join(self.root, self.spec.split)
            with open(path) as f:
                return [ln.strip() for ln in f if ln.strip()]
        img_dir = os.path.join(self.root, self.spec.img_dir)
        return sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir)
                      if f.endswith(self.spec.img_suffix))

    def __len__(self) -> int:
        return len(self.items)

    def load(self, idx: int) -> SegEvalSample:
        name = self.items[idx]
        img_path = os.path.join(self.root, self.spec.img_dir,
                                name + self.spec.img_suffix)
        img = Image.open(img_path).convert('RGB')
        orig = (img.size[1], img.size[0])
        resized = keep_ratio_resize(img)
        arr = normalize_pixels(np.asarray(resized))

        label = None
        ann_path = os.path.join(self.root, self.spec.ann_dir,
                                name + self.spec.seg_suffix)
        if os.path.exists(ann_path):
            label = np.asarray(Image.open(ann_path)).astype(np.int32)
        return SegEvalSample(image=arr, label=label, orig_shape=orig,
                             name=name)

    def __iter__(self) -> Iterator[SegEvalSample]:
        for i in range(len(self)):
            yield self.load(i)
