"""Procedural captioned-shapes corpus: the framework's learnability proof
(a copy of segclip_tpu/data/procgen.py; tests/test_torch_data.py holds the
shards it writes byte-identical to the original's).

The reference's de-facto integration test is zero-shot VOC mIoU evaluated
during/after pretraining (main_seg_zeroshot.py:121-167, called per-epoch
from training at main_task_align.py:367-369).  That requires real CC3M/COCO
data plus a pretrained CLIP init — neither exists in this environment (no
network egress).  This module generates a corpus with the same *structure*
that is learnable FROM SCRATCH:

  - composite scenes: 1-3 colored geometric shapes (circle, square,
    triangle, star, cross, heart) on smooth gradient backgrounds;
  - captions naming each shape with its color ("a photo of a red circle
    and a blue star.") — the contrastive task is to align shape/color
    words with image regions;
  - exact ground-truth segmentation masks (class = shape type) written in
    the VOC directory layout, so the UNCHANGED zero-shot eval harness
    (evalseg/) measures mIoU against them with a class-name text bank.

Colors and shapes are sampled independently, so class-name grounding cannot
shortcut through color statistics.  Train-side superpixels come from the
real Felzenszwalb path (data/superpixel.py) — the full production pipeline
(pack → superpixels → BatchLoader → 4-loss step → per-epoch zero-shot eval)
runs end-to-end on this corpus; pretraining must drive mIoU far above both
the random-init value and chance for the system to be certified learning.
"""
from __future__ import annotations

import io
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

# class 0 is background (the eval spec's with_bg convention)
SHAPE_CLASSES = ("circle", "square", "triangle", "star", "cross", "heart")

COLORS = {
    "red": (200, 40, 40),
    "green": (50, 160, 60),
    "blue": (50, 80, 200),
    "yellow": (220, 200, 40),
    "purple": (140, 60, 170),
    "orange": (230, 130, 30),
    "cyan": (60, 190, 200),
    "pink": (235, 140, 180),
}

# Backgrounds stay muted/desaturated so shape colors pop but never match.
_BG_COLORS = [(120, 120, 120), (160, 150, 140), (90, 100, 110),
              (170, 170, 160), (130, 140, 120), (100, 90, 100),
              (200, 195, 185), (70, 75, 80)]

CAPTION_TEMPLATES = (
    "a photo of {}.",
    "an image of {}.",
    "{} on a plain background.",
    "a picture showing {}.",
)

# Default held-out color×shape compositions for the OPEN-vocabulary proof
# (the capability the reference claims: class names chosen at EVAL time,
# reference README.md:3-5 — the text bank is built from arbitrary names at
# seg_segmentation/evaluation/builder.py:46-79).  With --holdout these
# pairs appear in NO training image or caption; zero-shot eval then asks
# whether grounding TRANSFERS to them — from scratch, held-out *words* are
# untestable (no pretrained language prior), but held-out *compositions*
# of seen words are.
#
# ONE pair PER shape class (VERDICT r4 #2): the round-4 trio covered only
# 3 of 6 shapes, so whenever the grounded class fell outside it the
# compositional probe was structurally vacuous (run E: star grounded,
# zero held-out star pairs → no signal).  With one held-out pair per
# shape the probe has signal no matter WHICH class grounds.  The old trio
# is kept as a subset so the round-4 green-square transfer point (36.0
# composed IoU, docs/PERF.md) stays directly comparable.
HOLDOUT_PAIRS_DEFAULT = (("red", "triangle"), ("blue", "heart"),
                         ("green", "square"), ("yellow", "circle"),
                         ("purple", "star"), ("orange", "cross"))


def _equal_area_multipliers() -> dict:
    """Per-shape circumradius multipliers that equalize expected pixel AREA
    across classes (target: the circle's πr²).

    Why this exists (measured, docs/PERF.md "per-class grounding"): at a
    shared circumradius the shapes differ >3× in area (square 4r², circle
    πr², heart 1.94r², cross 2.46r², star 1.32r², triangle 1.30r²), and
    from-scratch grounding follows that area ordering — the biggest class
    gets the most patches, superpixel support, and gradient signal, so it
    grounds first while the small thin shapes stay at 0 IoU.  `equal_area`
    corpora remove that confound.  Default OFF: the original corpus and
    every result measured on it stay reproducible."""
    global _EQUAL_AREA_MULT
    if _EQUAL_AREA_MULT is None:
        mult = {"circle": 1.0}
        for kind in SHAPE_CLASSES:
            if kind == "circle":
                continue
            pts = _shape_polygon(kind, 0.0, 0.0, 1.0, 0.0)
            area = abs(sum(x1 * y2 - x2 * y1
                           for (x1, y1), (x2, y2)
                           in zip(pts, pts[1:] + pts[:1]))) / 2.0
            mult[kind] = math.sqrt(math.pi / area)
        _EQUAL_AREA_MULT = mult
    return _EQUAL_AREA_MULT


_EQUAL_AREA_MULT: Optional[dict] = None


def _shape_polygon(kind: str, cx: float, cy: float, r: float,
                   angle: float) -> List[Tuple[float, float]]:
    """Vertex list for the polygon shapes, rotated by `angle`."""
    def rot(pts):
        ca, sa = math.cos(angle), math.sin(angle)
        return [(cx + x * ca - y * sa, cy + x * sa + y * ca) for x, y in pts]

    if kind == "square":
        return rot([(-r, -r), (r, -r), (r, r), (-r, r)])
    if kind == "triangle":
        return rot([(r * math.cos(a), r * math.sin(a))
                    for a in (math.radians(90), math.radians(210),
                              math.radians(330))])
    if kind == "star":
        pts = []
        for i in range(10):
            rr = r if i % 2 == 0 else 0.45 * r
            a = math.pi / 2 + i * math.pi / 5
            pts.append((rr * math.cos(a), rr * math.sin(a)))
        return rot(pts)
    if kind == "cross":
        t = 0.38 * r
        return rot([(-t, -r), (t, -r), (t, -t), (r, -t), (r, t), (t, t),
                    (t, r), (-t, r), (-t, t), (-r, t), (-r, -t), (-t, -t)])
    if kind == "heart":
        # parametric heart, scaled to radius r
        pts = []
        for i in range(40):
            t = 2 * math.pi * i / 40
            x = 16 * math.sin(t) ** 3
            y = -(13 * math.cos(t) - 5 * math.cos(2 * t)
                  - 2 * math.cos(3 * t) - math.cos(4 * t))
            pts.append((x * r / 17.0, y * r / 17.0))
        return rot(pts)
    raise KeyError(kind)


def _draw_shape(draw: ImageDraw.ImageDraw, mask: ImageDraw.ImageDraw,
                kind: str, cx: float, cy: float, r: float, angle: float,
                color: Tuple[int, int, int], class_id: int) -> None:
    if kind == "circle":
        box = (cx - r, cy - r, cx + r, cy + r)
        draw.ellipse(box, fill=color)
        mask.ellipse(box, fill=class_id)
    else:
        poly = _shape_polygon(kind, cx, cy, r, angle)
        draw.polygon(poly, fill=color)
        mask.polygon(poly, fill=class_id)


def _background(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """Two-color gradient + low-frequency noise, uint8 (h, w, 3)."""
    c0 = np.array(_BG_COLORS[rng.integers(len(_BG_COLORS))], np.float32)
    c1 = np.array(_BG_COLORS[rng.integers(len(_BG_COLORS))], np.float32)
    if rng.random() < 0.5:
        t = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    else:
        t = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    grad = c0 * (1 - t) + c1 * t
    small = rng.normal(0, 12, (6, 6, 3)).astype(np.float32)
    noise = np.asarray(Image.fromarray(
        np.clip(small + 128, 0, 255).astype(np.uint8)
    ).resize((w, h), Image.BICUBIC), np.float32) - 128.0
    return np.clip(grad + noise, 0, 255).astype(np.uint8)


def _scene_with_captions(
    rng: np.random.Generator, size: Tuple[int, int] = (224, 224),
    max_shapes: int = 3,
    holdout_pairs: Optional[frozenset] = None,
    equal_area: bool = False,
) -> Tuple[np.ndarray, np.ndarray, str, str, List[Tuple[str, str]]]:
    """One composite scene → (image, mask, caption_color, caption_plain,
    mentions) where mentions = [(color_name, shape_kind), ...] for each
    placed shape, in draw order (consumed by the "mention" caption mode).

    Mask values: 0 background, 1 + SHAPE_CLASSES.index(kind) per shape.
    Both caption styles describe the same scene from the same rng stream:
      color: "a photo of a red circle and a blue star."
      plain: "a photo of a circle and a star."
    Why both exist (measured on-chip, docs/PERF.md): with only color
    captions, InfoNCE at modest batch sizes is largely solvable from color
    statistics (colors are near-unique per batch) so shape names never
    ground and zero-shot shape mIoU stays at chance even while grouping
    becomes clean; with only plain captions the task has heavy duplicate
    false-negatives (few distinct captions) and learns slowly. Packing
    BOTH as two samples per image (the COCO multi-caption pattern) gives
    rich features AND class-name grounding.
    """
    w, h = size
    img = Image.fromarray(_background(rng, w, h))
    mask = Image.new("L", (w, h), 0)
    draw, mdraw = ImageDraw.Draw(img), ImageDraw.Draw(mask)

    n = int(rng.integers(1, max_shapes + 1))
    placed: List[Tuple[float, float, float]] = []
    parts: List[str] = []
    plain_parts: List[str] = []
    mentions: List[Tuple[str, str]] = []
    for _ in range(n):
        kind = SHAPE_CLASSES[rng.integers(len(SHAPE_CLASSES))]
        color_name = list(COLORS)[rng.integers(len(COLORS))]
        # Held-out compositions are excluded from the IMAGE as well as the
        # caption: resample the color (shape marginals stay uniform) until
        # the pair is allowed. With ≤3 of 8 colors held out per shape this
        # terminates fast; the guard below keeps it total regardless.
        if holdout_pairs:
            for _retry in range(64):
                if (color_name, kind) not in holdout_pairs:
                    break
                color_name = list(COLORS)[rng.integers(len(COLORS))]
            else:
                raise ValueError(
                    f"holdout excludes every color for shape {kind!r}")
        base = np.array(COLORS[color_name], np.int32)
        jitter = rng.integers(-18, 19, size=3)
        color = tuple(int(c) for c in np.clip(base + jitter, 0, 255))

        mult = (_equal_area_multipliers()[kind] if equal_area else 1.0)
        r_min, r_max = 0.12 * min(w, h), 0.24 * min(w, h)
        for _attempt in range(12):
            # The multiplier scales the sampled circumradius (same rng
            # draw sequence as the default corpus, so a seed generates the
            # "same" scenes with area-equalized shapes).
            r = float(rng.uniform(r_min, r_max)) * mult
            cx = float(rng.uniform(r + 2, w - r - 2))
            cy = float(rng.uniform(r + 2, h - r - 2))
            if all((cx - px) ** 2 + (cy - py) ** 2 > (r + pr) ** 2
                   for px, py, pr in placed):
                break
        else:
            continue                      # couldn't place without overlap
        placed.append((cx, cy, r))
        angle = float(rng.uniform(0, 2 * math.pi))
        _draw_shape(draw, mdraw, kind, cx, cy, r, angle, color,
                    1 + SHAPE_CLASSES.index(kind))
        parts.append(f"a {color_name} {kind}")
        plain_parts.append(f"a {kind}")
        mentions.append((color_name, kind))

    if not parts:                         # degenerate: empty scene
        return _scene_with_captions(rng, size, max_shapes, holdout_pairs,
                                    equal_area)

    def join(ps):
        return ps[0] if len(ps) == 1 else (
            ", ".join(ps[:-1]) + " and " + ps[-1])

    template = CAPTION_TEMPLATES[rng.integers(len(CAPTION_TEMPLATES))]
    return (np.asarray(img), np.asarray(mask, np.int32),
            template.format(join(parts)),
            template.format(join(plain_parts)),
            mentions)


def generate_scene(
    rng: np.random.Generator, size: Tuple[int, int] = (224, 224),
    max_shapes: int = 3, color_words: bool = True,
    equal_area: bool = False,
) -> Tuple[np.ndarray, np.ndarray, str]:
    """One scene → (image, mask, caption); see _scene_with_captions."""
    img, mask, cap_color, cap_plain, _ = _scene_with_captions(
        rng, size, max_shapes, equal_area=equal_area)
    return img, mask, cap_color if color_words else cap_plain


def write_train_corpus(out_dir: str, n_images: int, name: str = "shapes",
                       seed: int = 0, quality: int = 90,
                       min_side: int = 224, max_side: int = 288,
                       log_every: int = 2000,
                       superpixels: bool = True,
                       captions: str = "both",
                       holdout_pairs=None,
                       equal_area: bool = False) -> str:
    """Pack a training corpus: <name>_{images,captions,seg,meta}.sgr.

    captions: "color" | "plain" | "both" | "mention" | "mention-only" —
    caption styles
    written per image ("both" packs two samples per image, the COCO
    multi-caption pattern; see _scene_with_captions for why it matters).
    "mention" is the richer-negative variant: [color-full caption, a
    caption naming exactly ONE uniformly-chosen shape from the scene —
    with its color half the time ("a photo of a red circle.") else plain
    ("a photo of a circle.")]. Rationale (docs/PERF.md, run E): with
    full-scene captions InfoNCE concentrates gradient on a single
    sufficient class and the other shape names never ground; a
    single-shape mention makes the NAMED class's visual feature necessary
    for that sample, and uniform mention sampling spreads that necessity
    evenly over classes. Mention draws come from a SEPARATE rng stream,
    so the image/seg shards are byte-identical across all four modes
    (same scene rng stream).

    holdout_pairs: iterable of (color, shape) pairs to EXCLUDE from every
    training image and caption (the open-vocabulary compositional-
    generalization split — see HOLDOUT_PAIRS_DEFAULT). A `holdout.json`
    manifest is written next to the shards so eval tooling knows the
    split.

    Superpixels come from the REAL Felzenszwalb path (scale=224 sigma=0.9
    min_size=224 — the reference's extraction settings), not from the GT
    masks: training consumes exactly what production preprocessing
    produces.
    """
    from segclip_tpu_torch.data.records import SgrWriter
    from segclip_tpu_torch.data.superpixel import encode_seg_map, felzenszwalb
    from segclip_tpu_torch.utils.logging import get_logger
    logger = get_logger()
    os.makedirs(out_dir, exist_ok=True)
    holdout = frozenset(tuple(p) for p in holdout_pairs) \
        if holdout_pairs else None
    if holdout:
        with open(os.path.join(out_dir, "holdout.json"), "w") as f:
            json.dump({"holdout_pairs": sorted(holdout)}, f, indent=2)
    with open(os.path.join(out_dir, "corpus.json"), "w") as f:
        json.dump({"n_images": n_images, "seed": seed, "captions": captions,
                   "equal_area": equal_area,
                   "holdout_pairs": sorted(holdout) if holdout else None},
                  f, indent=2)
    rng = np.random.default_rng(seed)
    # Mention-mode draws come from their own stream so enabling the mode
    # cannot shift the scene stream (image/seg shards stay byte-identical
    # across caption modes at a given seed).
    mrng = np.random.default_rng((seed, 0x6D656E74))  # "ment"
    wi = SgrWriter(os.path.join(out_dir, f"{name}_images.sgr"))
    wc = SgrWriter(os.path.join(out_dir, f"{name}_captions.sgr"))
    ws = SgrWriter(os.path.join(out_dir, f"{name}_seg.sgr")) \
        if superpixels else None
    # Class-metadata sidecar consumed by model.infonce_mask (docs/PERF.md
    # "Run N" diagnosis): per image {"cls": per-caption named class
    # (0 = unstructured full-scene caption, 1+shape_idx = mention),
    # "scene": bitmask of shape classes present}. A separate shard keeps
    # the captions shard format (JSON list[str]) unchanged for existing
    # corpora and readers.
    wm = SgrWriter(os.path.join(out_dir, f"{name}_meta.sgr"))
    for i in range(n_images):
        w = int(rng.integers(min_side, max_side + 1))
        h = int(rng.integers(min_side, max_side + 1))
        img, _, cap_color, cap_plain, mentions = _scene_with_captions(
            rng, (w, h), holdout_pairs=holdout, equal_area=equal_area)
        scene_mask = 0
        for _, k_ in mentions:
            scene_mask |= 1 << SHAPE_CLASSES.index(k_)
        if captions == "mention":
            color_name, kind = mentions[mrng.integers(len(mentions))]
            part = (f"a {color_name} {kind}" if mrng.random() < 0.5
                    else f"a {kind}")
            tmpl = CAPTION_TEMPLATES[mrng.integers(len(CAPTION_TEMPLATES))]
            caps = [cap_color, tmpl.format(part)]
            cls = [0, 1 + SHAPE_CLASSES.index(kind)]
        elif captions == "mention-only":
            # Two single-shape mentions per scene, DISTINCT shape classes
            # when the scene has ≥2 (run-Q isolation lever, docs/PERF.md
            # "Run Q": removes the full-scene rows whose winner-take-all
            # InfoNCE dynamics persist under the class mask in run P).
            # Same draw grammar as "mention"; still its own rng stream.
            kinds = [k_ for _, k_ in mentions]
            first = int(mrng.integers(len(mentions)))
            distinct = [j for j in range(len(mentions))
                        if kinds[j] != kinds[first]]
            second = (int(distinct[mrng.integers(len(distinct))])
                      if distinct else int(mrng.integers(len(mentions))))
            caps, cls = [], []
            for j in (first, second):
                color_name, kind = mentions[j]
                part = (f"a {color_name} {kind}" if mrng.random() < 0.5
                        else f"a {kind}")
                tmpl = CAPTION_TEMPLATES[mrng.integers(
                    len(CAPTION_TEMPLATES))]
                caps.append(tmpl.format(part))
                cls.append(1 + SHAPE_CLASSES.index(kind))
        else:
            caps = {"color": [cap_color], "plain": [cap_plain],
                    "both": [cap_color, cap_plain]}[captions]
            cls = [0] * len(caps)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=quality)
        key = f"s{i:06d}"
        wi.add(key, buf.getvalue())
        wc.add(key, json.dumps(caps).encode())
        wm.add(key, json.dumps({"cls": cls, "scene": scene_mask}).encode())
        if ws is not None:
            labels = felzenszwalb(img, scale=224.0, sigma=0.9, min_size=224)
            ws.add(key, encode_seg_map(labels))
        if (i + 1) % log_every == 0:
            logger.info("procgen train corpus: %d/%d", i + 1, n_images)
    wi.close()
    wc.close()
    wm.close()
    if ws is not None:
        ws.close()
    return out_dir


def _forced_scene(rng: np.random.Generator, size: Tuple[int, int],
                  kind: str, color_name: str, equal_area: bool = False,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One scene containing exactly ONE shape of a forced (color, shape)
    pair — the probe unit of the compositional-generalization eval
    (write_pair_eval_split). Same background / jitter / size / rotation
    distributions as the training generator."""
    w, h = size
    img = Image.fromarray(_background(rng, w, h))
    mask = Image.new("L", (w, h), 0)
    draw, mdraw = ImageDraw.Draw(img), ImageDraw.Draw(mask)
    base = np.array(COLORS[color_name], np.int32)
    jitter = rng.integers(-18, 19, size=3)
    color = tuple(int(c) for c in np.clip(base + jitter, 0, 255))
    mult = (_equal_area_multipliers()[kind] if equal_area else 1.0)
    r_min, r_max = 0.12 * min(w, h), 0.24 * min(w, h)
    r = float(rng.uniform(r_min, r_max)) * mult
    cx = float(rng.uniform(r + 2, w - r - 2))
    cy = float(rng.uniform(r + 2, h - r - 2))
    angle = float(rng.uniform(0, 2 * math.pi))
    _draw_shape(draw, mdraw, kind, cx, cy, r, angle, color,
                1 + SHAPE_CLASSES.index(kind))
    return np.asarray(img), np.asarray(mask, np.int32)


def write_pair_eval_split(out_dir: str, n_per_pair: int = 6,
                          seed: int = 77_000,
                          min_side: int = 224, max_side: int = 288,
                          equal_area: bool = False) -> str:
    """Compositional-generalization probe set: for EVERY (color, shape)
    pair, `n_per_pair` single-shape scenes of exactly that pair, in VOC
    layout (readable by the unchanged SegEvalDataset / --dataset shapes)
    plus a `pairs.json` manifest mapping image name → {color, shape}.

    Analysis (scripts/holdout_study.py) splits per-class IoU by whether an
    image's pair was held out of training — the open-vocabulary evidence
    the reference claims but never isolates (class names are chosen at
    eval time, builder.py:46-79) — and re-evaluates the same images under
    attribute-COMPOSED queries ("red triangle") via the standard text-bank
    machinery. Seed range is disjoint from both the train corpus and the
    standard eval split."""
    img_dir = os.path.join(out_dir, "JPEGImages")
    ann_dir = os.path.join(out_dir, "SegmentationClass")
    split_dir = os.path.join(out_dir, "ImageSets", "Segmentation")
    for d in (img_dir, ann_dir, split_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    names, manifest = [], {}
    for kind in SHAPE_CLASSES:
        for color_name in COLORS:
            for j in range(n_per_pair):
                w = int(rng.integers(min_side, max_side + 1))
                h = int(rng.integers(min_side, max_side + 1))
                img, mask = _forced_scene(rng, (w, h), kind, color_name,
                                          equal_area)
                name = f"p_{color_name}_{kind}_{j:03d}"
                Image.fromarray(img).save(
                    os.path.join(img_dir, name + ".jpg"), quality=95)
                Image.fromarray(mask.astype(np.uint8)).save(
                    os.path.join(ann_dir, name + ".png"))
                names.append(name)
                manifest[name] = {"color": color_name, "shape": kind}
    with open(os.path.join(split_dir, "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(out_dir, "pairs.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def write_eval_split(out_dir: str, n_images: int, seed: int = 10_000,
                     min_side: int = 224, max_side: int = 288,
                     equal_area: bool = False) -> str:
    """VOC-layout eval split readable by the unchanged SegEvalDataset:
    JPEGImages/*.jpg + SegmentationClass/*.png (pixel value = class id) +
    ImageSets/Segmentation/val.txt.  Uses a disjoint seed range from the
    train corpus."""
    img_dir = os.path.join(out_dir, "JPEGImages")
    ann_dir = os.path.join(out_dir, "SegmentationClass")
    split_dir = os.path.join(out_dir, "ImageSets", "Segmentation")
    for d in (img_dir, ann_dir, split_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_images):
        w = int(rng.integers(min_side, max_side + 1))
        h = int(rng.integers(min_side, max_side + 1))
        img, mask, _ = generate_scene(rng, (w, h), equal_area=equal_area)
        name = f"e{i:05d}"
        Image.fromarray(img).save(os.path.join(img_dir, name + ".jpg"),
                                  quality=95)
        Image.fromarray(mask.astype(np.uint8)).save(
            os.path.join(ann_dir, name + ".png"))
        names.append(name)
    with open(os.path.join(split_dir, "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return out_dir
