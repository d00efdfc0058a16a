"""Offline data preparation (preprocess/{COCO,GCC3M} equivalents): a copy of
segclip_tpu/cli/prepare_data.py, whose output bytes tests/test_torch_data.py
holds identical to the original's.

    python -m segclip_tpu_torch.cli.prepare_data shapes --out-dir DIR \
        --train-n 20000 --eval-n 200

Subcommands:
  pack        images + captions → <name>_images.sgr / <name>_captions.sgr
              (replaces write_coco_images.py / generate_lmdb_from_pickles.py:
              images resized so the short side is 224 and re-encoded JPEG)
  pack-pickle migrate the reference's packed pickles (coco_train2014.pkl,
              cc3m_*_desc.pkl, cc3m_val.pkl, tar-extraction parts) → SGR,
              bytes verbatim — a lossless switchover path for existing
              reference datasets (also subsumes combine_pickle.py)
  superpixels compute Felzenszwalb maps over an images shard →
              <name>_seg.sgr (replaces felzenszwalb_extraction_*.py;
              scale=224 sigma=0.9 min_size=224)

Caption sources for `pack`:
  --captions-json  {"image_key": ["caption", ...], ...}
  --karpathy-json  Karpathy-split dataset_coco.json (images[].sentences[])

All heavy subcommands take `--workers N` and fan the per-item work out to a
spawned process pool (the reference uses a Queue map/reduce over worker
processes, felzenszwalb_extraction_coco.py:31-101 and multiprocess packing,
write_coco_images.py:18-87). Output bytes are IDENTICAL for every worker
count: items are processed in a fixed order and the parent writes results
in that order. `superpixels` additionally processes in resumable chunks —
completed `<out>.partK` files are skipped on restart, so a CC3M-scale job
(~3M images) survives interruption.
"""
from __future__ import annotations

import argparse
import glob
import io
import json
import multiprocessing as mp
import os
import sys
import tarfile

import numpy as np
from PIL import Image

from segclip_tpu_torch.data.records import SgrReader, SgrWriter
from segclip_tpu_torch.data.superpixel import encode_seg_map, felzenszwalb
from segclip_tpu_torch.utils.logging import get_logger


def _pool_imap(fn, tasks, workers: int, chunksize: int = 4):
    """Ordered map over a spawned pool; workers<=1 runs in-process (same
    code path, guaranteeing byte-identical output)."""
    if workers <= 1:
        yield from map(fn, tasks)
        return
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        yield from pool.imap(fn, tasks, chunksize=chunksize)


def resize_short_side(img: Image.Image, short: int = 224) -> Image.Image:
    w, h = img.size
    if min(w, h) <= short:
        return img
    s = short / min(w, h)
    return img.resize((int(round(w * s)), int(round(h * s))), Image.BICUBIC)


def load_captions(args) -> dict:
    if args.captions_json:
        with open(args.captions_json) as f:
            caps = json.load(f)
        return {k: (v if isinstance(v, list) else [v])
                for k, v in caps.items()}
    if args.karpathy_json:
        with open(args.karpathy_json) as f:
            data = json.load(f)
        out = {}
        for img in data["images"]:
            if args.karpathy_split and img.get("split") != args.karpathy_split:
                continue
            key = img["filename"]
            out[key] = [s["raw"] for s in img["sentences"]]
        return out
    raise SystemExit("pack needs --captions-json or --karpathy-json")


def _pack_one(task):
    """(key, path, short_side, quality) → (key, jpeg|None, error|None)."""
    key, path, short_side, quality = task
    try:
        img = Image.open(path).convert("RGB")
        img = resize_short_side(img, short_side)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        return key, buf.getvalue(), None
    except Exception as e:
        return key, None, f"{type(e).__name__}: {e}"


def cmd_pack(args):
    logger = get_logger()
    captions = load_captions(args)
    out_img = os.path.join(args.out_dir, f"{args.name}_images.sgr")
    out_cap = os.path.join(args.out_dir, f"{args.name}_captions.sgr")

    items = sorted(captions.items())
    tasks, n_missing = [], 0
    for key, caps in items:
        path = os.path.join(args.image_dir, key)
        if os.path.exists(path):
            tasks.append((key, path, args.short_side, args.quality))
        else:
            n_missing += 1

    caps_by_key = dict(items)
    n_ok = 0
    with SgrWriter(out_img) as wi, SgrWriter(out_cap) as wc:
        for key, jpeg, err in _pool_imap(_pack_one, tasks, args.workers,
                                         chunksize=16):
            if err is not None:
                logger.warning("skip %s: %s", key, err)
                continue
            wi.add(key, jpeg)
            wc.add(key, json.dumps(caps_by_key[key]).encode())
            n_ok += 1
            if n_ok % 1000 == 0:
                logger.info("packed %d images", n_ok)
    logger.info("done: %d packed, %d missing → %s", n_ok, n_missing, out_img)


def cmd_pack_pickle(args):
    """Migrate the reference's packed pickle artifacts straight into SGR
    shards, bytes verbatim (no decode/re-encode — the pickles already hold
    resized JPEGs, write_coco_images.py:18-44):
      coco_train2014.pkl / cc3m_val.pkl   dict key → JPEG bytes
        (dataloader_coco_retrieval.py:68-71, dataloader_cc_retrieval.py:85-89)
      cc3m_train_desc.pkl                 dict key → caption str
        (dataloader_cc_retrieval.py:63-65)
      tar-extraction intermediates        same dict-of-bytes pickles; pass
        several --images-pkl to merge them (combine_pickle.py equivalent)
    Keys present in both an images pickle and the caption source are packed
    (the reference drops caption entries without an image the same way,
    dataloader_coco_retrieval.py:87-88)."""
    import pickle
    logger = get_logger()
    out_img = os.path.join(args.out_dir, f"{args.name}_images.sgr")
    out_cap = os.path.join(args.out_dir, f"{args.name}_captions.sgr")

    if args.captions_pkl:
        with open(args.captions_pkl, "rb") as f:
            raw = pickle.load(f)
        captions = {k: (v if isinstance(v, list) else [str(v)])
                    for k, v in raw.items()}
    else:
        captions = load_captions(args)

    n_ok = n_skip = 0
    seen = set()
    with SgrWriter(out_img) as wi, SgrWriter(out_cap) as wc:
        for pkl_path in args.images_pkl:
            with open(pkl_path, "rb") as f:
                img_data = pickle.load(f)
            for key in sorted(img_data):
                if key in seen:           # first pickle wins on dup keys
                    continue
                seen.add(key)
                caps = captions.get(key)
                if not caps:
                    n_skip += 1
                    continue
                wi.add(key, bytes(img_data[key]))
                wc.add(key, json.dumps(caps).encode())
                n_ok += 1
                if n_ok % 10000 == 0:
                    logger.info("migrated %d images", n_ok)
            del img_data
    logger.info("done: %d migrated, %d without captions → %s",
                n_ok, n_skip, out_img)


def _pack_one_tar(task):
    """Process one webdataset tar into temp SGR shards.

    (tar_path, tmp_dir, short_side, quality) →
    (tar_path, tmp_img, tmp_cap, n_ok, n_bad). Each tar is independent, so
    tar-level parallelism keeps output deterministic: the parent merges the
    temp shards in sorted-tar order."""
    tar_path, tmp_dir, short_side, quality = task
    base = os.path.basename(tar_path)
    tmp_img = os.path.join(tmp_dir, f"{base}_images.sgr")
    tmp_cap = os.path.join(tmp_dir, f"{base}_captions.sgr")
    n_ok = 0
    errors: list = []                 # (stem, reason) — parent logs each
    pending: dict = {}
    with SgrWriter(tmp_img) as wi, SgrWriter(tmp_cap) as wc, \
            tarfile.open(tar_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            stem, ext = os.path.splitext(member.name)
            if ext not in (".jpg", ".jpeg", ".png", ".txt"):
                continue
            data = tf.extractfile(member).read()
            slot = pending.setdefault(stem, {})
            slot["caption" if ext == ".txt" else "image"] = data
            if "caption" in slot and "image" in slot:
                try:
                    img = Image.open(io.BytesIO(slot["image"]))
                    img = resize_short_side(img.convert("RGB"), short_side)
                    buf = io.BytesIO()
                    img.save(buf, format="JPEG", quality=quality)
                    wi.add(f"{base}/{stem}", buf.getvalue())
                    caption = slot["caption"].decode(
                        "utf-8", errors="replace").strip()
                    wc.add(f"{base}/{stem}", json.dumps([caption]).encode())
                    n_ok += 1
                except Exception as e:
                    errors.append((stem, f"{type(e).__name__}: {e}"))
                del pending[stem]
    errors.extend((stem, "unpaired member (missing image or caption)")
                  for stem in pending)
    return tar_path, tmp_img, tmp_cap, n_ok, errors


def _append_sgr(writer: SgrWriter, path: str) -> None:
    reader = SgrReader(path)
    for i in range(len(reader)):
        key, payload = reader.record(i)
        writer.add(key, payload)
    reader.close()


def cmd_pack_tars(args):
    """webdataset-style tar shards (xxx.jpg + xxx.txt members) → SGR shards
    (preprocess/GCC3M/extraxt_images_from_tar.py + generate_lmdb_from_pickles
    equivalents, collapsed into one pass). Parallelism is per-tar."""
    logger = get_logger()
    out_img = os.path.join(args.out_dir, f"{args.name}_images.sgr")
    out_cap = os.path.join(args.out_dir, f"{args.name}_captions.sgr")
    tars = sorted(glob.glob(os.path.join(args.tar_dir, "*.tar")))
    if not tars:
        raise SystemExit(f"no .tar files under {args.tar_dir}")

    tmp_dir = os.path.join(args.out_dir, f".{args.name}_tars_tmp")
    os.makedirs(tmp_dir, exist_ok=True)
    tasks = [(t, tmp_dir, args.short_side, args.quality) for t in tars]
    n_ok = n_bad = 0
    with SgrWriter(out_img) as wi, SgrWriter(out_cap) as wc:
        for tar_path, tmp_img, tmp_cap, ok, errors in _pool_imap(
                _pack_one_tar, tasks, args.workers, chunksize=1):
            _append_sgr(wi, tmp_img)
            _append_sgr(wc, tmp_cap)
            os.remove(tmp_img)
            os.remove(tmp_cap)
            n_ok += ok
            n_bad += len(errors)
            for stem, reason in errors:
                logger.warning("skip %s/%s: %s",
                               os.path.basename(tar_path), stem, reason)
            logger.info("%s done (%d packed, %d bad so far)",
                        os.path.basename(tar_path), n_ok, n_bad)
    # rmtree, not rmdir: stale temp shards from a previously interrupted
    # run are tolerated at start (exist_ok) and must not fail the exit.
    import shutil
    shutil.rmtree(tmp_dir, ignore_errors=True)
    logger.info("packed %d pairs → %s", n_ok, out_img)


def _superpixel_chunk(task):
    """Compute one resumable chunk [start, end) of the images shard into
    `<out>.partK`. A complete part file is skipped (resume); the write is
    tmp+rename so an interrupted chunk never looks complete."""
    images_path, part_path, start, end, scale, sigma, min_size = task
    if os.path.exists(part_path):
        return part_path, end - start, True
    reader = SgrReader(images_path)
    tmp = part_path + ".tmp"
    with SgrWriter(tmp) as w:
        for i in range(start, end):
            key, jpeg = reader.record(i)
            img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
            labels = felzenszwalb(img, scale=scale, sigma=sigma,
                                  min_size=min_size)
            w.add(key, encode_seg_map(labels))
    reader.close()
    os.replace(tmp, part_path)
    return part_path, end - start, False


def cmd_superpixels(args):
    logger = get_logger()
    images_path = os.path.join(args.data_dir, f"{args.name}_images.sgr")
    n = len(SgrReader(images_path))
    out = os.path.join(args.data_dir, f"{args.name}_seg.sgr")

    chunk = max(1, args.chunk_size)
    bounds = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    # Part names encode their [start,end) bounds: a resume with a DIFFERENT
    # --chunk-size (or a re-packed images shard of another length) cannot
    # silently merge stale chunks — mismatched parts are simply not reused.
    tasks = [(images_path, f"{out}.part{s}_{e}", s, e,
              args.scale, args.sigma, args.min_size)
             for s, e in bounds]
    expected = {t[1] for t in tasks}
    stale = [p for p in glob.glob(f"{out}.part*")
             if p not in expected and not p.endswith(".tmp")]
    for p in stale:
        logger.warning("ignoring stale chunk %s (bounds don't match the "
                       "current --chunk-size/shard — delete it or rerun "
                       "with the original settings to reuse it)", p)

    done = 0
    parts = []
    for part_path, n_items, resumed in _pool_imap(_superpixel_chunk, tasks,
                                                  args.workers, chunksize=1):
        parts.append(part_path)
        done += n_items
        logger.info("superpixels %d/%d%s", done, n,
                    " (chunk resumed)" if resumed else "")

    # reduce: merge parts in start-index order, then clean up
    with SgrWriter(out) as w:
        for part_path in sorted(
                parts,
                key=lambda p: int(p.rsplit("part", 1)[1].split("_")[0])):
            _append_sgr(w, part_path)
    for part_path in parts:
        os.remove(part_path)
    logger.info("wrote %s", out)


# COCO-Stuff 0-indexed labelmap ids that are absent among the 91 thing slots
# (the 11 COCO category ids never annotated); the remaining 80 thing ids map
# to trainIds 1..80, stuff (>90) and unlabeled (255) map to background 0 —
# the reference's clsID_to_trID table + shift
# (preprocess/COCO/convert_coco_object4val.py:26-206) generated
# programmatically.
_COCO_MISSING_THING_IDS = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}


def coco_object_trainid_table() -> np.ndarray:
    table = np.zeros(256, np.uint8)           # default: background 0
    next_tr = 1
    for cls in range(91):
        if cls in _COCO_MISSING_THING_IDS:
            continue
        table[cls] = next_tr
        next_tr += 1
    assert next_tr == 81
    return table


def cmd_coco_gt(args):
    """COCO-Stuff val2017 labelmaps → 81-class *_instanceTrainIds.png."""
    import glob
    logger = get_logger()
    ann_dir = os.path.join(args.coco_path, "annotations", "val2017")
    out_dir = os.path.join(args.out_dir or args.coco_path, "annotations",
                           "val2017")
    os.makedirs(out_dir, exist_ok=True)
    table = coco_object_trainid_table()
    files = [f for f in glob.glob(os.path.join(ann_dir, "*.png"))
             if "TrainIds" not in f]
    for i, path in enumerate(sorted(files)):
        mask = np.asarray(Image.open(path))
        out = table[mask]
        stem = os.path.basename(path).split(".")[0]
        Image.fromarray(out).save(
            os.path.join(out_dir, f"{stem}_instanceTrainIds.png"), "PNG")
        if (i + 1) % 1000 == 0:
            logger.info("converted %d/%d", i + 1, len(files))
    logger.info("converted %d masks → %s", len(files), out_dir)


def cmd_shapes(args):
    """Generate the procedural captioned-shapes corpus (data/procgen.py):
    a learnable-from-scratch pretraining corpus + VOC-layout eval split
    with exact GT masks, for proving the full pipeline learns. --holdout
    additionally excludes fixed color×shape compositions from every
    training image/caption and writes a per-pair probe split — the
    open-vocabulary generalization experiment (docs/PERF.md)."""
    from segclip_tpu_torch.data.procgen import (COLORS, HOLDOUT_PAIRS_DEFAULT,
                                                SHAPE_CLASSES, write_eval_split,
                                                write_pair_eval_split,
                                                write_train_corpus)
    logger = get_logger()
    holdout = None
    if args.holdout is not None:       # `--holdout` with no values = default
        holdout = (HOLDOUT_PAIRS_DEFAULT if not args.holdout
                   else [tuple(p.split(":")) for p in args.holdout])
        for pair in holdout:           # fail fast on malformed pairs
            if (len(pair) != 2 or pair[0] not in COLORS
                    or pair[1] not in SHAPE_CLASSES):
                raise SystemExit(
                    f"--holdout: bad pair {':'.join(pair)!r} — expected "
                    f"COLOR:SHAPE with COLOR in {sorted(COLORS)} and "
                    f"SHAPE in {list(SHAPE_CLASSES)}")
        logger.info("holding out pairs: %s", holdout)
    write_train_corpus(args.out_dir, args.train_n, seed=args.seed,
                       superpixels=not args.no_superpixels,
                       captions=args.captions, holdout_pairs=holdout,
                       equal_area=args.equal_area)
    logger.info("train corpus: %d scenes → %s/shapes_*.sgr",
                args.train_n, args.out_dir)
    eval_dir = os.path.join(args.out_dir, "eval")
    write_eval_split(eval_dir, args.eval_n, equal_area=args.equal_area)
    logger.info("eval split: %d scenes → %s (VOC layout, --dataset shapes)",
                args.eval_n, eval_dir)
    if args.holdout is not None or args.pair_eval_n:
        pair_dir = os.path.join(args.out_dir, "pair_eval")
        write_pair_eval_split(pair_dir, n_per_pair=args.pair_eval_n or 6,
                              equal_area=args.equal_area)
        logger.info("pair probe split: %d imgs/pair → %s",
                    args.pair_eval_n or 6, pair_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_workers(parser):
        parser.add_argument(
            "--workers", type=int, default=1,
            help="worker processes (-1 = cpu_count); output bytes are "
                 "identical for any value")

    p = sub.add_parser("pack")
    p.add_argument("--name", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--captions-json", default=None)
    p.add_argument("--karpathy-json", default=None)
    p.add_argument("--karpathy-split", default=None,
                   help="train/val/test filter for Karpathy json")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--short-side", type=int, default=224)
    p.add_argument("--quality", type=int, default=90)
    add_workers(p)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("pack-pickle")
    p.add_argument("--name", required=True)
    p.add_argument("--images-pkl", required=True, nargs="+",
                   help="dict key→JPEG-bytes pickle(s) (coco_train2014.pkl, "
                        "cc3m_val.pkl, tar-extraction parts — merged in "
                        "order)")
    p.add_argument("--captions-json", default=None)
    p.add_argument("--karpathy-json", default=None)
    p.add_argument("--karpathy-split", default=None)
    p.add_argument("--captions-pkl", default=None,
                   help="dict key→caption pickle (cc3m_train_desc.pkl)")
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_pack_pickle)

    p = sub.add_parser("pack-tars")
    p.add_argument("--name", required=True)
    p.add_argument("--tar-dir", required=True,
                   help="directory of webdataset .tar shards")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--short-side", type=int, default=224)
    p.add_argument("--quality", type=int, default=90)
    add_workers(p)
    p.set_defaults(fn=cmd_pack_tars)

    p = sub.add_parser("superpixels")
    p.add_argument("--name", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--scale", type=float, default=224.0)
    p.add_argument("--sigma", type=float, default=0.9)
    p.add_argument("--min-size", type=int, default=224)
    p.add_argument("--chunk-size", type=int, default=2000,
                   help="records per resumable chunk")
    add_workers(p)
    p.set_defaults(fn=cmd_superpixels)

    p = sub.add_parser("shapes")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-n", type=int, default=20000)
    p.add_argument("--eval-n", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-superpixels", action="store_true")
    p.add_argument("--captions",
                   choices=["color", "plain", "both", "mention",
                            "mention-only"],
                   default="both",
                   help="caption style(s) per image; 'both' (default) "
                        "packs two samples/image — color-only has a "
                        "color-statistics shortcut that never grounds "
                        "shape names, plain-only learns slowly from "
                        "duplicate false-negatives; 'mention' packs "
                        "[color-full, single-shape mention] to spread "
                        "contrastive gradient evenly over shape classes "
                        "(data/procgen.py)")
    p.add_argument("--holdout", nargs="*", default=None, metavar="COLOR:SHAPE",
                   help="exclude color×shape compositions from every "
                        "training image AND caption (open-vocabulary "
                        "generalization split). No values = the default "
                        "one-pair-per-shape set "
                        "(procgen.HOLDOUT_PAIRS_DEFAULT); or list "
                        "pairs like red:triangle. Also writes the "
                        "pair_eval/ probe split + holdout.json manifest")
    p.add_argument("--pair-eval-n", type=int, default=None,
                   help="images per (color, shape) pair in the pair_eval "
                        "probe split (default 6 when --holdout is set)")
    p.add_argument("--equal-area", action="store_true",
                   help="equalize expected pixel area across shape classes "
                        "(per-shape circumradius multipliers). Removes the "
                        "area confound in per-class grounding order — at a "
                        "shared radius, square has 3x triangle's pixels "
                        "(procgen._equal_area_multipliers; docs/PERF.md)")
    p.set_defaults(fn=cmd_shapes)

    p = sub.add_parser("coco-gt")
    p.add_argument("--coco-path", required=True,
                   help="coco_stuff164k root with annotations/val2017")
    p.add_argument("--out-dir", default=None)
    p.set_defaults(fn=cmd_coco_gt)

    args = ap.parse_args(argv)
    if getattr(args, "workers", 1) < 0:
        args.workers = os.cpu_count() or 1
    args.fn(args)


if __name__ == "__main__":
    main()
