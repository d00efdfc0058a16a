"""Training input pipeline (segclip_tpu/data/pipeline.py): record-backed image-text datasets, sharded epoch sampling, and a
background-prefetch batch loader. Its batches are the JAX package's, bit for
bit (tests/test_torch_data.py).

Replaces the reference's torch DataLoader stack (dataloaders/*.py):
  - COCO-style: one sample per (image, caption) pair
    (dataloader_coco_retrieval.py:139-159);
  - CC-style: one caption per image key (dataloader_cc_retrieval.py);
  - comma-joined dataset concatenation ("cc,coco,") like DATALOADER_DICT's
    ConcatDataset synthesis (data_dataloaders.py:80-116);
  - DistributedSampler semantics: per-epoch seeded shuffle, host sharding,
    drop_last (data_dataloaders.py:32-43);
  - corrupt-image retry advancing the index mod len, ≤50 tries
    (dataloader_cc_retrieval.py:149-162);
  - superpixel maps cut from the cached full-image map with the crop coords.

Storage is SGR record files (data/records.py):
  <name>_images.sgr    key → JPEG bytes
  <name>_captions.sgr  key → JSON list[str]
  <name>_seg.sgr       key → superpixel map (data/superpixel.py)
  <name>_meta.sgr      key → {"cls": [...], "scene": bitmask} (optional)

`BatchLoader(num_workers=N)` decodes batches in N spawned worker processes,
each building its own dataset from a picklable factory. Sample randomness is
derived from the GLOBAL sample position — `default_rng((seed, epoch, shard,
position))` — so batches are bit-identical for every worker count,
including 0 (in-thread). Nothing here imports torch, so a worker never
creates a CUDA context.

Images ship as uint8 in one of three transports (`data.transfer`,
`data.device_aug`), and the train step finishes them on the device
(train/step.normalize_images):
  - rgb: the (S, S, 3) crop, resized on the host;
  - yuv420 (the default): decode, crop and resample YCbCr-native, Y at S²
    and CbCr at (S/2)², half the bytes of rgb; the step rebuilds RGB
    (ops/device_aug.yuv420_to_rgb);
  - device_aug: the decoded image padded into an (S, 2S, 3) canvas plus
    its crop window, twice the bytes of rgb and no host resample; the step
    runs the bicubic crop-resize (ops/device_aug.crop_resize_batch).
"""
from __future__ import annotations

import io
import json
import multiprocessing as mp
import os
import queue
import threading
import traceback
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from segclip_tpu_torch.config import DataConfig
from segclip_tpu_torch.data.records import SgrReader
from segclip_tpu_torch.data.superpixel import crop_seg_from_cache, decode_seg_map
from segclip_tpu_torch.data.tokenizer import (ClipTokenizer, default_tokenizer,
                                              tokenize_with_mask)
from segclip_tpu_torch.data.transforms import (clip_normalize, random_resized_crop_coord,
                                               random_resized_crop_yuv420,
                                               sample_crop_window)
from segclip_tpu_torch.utils.logging import get_logger


def _decode_jpeg(data: bytes, mode: str = "RGB") -> Image.Image:
    """JPEG decode via PIL (the reference's decoder).

    mode='YCbCr' (yuv420 transport path) asks libjpeg for its NATIVE
    output colorspace via draft() — the decoder skips its YCbCr→RGB
    conversion and hands back the stored planes (grayscale/exotic JPEGs
    fall back to a PIL convert, same JFIF matrix)."""
    if mode == "YCbCr":
        img = Image.open(io.BytesIO(data))
        img.draft("YCbCr", img.size)
        if img.mode != "YCbCr":
            try:
                img = img.convert("YCbCr")
            except ValueError:
                img = img.convert("RGB").convert("YCbCr")
        return img
    return Image.open(io.BytesIO(data)).convert("RGB")


class PairRecordDataset:
    """Image-text(-superpixel) dataset over SGR shards."""

    def __init__(self, name: str, data_dir: str, max_words: int = 32,
                 image_size: int = 224, patch_size: int = 16,
                 use_seg: bool = True,
                 tokenizer: Optional[ClipTokenizer] = None,
                 crop_scale: Tuple[float, float] = (0.5, 1.0),
                 normalize: bool = True,
                 device_aug: bool = False,
                 transfer: str = "rgb",
                 emit_class_ids: bool = False):
        self.normalize = normalize
        self.device_aug = device_aug
        if transfer not in ("rgb", "yuv420"):
            raise ValueError(f"transfer must be rgb|yuv420, got {transfer!r}")
        if transfer == "yuv420" and (normalize or device_aug):
            raise ValueError("transfer='yuv420' requires normalize=False "
                             "and the host-crop path (device_aug=False)")
        self.transfer = transfer
        self.crop_scale = tuple(crop_scale)
        self.name = name
        self.images = SgrReader(os.path.join(data_dir, f"{name}_images.sgr"))
        self.captions = SgrReader(
            os.path.join(data_dir, f"{name}_captions.sgr"))
        seg_path = os.path.join(data_dir, f"{name}_seg.sgr")
        if use_seg and not os.path.exists(seg_path):
            raise FileNotFoundError(
                f"use_seglabel requires {seg_path} — run "
                f"`prepare_data superpixels --name {name}` first")
        self.seg = SgrReader(seg_path) if use_seg else None
        self.max_words = max_words
        self.image_size = image_size
        self.patch_size = patch_size
        self.tokenizer = tokenizer or default_tokenizer()

        # Class-metadata sidecar for model.infonce_mask (written by
        # procgen.write_train_corpus), opened only when the loss needs it.
        self.meta = None
        if emit_class_ids:
            meta_path = os.path.join(data_dir, f"{name}_meta.sgr")
            if not os.path.exists(meta_path):
                raise FileNotFoundError(
                    f"model.infonce_mask needs {meta_path} — regenerate the "
                    f"corpus (`prepare_data shapes` writes the class-metadata "
                    f"sidecar)")
            self.meta = SgrReader(meta_path)

        # samples = (image_index, caption_index-within-key)
        self._keys: List[bytes] = []
        self._samples: List[Tuple[int, int]] = []
        self._text_class: List[int] = []
        self._scene_classes: List[int] = []
        for i in range(len(self.captions)):
            key, payload = self.captions.record(i)
            n_caps = len(json.loads(payload))
            self._keys.append(key)
            if self.meta is not None:
                m = json.loads(self.meta.get(key))
                if len(m["cls"]) != n_caps:
                    raise ValueError(
                        f"meta shard cls count {len(m['cls'])} != caption "
                        f"count {n_caps} for key {key!r}")
                self._scene_classes.append(int(m["scene"]))
                self._text_class.extend(int(c) for c in m["cls"])
            for c in range(n_caps):
                self._samples.append((i, c))

    def __len__(self) -> int:
        return len(self._samples)

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        img_i, cap_i = self._samples[idx]
        key = self._keys[img_i]

        caption = json.loads(self.captions.get(key))[cap_i]
        img = _decode_jpeg(self.images.get(key),
                           mode="YCbCr" if self.transfer == "yuv420" else "RGB")
        ids, mask = tokenize_with_mask(self.tokenizer, caption, self.max_words)
        if self.device_aug:
            out = self._sample_device_aug(img, rng)
            coord = out.pop("_coord")
        elif self.transfer == "yuv420":
            # decode, crop and resample YCbCr-native; the step rebuilds RGB
            y, cbcr, coord = random_resized_crop_yuv420(
                img, self.image_size, rng, scale=self.crop_scale)
            out = {"image_y": y, "image_cbcr": cbcr}
        else:
            arr, coord = random_resized_crop_coord(img, self.image_size, rng,
                                                   scale=self.crop_scale)
            # normalize=False ships uint8; the train step normalizes on device.
            out = {"image": clip_normalize(arr) if self.normalize else arr}
        out["input_ids"] = ids
        out["attention_mask"] = mask
        if self.meta is not None:
            out["text_class"] = np.int32(self._text_class[idx])
            out["scene_classes"] = np.int32(self._scene_classes[img_i])
        if self.seg is not None:
            # the superpixel crop stays on the host in every transport
            seg_full = decode_seg_map(self.seg.get(key))
            out["image_seg"] = crop_seg_from_cache(
                seg_full, coord, self.image_size,
                self.patch_size).astype(np.int32)
        return out

    def _sample_device_aug(self, img: Image.Image,
                           rng: np.random.Generator) -> Dict:
        """Device-augmentation schema: the decoded image padded into a
        fixed (S, 2S, 3) canvas plus the crop window; the train step runs
        the bicubic crop-resize (ops/device_aug.py). Tall images are
        transposed into the canvas (exact for separable resampling); crop
        windows are drawn with the IDENTICAL rng sequence as the
        host-resize path, so both modes see the same crops.

        Fallback pre-shrinks: short side > S, or aspect ratio > 2.
        """
        S = self.image_size
        wmax = 2 * S
        w0, h0 = img.size
        short, long = min(w0, h0), max(w0, h0)
        if short > S or long > min(2 * short, wmax):
            s = min(S / short, wmax / long, 1.0)
            img = img.resize((max(1, round(w0 * s)), max(1, round(h0 * s))),
                             Image.BICUBIC)
        if img.mode != "RGB":
            img = img.convert("RGB")
        width, height = img.size
        i, j, h, w, coord = sample_crop_window(width, height, rng,
                                               scale=self.crop_scale)
        arr = np.asarray(img)
        transposed = height > width
        if transposed:
            arr = np.ascontiguousarray(arr.transpose(1, 0, 2))
            i, j, h, w = j, i, w, h
        canvas = np.zeros((S, wmax, 3), np.uint8)
        canvas[:arr.shape[0], :arr.shape[1]] = arr
        return {
            "image": canvas,
            "image_window": np.array([j, i, w, h], np.int32),
            "image_transposed": np.uint8(transposed),
            "_coord": coord,
        }


class SyntheticDataset:
    """Random data with the training-batch schema, for smoke runs."""

    def __init__(self, length: int = 512, max_words: int = 32,
                 image_size: int = 224, patch_size: int = 16,
                 vocab_size: int = 49408, use_seg: bool = True,
                 normalize: bool = True, emit_class_ids: bool = False):
        self.length = length
        self.max_words = max_words
        self.image_size = image_size
        self.grid = image_size // patch_size
        self.vocab = vocab_size
        self.use_seg = use_seg
        self.normalize = normalize
        self.emit_class_ids = emit_class_ids

    def __len__(self):
        return self.length

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        ids = np.zeros(self.max_words, np.int32)
        n = int(rng.integers(4, self.max_words))
        # start/end tokens at vocab-2/vocab-1 (= CLIP's 49406/49407 for the
        # real vocab) so shrunken-vocab smoke configs never emit ids beyond
        # the model's embedding table.
        ids[0] = self.vocab - 2
        ids[1:n - 1] = rng.integers(1, min(self.vocab - 2, 49000),
                                    size=n - 2)
        ids[n - 1] = self.vocab - 1
        if self.normalize:
            image = rng.normal(size=(self.image_size, self.image_size, 3)
                               ).astype(np.float32) * 0.3
        else:
            image = rng.integers(
                0, 256, size=(self.image_size, self.image_size, 3)
            ).astype(np.uint8)
        out = {
            "input_ids": ids,
            "attention_mask": (ids != 0).astype(np.int32),
            "image": image,
        }
        if self.use_seg:
            out["image_seg"] = rng.integers(
                0, 24, size=(self.grid, self.grid)).astype(np.int32)
        if self.emit_class_ids:
            # schema-compatible infonce_mask metadata: a 6-class world where
            # the scene always contains the caption's class when one is named
            cls = np.int32(rng.integers(0, 7))
            scene = np.int32(rng.integers(0, 64))
            if cls > 0:
                scene |= np.int32(1) << (cls - 1)
            out["text_class"] = cls
            out["scene_classes"] = scene
        return out


class ConcatDataset:
    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self):
        return int(self._offsets[-1])

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        part = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.parts[part].sample(idx - int(self._offsets[part]), rng)


def build_dataset(cfg: DataConfig, use_seg: bool = True,
                  normalize: bool = True, vocab_size: int = 49408,
                  image_size: int = 224, patch_size: int = 16,
                  emit_class_ids: bool = False):
    """datatype "synthetic" | comma-joined shard names ("cc,coco,").

    Also serves as the picklable per-worker dataset factory
    (functools.partial(build_dataset, cfg, ...)). vocab_size / image_size /
    patch_size come from the MODEL config so the samples match the model's
    embedding table, input resolution, and superpixel grid.

    yuv420 rides the uint8 schema that the step normalizes, and device_aug
    ships its own canvas: with normalize=True, or with device_aug, the
    transfer falls back to rgb (with a warning for device_aug, the
    user-visible flag)."""
    names = [n for n in cfg.datatype.split(",") if n]
    transfer = cfg.transfer
    if transfer == "yuv420" and (normalize or cfg.device_aug):
        if cfg.device_aug:
            get_logger().warning(
                "data.device_aug=True overrides data.transfer='yuv420' "
                "(device_aug ships its own canvas); using transfer='rgb'")
        transfer = "rgb"
    parts = []
    for name in names:
        if name == "synthetic":
            parts.append(SyntheticDataset(max_words=cfg.max_words,
                                          use_seg=use_seg,
                                          vocab_size=vocab_size,
                                          image_size=image_size,
                                          patch_size=patch_size,
                                          normalize=normalize,
                                          emit_class_ids=emit_class_ids))
        else:
            parts.append(PairRecordDataset(name, cfg.data_dir,
                                           max_words=cfg.max_words,
                                           use_seg=use_seg,
                                           image_size=image_size,
                                           patch_size=patch_size,
                                           crop_scale=cfg.crop_scale,
                                           normalize=normalize,
                                           device_aug=cfg.device_aug,
                                           transfer=transfer,
                                           emit_class_ids=emit_class_ids))
    if not parts:
        raise ValueError(f"no datasets in datatype={cfg.datatype!r}")
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


class ShardedEpochSampler:
    """DistributedSampler semantics: seeded per-epoch shuffle, contiguous
    padding-free host shards, drop_last to a multiple of global batch."""

    def __init__(self, length: int, global_batch: int, shard: int = 0,
                 num_shards: int = 1, seed: int = 42):
        if global_batch % num_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"into {num_shards} shards")
        self.length = length
        self.global_batch = global_batch
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.per_shard_batch = global_batch // num_shards
        self.steps = length // global_batch

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.length)[:self.steps * self.global_batch]
        # (steps, num_shards, per_shard_batch) → this host's column
        perm = perm.reshape(self.steps, self.num_shards, self.per_shard_batch)
        return perm[:, self.shard, :]


MAX_RETRIES = 50


def _load_one(dataset, idx: int, rng) -> Dict:
    """≤50-retry corrupt-sample loop advancing the index mod len
    (dataloader_cc_retrieval.py:149-162)."""
    last_err = None
    for _ in range(MAX_RETRIES):
        try:
            return dataset.sample(int(idx), rng)
        except Exception as e:              # corrupt record → advance
            if last_err is None:
                get_logger().warning("sample %d failed (%s: %s); "
                                     "retrying subsequent indices",
                                     idx, type(e).__name__, e)
            last_err = e
            idx = (int(idx) + 1) % len(dataset)
    raise RuntimeError(
        f"{MAX_RETRIES} consecutive corrupt samples "
        f"(last: {type(last_err).__name__}: {last_err})") from last_err


def _assemble_batch(dataset, seed: int, epoch: int, shard: int, step: int,
                    indices: np.ndarray) -> Dict[str, np.ndarray]:
    """Decode one batch. Each sample's rng is seeded from its GLOBAL
    position so the result is independent of which worker (or how many)
    produced it."""
    samples = []
    base = step * len(indices)
    for slot, idx in enumerate(indices):
        rng = np.random.default_rng((seed, epoch, shard, base + slot))
        samples.append(_load_one(dataset, idx, rng))
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _mp_worker(factory: Callable[[], object], seed: int, shard: int,
               task_q, result_q):
    """Persistent worker-process loop: lazily builds its own dataset (the
    reference likewise opens LMDB handles per worker,
    dataloader_cc_retrieval.py:98-106) and decodes whole batches."""
    dataset = None
    while True:
        task = task_q.get()
        if task is None:
            return
        epoch, step, indices = task
        try:
            if dataset is None:
                dataset = factory()
            batch = _assemble_batch(dataset, seed, epoch, shard, step,
                                    indices)
            result_q.put(("ok", epoch, step, batch))
        except Exception as e:
            result_q.put(("err", epoch, step,
                          f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}"))


class BatchLoader:
    """Iterates batches for one epoch, decoded either by a background
    prefetch thread (num_workers=0) or by `num_workers` spawned processes
    (the reference's DataLoader(num_workers=N), data_dataloaders.py:9-12).

    Batches are bit-identical for any worker count: sample randomness is a
    pure function of (seed, epoch, shard, global position). Workers are
    spawned lazily on the first epoch and reused across epochs; an epoch
    abandoned mid-iteration tears the pool down (stale in-flight results
    must not leak into the next epoch) and the next epoch respawns it.
    """

    def __init__(self, dataset, sampler: ShardedEpochSampler, seed: int = 0,
                 prefetch: int = 4, num_workers: int = 0,
                 dataset_factory: Optional[Callable[[], object]] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.dataset_factory = dataset_factory
        if num_workers > 0 and dataset_factory is None:
            raise ValueError("num_workers > 0 needs a picklable "
                             "dataset_factory (workers rebuild the dataset; "
                             "open mmap/file handles don't pickle)")
        self._procs: List = []
        self._task_q = None
        self._result_q = None

    # ---- worker pool lifecycle ------------------------------------------

    def _ensure_pool(self):
        if self._procs:
            return
        ctx = mp.get_context("spawn")   # fork is unsafe in a threaded process
        self._task_q = ctx.Queue(maxsize=2 * self.num_workers)
        self._result_q = ctx.Queue(
            maxsize=max(self.prefetch, self.num_workers))
        self._procs = []
        for _ in range(self.num_workers):
            p = ctx.Process(target=_mp_worker,
                            args=(self.dataset_factory, self.seed,
                                  self.sampler.shard, self._task_q,
                                  self._result_q),
                            daemon=True)
            p.start()
            self._procs.append(p)

    def close(self):
        """Terminate the worker pool (idempotent)."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        for q_ in (self._task_q, self._result_q):
            if q_ is not None:
                q_.cancel_join_thread()
                q_.close()
        self._procs, self._task_q, self._result_q = [], None, None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- epoch iterators -------------------------------------------------

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers > 0:
            yield from self._epoch_mp(epoch)
        else:
            yield from self._epoch_thread(epoch)

    def _epoch_mp(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        indices = self.sampler.epoch_indices(epoch)
        n_steps = len(indices)
        self._ensure_pool()
        stop = threading.Event()

        def feeder():
            for step in range(n_steps):
                task = (epoch, step, indices[step])
                while not stop.is_set():
                    try:
                        self._task_q.put(task, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return

        t = threading.Thread(target=feeder, daemon=True)
        t.start()

        pending: Dict[int, Dict] = {}    # out-of-order reorder buffer
        next_step = 0
        try:
            while next_step < n_steps:
                if next_step in pending:
                    yield pending.pop(next_step)
                    next_step += 1
                    continue
                try:
                    # Bounded get + liveness check: a worker killed outside
                    # Python (OOM killer, native segfault) never posts its
                    # result — without this the consumer blocks forever.
                    status, ep, step, payload = self._result_q.get(
                        timeout=5.0)
                except queue.Empty:
                    dead = [(p.pid, p.exitcode) for p in self._procs
                            if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"data worker process(es) "
                            f"{[pid for pid, _ in dead]} died (exit codes "
                            f"{[code for _, code in dead]}) — likely "
                            f"OOM-killed or crashed in native decode"
                        ) from None
                    continue
                if ep != epoch:
                    continue             # stale result from a torn-down run
                if status == "err":
                    raise RuntimeError(f"data worker failed at step {step}:"
                                       f"\n{payload}")
                pending[step] = payload
        finally:
            stop.set()
            if next_step < n_steps:      # abandoned mid-epoch
                self.close()

    def _epoch_thread(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        indices = self.sampler.epoch_indices(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that re-checks `stop` — an abandoned consumer
            must not leave the producer blocked on a full queue holding
            decoded batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for step, step_idx in enumerate(indices):
                    if stop.is_set():
                        return
                    batch = _assemble_batch(self.dataset, self.seed, epoch,
                                            self.sampler.shard, step,
                                            step_idx)
                    if not put(batch):
                        return
            except Exception as e:
                put(e)
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
