"""Per-stage host cost of the input pipeline, in ms per sample, for each
transport (scripts/host_stage_bench.py): which transport suits a host.

Measures, on the first n samples of a packed SGR corpus, on the host's CPU
and in this process (no worker pool):
  decode (RGB / YCbCr-native), crop-resize (RGB / YUV), numpy
  rgb_to_yuv420, superpixel decode and crop, tokenize, and the whole
  `sample()` of each transport (rgb, yuv420, device_aug).

    python -m segclip_tpu_torch.studies.host_stage_bench <corpus_dir> [n]

It imports no torch and needs no card. The script's `_decode_jpeg(data,
False)` calls date from a removed decoder flag; here the mode is passed as
the pipeline passes it, and the device_aug `sample()` is added.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from segclip_tpu_torch.data.pipeline import PairRecordDataset, _decode_jpeg
from segclip_tpu_torch.data.superpixel import crop_seg_from_cache, decode_seg_map
from segclip_tpu_torch.data.tokenizer import tokenize_with_mask
from segclip_tpu_torch.data.transforms import (random_resized_crop_coord,
                                               random_resized_crop_yuv420, rgb_to_yuv420)


def timeit(fn, n: int) -> float:
    """Mean ms per call of fn(i) for i in range(n)."""
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n * 1e3


def corpus_name(corpus: str) -> str:
    names = sorted(f[:-len("_images.sgr")] for f in os.listdir(corpus)
                   if f.endswith("_images.sgr"))
    if not names:
        raise FileNotFoundError(f"no *_images.sgr in {corpus}")
    return names[-1]


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    corpus = argv[0]
    n = int(argv[1]) if len(argv) > 1 else 96
    name = corpus_name(corpus)

    ds = PairRecordDataset(name, corpus, use_seg=True, normalize=False)
    keys = ds._keys[:n]
    n = len(keys)
    jpegs = [ds.images.get(k) for k in keys]
    segs = [ds.seg.get(k) for k in keys]
    caps = [json.loads(ds.captions.get(k))[0] for k in keys]

    out = {}
    out["decode_rgb"] = timeit(lambda i: _decode_jpeg(jpegs[i]), n)
    out["decode_ycbcr"] = timeit(lambda i: _decode_jpeg(jpegs[i], "YCbCr").load(), n)
    imgs_rgb = [_decode_jpeg(j) for j in jpegs]
    imgs_yuv = [_decode_jpeg(j, "YCbCr") for j in jpegs]
    for im in imgs_yuv:
        im.load()
    out["crop_resize_rgb"] = timeit(
        lambda i: random_resized_crop_coord(imgs_rgb[i], 224, np.random.default_rng(i)), n)
    out["crop_resize_yuv420"] = timeit(
        lambda i: random_resized_crop_yuv420(imgs_yuv[i], 224, np.random.default_rng(i)), n)
    arrs = [random_resized_crop_coord(im, 224, np.random.default_rng(3))[0]
            for im in imgs_rgb]
    out["np_rgb_to_yuv420"] = timeit(lambda i: rgb_to_yuv420(arrs[i]), n)
    segmaps = [decode_seg_map(s) for s in segs]
    coord = random_resized_crop_coord(imgs_rgb[0], 224, np.random.default_rng(3))[1]
    out["seg_decode"] = timeit(lambda i: decode_seg_map(segs[i]), n)
    out["seg_crop"] = timeit(lambda i: crop_seg_from_cache(segmaps[i], coord, 224, 16), n)
    out["tokenize"] = timeit(lambda i: tokenize_with_mask(ds.tokenizer, caps[i], 32), n)

    for mode, kw in (("rgb", dict(transfer="rgb")), ("yuv420", dict(transfer="yuv420")),
                     ("device_aug", dict(transfer="rgb", device_aug=True))):
        d = PairRecordDataset(name, corpus, use_seg=True, normalize=False, **kw)
        out[f"sample_{mode}"] = timeit(lambda i: d.sample(i, np.random.default_rng(i)), n)

    print(f"host_stage_bench: {n} samples of {os.path.join(corpus, name)}")
    for k, v in out.items():
        print(f"{k:24s} {v:7.3f} ms/sample")
    return out


if __name__ == "__main__":
    main()
