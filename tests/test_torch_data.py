"""The port's data layer (segclip_tpu_torch/{native,data}, cli/prepare_data,
utils/logging) against its originals in the JAX package, on the same inputs.

Every module here is a copy in the port (the port imports nothing of
segclip_tpu), so each is held to its original exactly: files byte for byte,
arrays element for element, rng streams draw for draw, and the loader's
batches bit for bit. Tolerance everywhere: exact.
"""
import functools
import io
import json
import logging
import os
import pickle
import tarfile

import numpy as np
import pytest
from PIL import Image

from segclip_tpu import config as jconfig
from segclip_tpu.cli import prepare_data as jprep
from segclip_tpu.data import pipeline as jpipe
from segclip_tpu.data import procgen as jprocgen
from segclip_tpu.data import records as jrec
from segclip_tpu.data import superpixel as jsp
from segclip_tpu.data import transforms as jtf
from segclip_tpu.utils import logging as jlog

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.cli import prepare_data as tprep
from segclip_tpu_torch.data import pipeline as tpipe
from segclip_tpu_torch.data import records as trec
from segclip_tpu_torch.data import superpixel as tsp
from segclip_tpu_torch.data import transforms as ttf
from segclip_tpu_torch.native import build as tnative
from segclip_tpu_torch.utils import logging as tlog


def assert_same_tree(a, b):
    """Two directories with the same files, byte for byte."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert files(a) == files(b) and files(a)
    for rel in files(a):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_native_library_builds_into_build_dir_not_the_jax_package():
    lib = tnative.build()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert "segclip_tpu_torch" not in str(lib) and lib.exists()
    assert tnative.library_path() == lib


# ---------------------------------------------------------------------------
# SGR records
# ---------------------------------------------------------------------------

RECORDS = [("s000000", b"\xff\xd8jpeg"), ("ключ/2", b""), (b"\x00bin", bytes(range(256)) * 9),
           ("s000003", json.dumps(["a cat", "two cats"]).encode())]


def test_sgr_files_byte_identical_and_readers_agree(tmp_path):
    for module, name in ((jrec, "j.sgr"), (trec, "t.sgr")):
        with module.SgrWriter(str(tmp_path / name)) as w:
            for key, payload in RECORDS:
                w.add(key, payload)
    assert (tmp_path / "j.sgr").read_bytes() == (tmp_path / "t.sgr").read_bytes()

    path = str(tmp_path / "t.sgr")
    readers = [jrec.SgrReader(path), trec.SgrReader(path),
               trec.SgrReader(path, native=False)]
    assert [r.native for r in readers[1:]] == [True, False]
    ref = [readers[0].record(i) for i in range(len(RECORDS))]
    assert [k for k, _ in ref] == [k if isinstance(k, bytes) else k.encode()
                                   for k, _ in RECORDS]
    for r in readers:
        assert len(r) == len(RECORDS)
        assert [r.record(i) for i in range(len(r))] == ref
        assert list(r.keys()) == [k for k, _ in ref]
        assert r.get("ключ/2") == b"" and r.get(b"\x00bin") == RECORDS[2][1]
        with pytest.raises(IndexError):
            r.record(len(RECORDS))
        r.close()


def test_sgr_reader_rejects_a_bad_file(tmp_path):
    bad = tmp_path / "bad.sgr"
    bad.write_bytes(b"NOTSGR00" + bytes(16))
    with pytest.raises(ValueError, match="magic"):
        trec.SgrReader(str(bad))


def test_json_sidecar(tmp_path):
    jrec.write_json_sidecar(str(tmp_path / "j"), {"n": 3, "names": ["a"]})
    trec.write_json_sidecar(str(tmp_path / "t"), {"n": 3, "names": ["a"]})
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    assert trec.read_json_sidecar(str(tmp_path / "j")) == jrec.read_json_sidecar(
        str(tmp_path / "t"))


# ---------------------------------------------------------------------------
# superpixels, the seg-map codec and the crop from the cache
# ---------------------------------------------------------------------------

def _procgen_scene():
    img, _, _ = jprocgen.generate_scene(np.random.default_rng(3), (96, 80))
    return img, dict(scale=224.0, sigma=0.9, min_size=224)


def _two_region_image():
    img = np.zeros((40, 40, 3), np.uint8)
    img[:, 20:] = 255
    return img, dict(scale=100.0, sigma=0.5, min_size=20)


def _textured_image():
    img = np.random.default_rng(11).uniform(0, 255, (64, 72, 3)).astype(np.uint8)
    img[:, :30] //= 2
    return img, dict(scale=64.0, sigma=0.8, min_size=40)


@pytest.mark.parametrize("make", [_procgen_scene, _two_region_image, _textured_image],
                         ids=["procgen", "two-region", "textured"])
def test_felzenszwalb_labels_equal(make):
    img, kw = make()
    ref = jsp.felzenszwalb(img, **kw)
    out = tsp.felzenszwalb(img, **kw)
    assert out.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(tsp.felzenszwalb(img / 255.0, **kw),
                                  jsp.felzenszwalb(img / 255.0, **kw))


@pytest.mark.parametrize("binary", [True, False], ids=["sgm2", "zlib-json"])
def test_seg_map_codec(binary):
    labels = np.random.default_rng(5).integers(0, 300, (37, 53)).astype(np.int32)
    blob = tsp.encode_seg_map(labels, binary=binary)
    assert blob == jsp.encode_seg_map(labels, binary=binary)
    out = tsp.decode_seg_map(blob)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, jsp.decode_seg_map(blob))
    np.testing.assert_array_equal(out, labels)
    with pytest.raises(ValueError):
        tsp.encode_seg_map(np.full((2, 2), 70000, np.int32))


@pytest.mark.parametrize("coord", [
    (0.0, 0.0, 1.0, 1.0), (0.1, 0.2, 0.8, 0.9), (0.8, 0.2, 0.1, 0.9),
    (0.1, 0.9, 0.8, 0.2), (0.8, 0.9, 0.1, 0.2), (0.5, 0.5, 0.505, 0.9),
    (0.3, 0.6, 0.9, 0.6)],
    ids=["whole", "crop", "flip-h", "flip-v", "flip-both", "degenerate-w", "degenerate-h"])
@pytest.mark.parametrize("size, patch", [(224, 16), (64, 8)])
def test_crop_seg_from_cache(coord, size, patch):
    seg = np.random.default_rng(6).integers(0, 500, (131, 97)).astype(np.int32)
    coord = np.asarray(coord, np.float32)
    ref = jsp.crop_seg_from_cache(seg, coord, size, patch)
    out = tsp.crop_seg_from_cache(seg, coord, size, patch)
    assert out.dtype == ref.dtype and out.shape == (size // patch,) * 2
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wh", [(300, 200), (64, 64), (1, 50), (400, 20), (225, 224)])
@pytest.mark.parametrize("scale", [(0.5, 1.0), (0.08, 1.0)])
def test_random_resized_crop_coord_same_rng(wh, scale):
    arr = np.random.default_rng(sum(wh)).integers(0, 256, (wh[1], wh[0], 3)).astype(np.uint8)
    img = Image.fromarray(arr)
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        a, ca = jtf.random_resized_crop_coord(img, 48, rj, scale=scale)
        b, cb = ttf.random_resized_crop_coord(img, 48, rt, scale=scale)
        np.testing.assert_array_equal(b, a)
        assert cb.dtype == ca.dtype and np.array_equal(cb, ca)
        assert rt.random() == rj.random()            # same number of draws
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        *wj, cj = jtf.sample_crop_window(*wh, rj, scale)
        *wt, ct = ttf.sample_crop_window(*wh, rt, scale)
        assert wt == wj and np.array_equal(ct, cj) and rt.random() == rj.random()


def test_clip_normalize_and_eval_transform():
    arr = np.random.default_rng(2).integers(0, 256, (70, 90, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ttf.clip_normalize(arr), jtf.clip_normalize(arr))
    for img in (Image.fromarray(arr), Image.fromarray(arr).convert("L")):
        np.testing.assert_array_equal(ttf.eval_transform(img, 64),
                                      jtf.eval_transform(img, 64))


# ---------------------------------------------------------------------------
# prepare_data: every sub-command writes the same bytes
# ---------------------------------------------------------------------------

def _jpegs(root, n=5):
    root.mkdir()
    rng = np.random.default_rng(9)
    caps = {}
    for i in range(n):
        arr = rng.integers(0, 256, (40 + 9 * i, 60, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg", quality=85)
        caps[f"img_{i}.jpg"] = [f"caption {i}", f"alt {i}"]
    (root.parent / "caps.json").write_text(json.dumps(caps))
    return caps


def _setup_pack(tmp_path):
    _jpegs(tmp_path / "imgs")
    return ["pack", "--name", "c", "--image-dir", str(tmp_path / "imgs"),
            "--captions-json", str(tmp_path / "caps.json"), "--short-side", "32"]


def _setup_pack_pickle(tmp_path):
    caps = _jpegs(tmp_path / "imgs")
    imgs = {k: (tmp_path / "imgs" / k).read_bytes() for k in caps}
    (tmp_path / "p1.pkl").write_bytes(pickle.dumps(dict(list(imgs.items())[:3])))
    (tmp_path / "p2.pkl").write_bytes(pickle.dumps({**dict(list(imgs.items())[2:]),
                                                    "nocap.jpg": b"x"}))
    (tmp_path / "desc.pkl").write_bytes(pickle.dumps({k: v[0] for k, v in caps.items()}))
    return ["pack-pickle", "--name", "m", "--images-pkl", str(tmp_path / "p1.pkl"),
            str(tmp_path / "p2.pkl"), "--captions-pkl", str(tmp_path / "desc.pkl")]


def _setup_pack_tars(tmp_path):
    tar_dir = tmp_path / "tars"
    tar_dir.mkdir()
    rng = np.random.default_rng(4)
    for t in range(2):
        with tarfile.open(tar_dir / f"shard_{t}.tar", "w") as tf:
            for i in range(3):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)).save(
                    buf, format="JPEG")
                for name, data in ((f"s{t}_{i}.jpg", buf.getvalue()),
                                   (f"s{t}_{i}.txt", f"caption {t}/{i}".encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return ["pack-tars", "--name", "g", "--tar-dir", str(tar_dir), "--short-side", "32"]


def _setup_coco_gt(tmp_path):
    ann = tmp_path / "coco" / "annotations" / "val2017"
    ann.mkdir(parents=True)
    rng = np.random.default_rng(8)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20, 30)).astype(np.uint8)).save(
            ann / f"{i:012d}.png")
    return ["coco-gt", "--coco-path", str(tmp_path / "coco")]


COMMANDS = {
    "pack": _setup_pack,
    "pack-pickle": _setup_pack_pickle,
    "pack-tars": _setup_pack_tars,
    "coco-gt": _setup_coco_gt,
    "shapes": lambda _: ["shapes", "--train-n", "8", "--eval-n", "2"],
    "shapes-mention-holdout": lambda _: [
        "shapes", "--train-n", "6", "--eval-n", "1", "--captions", "mention",
        "--holdout", "--pair-eval-n", "1", "--equal-area", "--no-superpixels"],
}


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_prepare_data_writes_the_same_bytes(tmp_path, command):
    argv = COMMANDS[command](tmp_path)
    for module, out in ((jprep, "j"), (tprep, "t")):
        (tmp_path / out).mkdir()
        module.main(argv + ["--out-dir", str(tmp_path / out)])
    assert_same_tree(tmp_path / "j", tmp_path / "t")


def test_prepare_data_superpixels_writes_the_same_bytes(tmp_path):
    """superpixels over a packed images shard, in resumable chunks, the
    port's in two spawned workers."""
    argv = _setup_pack(tmp_path)
    for module, out, workers in ((jprep, "j", "1"), (tprep, "t", "2")):
        (tmp_path / out).mkdir()
        module.main(argv + ["--out-dir", str(tmp_path / out)])
        module.main(["superpixels", "--name", "c", "--data-dir", str(tmp_path / out),
                     "--chunk-size", "2", "--workers", workers])
    assert_same_tree(tmp_path / "j", tmp_path / "t")
    assert len(trec.SgrReader(str(tmp_path / "t" / "c_seg.sgr"))) == 5


# ---------------------------------------------------------------------------
# the loader: the JAX package's batches, bit for bit
# ---------------------------------------------------------------------------

# The three transports, as the DataConfig settings that select them.
TRANSPORTS = {"rgb": dict(transfer="rgb"), "yuv420": dict(transfer="yuv420"),
              "device_aug": dict(transfer="rgb", device_aug=True)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    tprep.main(["shapes", "--out-dir", str(root), "--train-n", "8", "--eval-n", "1"])
    return str(root)


@pytest.mark.parametrize("datatype, workers, transport", [
    ("shapes", 0, "rgb"), ("shapes", 2, "rgb"), ("synthetic", 0, "rgb"),
    ("shapes,synthetic", 0, "rgb"), ("shapes", 0, "yuv420"), ("shapes", 2, "yuv420"),
    ("shapes", 0, "device_aug"), ("shapes", 2, "device_aug")])
def test_batch_loader_batches_equal_jax(corpus, datatype, workers, transport):
    """Two epochs of BatchLoader.epoch on the same corpus, seed and sampler,
    in each transport (rgb crops; yuv420's Y and CbCr planes; device_aug's
    canvas, window and transposed flag): the same batches, keys, dtypes and
    bits."""
    kw = dict(datatype=datatype, data_dir=corpus, batch_size=4, max_words=16,
              **TRANSPORTS[transport])
    factory_kw = dict(use_seg=True, normalize=False, vocab_size=49408, image_size=64,
                      patch_size=8, emit_class_ids=datatype == "shapes")
    batches = []
    for pipe, config in ((jpipe, jconfig), (tpipe, tconfig)):
        cfg = config.DataConfig(**kw)
        factory = functools.partial(pipe.build_dataset, cfg, **factory_kw)
        dataset = factory()
        sampler = pipe.ShardedEpochSampler(len(dataset), 4, seed=7)
        loader = pipe.BatchLoader(dataset, sampler, seed=7, num_workers=workers,
                                  dataset_factory=factory)
        try:
            batches.append([b for epoch in (0, 1) for b in loader.epoch(epoch)])
        finally:
            loader.close()
    ref, out = batches
    assert len(out) == len(ref) == 2 * (len(dataset) // 4)
    assert {"rgb": "image", "yuv420": "image_y", "device_aug": "image_window"}[transport] \
        in out[0]
    for a, b in zip(ref, out):
        assert list(b) == list(a)
        for key in a:
            assert b[key].dtype == a[key].dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_sampler_and_load_one_retries():
    jsamp, tsamp = (m.ShardedEpochSampler(37, 8, shard=1, num_shards=2, seed=3)
                    for m in (jpipe, tpipe))
    for epoch in range(3):
        np.testing.assert_array_equal(tsamp.epoch_indices(epoch), jsamp.epoch_indices(epoch))
    with pytest.raises(ValueError):
        tpipe.ShardedEpochSampler(10, 5, num_shards=2)

    class Flaky:
        """Samples 0-2 are corrupt; the loader advances to 3."""

        def __len__(self):
            return 6

        def sample(self, idx, rng):
            if idx < 3:
                raise OSError(f"corrupt {idx}")
            return {"x": np.array([idx, rng.integers(100)])}

    for pipe in (jpipe, tpipe):
        out = pipe._load_one(Flaky(), 0, np.random.default_rng(0))
        np.testing.assert_array_equal(out["x"], [3, np.random.default_rng(0).integers(100)])


@pytest.mark.parametrize("overrides, normalize, transfer, warns", [
    ([], False, "yuv420", False),                              # the default
    ([], True, "rgb", False),                                  # yuv420 needs the uint8 schema
    (["data.device_aug=true"], False, "rgb", True),            # device_aug ships a canvas
    (["data.transfer=rgb", "data.device_aug=true"], False, "rgb", False)],
    ids=["yuv420", "yuv420-normalize", "yuv420-device_aug", "rgb-device_aug"])
def test_build_dataset_transport_fallback(corpus, overrides, normalize, transfer, warns):
    """build_dataset's rule, as the JAX package's: yuv420 with normalize=True
    or with device_aug falls back to rgb, with a warning for device_aug."""
    class Messages(logging.Handler):
        def emit(self, record):
            self.seen = getattr(self, "seen", "") + record.getMessage()

    got = []
    for pipe, config, logger in ((jpipe, jconfig, logging.getLogger("segclip")),
                                 (tpipe, tconfig, tlog.get_logger())):
        cfg = config.apply_overrides(config.Config(data=config.DataConfig(
            datatype="shapes", data_dir=corpus)), overrides).data
        handler = Messages()
        logger.addHandler(handler)
        try:
            ds = pipe.build_dataset(cfg, normalize=normalize)
        finally:
            logger.removeHandler(handler)
        got.append((ds.transfer, ds.device_aug, ds.normalize,
                    "overrides data.transfer='yuv420'" in getattr(handler, "seen", "")))
    assert got[0] == got[1] == (transfer, "data.device_aug=true" in overrides, normalize,
                                warns)


def test_unknown_transport_raises(corpus):
    for pipe in (jpipe, tpipe):
        with pytest.raises(ValueError, match="rgb|yuv420"):
            pipe.PairRecordDataset("shapes", corpus, normalize=False, transfer="yuv444")
        with pytest.raises(ValueError, match="normalize=False"):
            pipe.PairRecordDataset("shapes", corpus, normalize=False, transfer="yuv420",
                                   device_aug=True)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_metric_writer_and_logger(tmp_path):
    import torch
    for module, out in ((jlog, "j"), (tlog, "t")):
        w = module.MetricWriter(str(tmp_path / out))
        w.write(3, epoch=1, lr=np.float32(0.5), loss=2.5, note="x")
        w.write(4, miou=torch.tensor(12.25).numpy())
        logger = module.get_logger(str(tmp_path / out))
        logger.info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in (tmp_path / out / "metrics.jsonl").read_text().splitlines()]
            for out in ("j", "t")]
    assert rows[0] == rows[1] and len(rows[1]) == 2
    assert "hello 7" in (tmp_path / "t" / "log.txt").read_text()
    assert tlog.get_logger().name == "segclip_tpu_torch"
