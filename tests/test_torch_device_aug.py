"""The port's device-side transforms (segclip_tpu_torch/ops/device_aug.py),
the yuv420 host transforms and decode, and the train step on the yuv420 and
device_aug transports, against the JAX package on the same seeded inputs.

Tolerances:
  - crop-resize: within one uint8 level of JAX (float32 sums in another
    order can move a value across a rounding boundary of the rounded,
    clipped intermediate) and of PIL (PIL's 8.22 fixed-point weights, as
    tests/test_device_aug.py asserts for JAX);
  - yuv420_to_rgb: within 1e-3 of JAX on the [0, 255] scale, borders
    included;
  - the superpixel reduction, rgb_to_yuv420, random_resized_crop_yuv420 and
    the YCbCr decode: bit for bit;
  - one float32 step: every metric within 1e-5 relative of JAX's, the same
    Gumbel noise injected into both.
"""
import io
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from segclip_tpu.config import Config, ModelConfig, OptimConfig, TrainConfig
from segclip_tpu.data import pipeline as jpipe
from segclip_tpu.data import transforms as jtf
from segclip_tpu.data.superpixel import crop_seg_from_cache
from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
from segclip_tpu.ops import device_aug as jaug
from segclip_tpu.train.step import create_train_state, make_single_device_train_step

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint.convert import load_into, state_dict_from_jax
from segclip_tpu_torch.data import pipeline as tpipe
from segclip_tpu_torch.data import transforms as ttf
from segclip_tpu_torch.models.segclip import SegCLIP
from segclip_tpu_torch.ops import device_aug as taug
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

torch.set_num_threads(2)
LEVEL = 1.0
YUV_TOL = 1e-3
LOSS_RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def _pil_crop_resize(img, window, s):
    j, i, w, h = window
    out = Image.fromarray(img).crop((j, i, j + w, i + h)).resize((s, s), Image.BICUBIC)
    return np.asarray(out).astype(np.float32)


def _wide_case(seed, s=224):
    rng = np.random.default_rng(seed)
    h0, w0 = int(rng.integers(s // 2, s + 1)), int(rng.integers(s, 2 * s + 1))
    img = rng.integers(0, 256, (h0, w0, 3)).astype(np.uint8)
    w, h = int(rng.integers(40, w0 + 1)), int(rng.integers(40, h0 + 1))
    return img, (int(rng.integers(0, w0 - w + 1)), int(rng.integers(0, h0 - h + 1)), w, h), s


def _small_case(window):
    s = 64
    return np.random.default_rng(4).integers(0, 256, (s, s, 3)).astype(np.uint8), window, s


CASES = {f"wide{k}": (lambda k=k: _wide_case(k)) for k in range(4)}
CASES["upscale"] = lambda: _small_case((10, 12, 30, 25))
CASES["full-window"] = lambda: _small_case((0, 0, 64, 64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_resize_one_matches_jax_and_pil(case):
    """Both pass orders against JAX's; the horizontal-first one (PIL's
    order) against PIL's crop().resize()."""
    img, window, s = CASES[case]()
    canvas = np.zeros((s, 2 * s, 3), np.uint8)
    canvas[:img.shape[0], :img.shape[1]] = img
    for vf in (None, 1):
        ref = _np(jaug.crop_resize_one(jnp.asarray(canvas), jnp.asarray(window, jnp.int32), s,
                                       None if vf is None else jnp.int32(vf)))
        out = taug.crop_resize_one(torch.from_numpy(canvas), torch.tensor(window), s,
                                   None if vf is None else torch.tensor(vf))
        assert out.dtype == torch.float32 and out.shape == (s, s, 3)
        assert np.abs(out.numpy() - ref).max() <= LEVEL, vf
    assert np.abs(taug.crop_resize_one(torch.from_numpy(canvas), torch.tensor(window), s)
                  .numpy() - _pil_crop_resize(img, window, s)).max() <= LEVEL


def test_crop_resize_batch_wide_and_transposed():
    """A batch of wide canvases and transposed tall ones (swapped windows):
    each within a level of JAX's batch, and the tall one of PIL's resize of
    the untransposed image."""
    s = 96
    rng = np.random.default_rng(5)
    canvas = np.zeros((4, s, 2 * s, 3), np.uint8)
    tall = rng.integers(0, 256, (180, 90, 3)).astype(np.uint8)
    canvas[0, :90, :180] = tall.transpose(1, 0, 2)
    windows = [[20, 5, 120, 70]]                       # (i, j, h, w) of the tall image
    for b in range(1, 4):
        img, window, _ = _wide_case(10 + b, s)
        canvas[b, :img.shape[0], :img.shape[1]] = img
        windows.append(list(window))
    windows = np.asarray(windows, np.int32)
    transposed = np.asarray([1, 0, 1, 0], np.uint8)
    ref = _np(jaug.crop_resize_batch(jnp.asarray(canvas), jnp.asarray(windows),
                                     jnp.asarray(transposed, jnp.int32), s))
    # the prefetch widens int32 windows to int64
    out = taug.crop_resize_batch(torch.from_numpy(canvas), torch.from_numpy(windows).long(),
                                 torch.from_numpy(transposed), s).numpy()
    assert out.shape == (4, s, s, 3)
    assert np.abs(out - ref).max() <= LEVEL
    assert np.abs(out[0] - _pil_crop_resize(tall, (5, 20, 70, 120), s)).max() <= LEVEL


def test_resample_matrix_matches_jax():
    for args in ((448, 224, 5, 300), (224, 224, 0, 224), (128, 64, 10, 30)):
        ref = _np(jaug.resample_matrix(args[0], args[1], jnp.int32(args[2]), jnp.int32(args[3])))
        out = taug.resample_matrix(args[0], args[1], torch.tensor(args[2]),
                                   torch.tensor(args[3])).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_superpixel_patch_reduce_matches_jax_and_the_host():
    import math
    rng = np.random.default_rng(6)
    s, patch = 64, 8
    seg = rng.integers(0, 40, (80, 120)).astype(np.int32)
    j, i, w, h = 10, 4, 100, 70
    coord = np.array([j / 119, i / 79, (j + w - 1) / 119, (i + h - 1) / 79], np.float32)
    xi0, xi1 = int(coord[0] * 120), math.ceil(coord[2] * 120)
    yi0, yi1 = int(coord[1] * 80), math.ceil(coord[3] * 80)
    canvas = np.zeros((3, 96, 128), np.int32)
    canvas[0, :80, :120] = seg
    canvas[1:] = rng.integers(0, 40, (2, 96, 128))
    windows = np.asarray([[xi0, yi0, xi1 - xi0, yi1 - yi0], [0, 0, 128, 96], [7, 3, 50, 90]],
                         np.int32)
    transposed = np.asarray([0, 1, 0], np.int32)
    ref = _np(jaug.superpixel_patch_reduce_batch(jnp.asarray(canvas), jnp.asarray(windows),
                                                 jnp.asarray(transposed), s, patch))
    out = taug.superpixel_patch_reduce_batch(torch.from_numpy(canvas),
                                             torch.from_numpy(windows).long(),
                                             torch.from_numpy(transposed), s, patch)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out[0].numpy(), crop_seg_from_cache(seg, coord, s, patch))
    np.testing.assert_array_equal(
        taug.superpixel_patch_reduce_one(torch.from_numpy(canvas[2]),
                                         torch.from_numpy(windows[2]), s, patch).numpy(), ref[2])


def _photo_texture(rng, h, w):
    """1/f spectral noise, JPEG-compressed: photographic statistics."""
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.rfftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    chans = []
    for _ in range(3):
        tex = np.fft.irfft2(amp * np.exp(1j * rng.uniform(0, 2 * np.pi, amp.shape)), s=(h, w))
        chans.append((tex - tex.min()) / max(np.ptp(tex), 1e-9))
    buf = io.BytesIO()
    Image.fromarray((np.stack(chans, -1) * 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(224, 224), (32, 48), (2, 2)])
@pytest.mark.parametrize("content", ["random", "photo"])
def test_yuv420_to_rgb_matches_jax(hw, content):
    rng = np.random.default_rng(hw[0] + hw[1])
    h, w = hw
    if content == "random":
        y = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
        cbcr = rng.integers(0, 256, (3, h // 2, w // 2, 2)).astype(np.uint8)
    else:
        img = np.asarray(Image.open(io.BytesIO(_photo_texture(rng, h, w))).convert("RGB"))
        y, cbcr = (a[None] for a in jtf.rgb_to_yuv420(img))
    ref = _np(jaug.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(cbcr)))
    out = taug.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(cbcr))
    assert out.dtype == torch.float32 and out.shape == (y.shape[0], h, w, 3)
    diff = np.abs(out.numpy() - ref)
    assert diff.max() <= YUV_TOL
    # the borders, where the chroma upsample's edge rule acts
    assert max(diff[:, 0].max(), diff[:, -1].max(), diff[:, :, 0].max(),
               diff[:, :, -1].max()) <= YUV_TOL


@pytest.mark.parametrize("hw", [(224, 224), (64, 96), (2, 2)])
def test_rgb_to_yuv420_bit_for_bit(hw):
    arr = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3)).astype(np.uint8)
    for a, b in zip(ttf.rgb_to_yuv420(arr), jtf.rgb_to_yuv420(arr)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wh", [(300, 240), (64, 64), (400, 20), (225, 224)])
@pytest.mark.parametrize("mode", ["YCbCr", "RGB"])
def test_random_resized_crop_yuv420_same_rng(wh, mode):
    """Decoded YCbCr-native (or converted from RGB): the same planes, coord
    and number of rng draws; the crop window is random_resized_crop_coord's."""
    jpeg = _photo_texture(np.random.default_rng(sum(wh)), wh[1], wh[0])
    img = tpipe._decode_jpeg(jpeg, mode)
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = jtf.random_resized_crop_yuv420(img, 48, rj)
        out = ttf.random_resized_crop_yuv420(img, 48, rt)
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert rt.random() == rj.random()
        _, coord = ttf.random_resized_crop_coord(tpipe._decode_jpeg(jpeg), 48,
                                                 np.random.default_rng(seed))
        np.testing.assert_array_equal(out[2], coord)


def _image_bytes(kind):
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    buf = io.BytesIO()
    if kind == "color":
        Image.fromarray(arr).save(buf, "JPEG", quality=85)
    elif kind == "gray":
        Image.fromarray(arr[..., 0]).save(buf, "JPEG", quality=85)
    elif kind == "cmyk":
        Image.fromarray(arr).convert("CMYK").save(buf, "JPEG", quality=85)
    else:
        Image.fromarray(np.dstack([arr, arr[..., :1]]), "RGBA").save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["color", "gray", "cmyk", "rgba-png"])
@pytest.mark.parametrize("mode", ["RGB", "YCbCr"])
def test_decode_jpeg_equals_jax(kind, mode):
    data = _image_bytes(kind)
    ref, out = jpipe._decode_jpeg(data, mode=mode), tpipe._decode_jpeg(data, mode)
    assert out.mode == ref.mode == mode and out.size == ref.size
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# ---------------------------------------------------------------------------
# one float32 step on each transport, against the JAX step
# ---------------------------------------------------------------------------

TINY = ModelConfig(
    image_resolution=32, vision_patch_size=8, vision_width=64,
    vision_layers=2, first_stage_layer=1, group_num=4, cross_layer=1,
    context_length=16, vocab_size=512, transformer_width=64,
    transformer_layers=2, embed_dim=32, max_words=12,
    use_vision_mae_recon=False, use_seglabel=True, compute_dtype="float32")
B = 8


def _port_config(cfg):
    import dataclasses
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(tconfig, type(cfg).__name__)(**{
        k: _port_config(v) if dataclasses.is_dataclass(v) else v for k, v in fields.items()})


def _transport_batch(transport):
    rng = np.random.default_rng(11)
    ids = np.zeros((B, TINY.max_words), np.int32)
    ids[:, 0] = 510
    for i, n in enumerate(rng.integers(2, 8, size=B)):
        ids[i, 1:n] = rng.integers(1, 500, size=n - 1)
        ids[i, n] = 511
    batch = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
             "image_seg": rng.integers(0, 3, (B, 4, 4)).astype(np.int32)}
    if transport == "yuv420":
        batch["image_y"] = rng.integers(0, 256, (B, 32, 32)).astype(np.uint8)
        batch["image_cbcr"] = rng.integers(0, 256, (B, 16, 16, 2)).astype(np.uint8)
    else:
        batch["image"] = rng.integers(0, 256, (B, 32, 64, 3)).astype(np.uint8)
        w = rng.integers(8, 33, size=B)
        h = rng.integers(8, 33, size=B)
        batch["image_window"] = np.stack(
            [rng.integers(0, 64 - w + 1), rng.integers(0, 32 - h + 1), w, h], -1).astype(np.int32)
        batch["image_transposed"] = (np.arange(B) % 2).astype(np.uint8)
    return batch


@pytest.mark.parametrize("transport", ["yuv420", "device_aug"])
def test_train_step_on_the_transport_matches_jax(transport):
    """One float32 step of make_train_step against JAX's single-device step
    on a yuv420 or device_aug batch (RGB rebuilt, or crop-resized, on the
    device inside the step), with the same Gumbel noise."""
    cfg = Config(model=TINY, optim=OptimConfig(lr=1e-3, lower_lr=1e-4),
                 train=TrainConfig(seed=4))
    _, jparams = jax_init_segclip(TINY, seed=3)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    state, tx, trainable = create_train_state(cfg, jparams, t_total=10, seed=4)
    step_fn = make_single_device_train_step(JSegCLIP(TINY), tx, trainable=trainable)
    batch = _transport_batch(transport)
    gumbel = np.random.default_rng(21).gumbel(
        size=(B, TINY.group_num, TINY.num_patches)).astype(np.float32)
    with mock.patch("jax.random.gumbel", lambda key, shape, dtype=jnp.float32:
                    jnp.asarray(gumbel)):
        _, jm = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
    jm = jax.tree_util.tree_map(float, jm)

    pcfg = _port_config(cfg)
    model = SegCLIP(pcfg.model)
    assert load_into(model, state_dict_from_jax(jparams, TINY.vision_patch_size)) == []
    step = make_train_step(model, create_optimizer(model, pcfg, t_total=10), pcfg)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batch.items()}
    tm = {k: float(v) for k, v in step(TrainState(seed=4), tbatch,
                                       {"gumbel": torch.from_numpy(gumbel)}).items()}
    assert set(tm) == set(jm) and np.isfinite(tm["loss"])
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL, err_msg=key)


def test_host_stage_bench_reports_every_stage(tmp_path, capsys):
    """studies.host_stage_bench on a tiny shapes corpus: a time for each
    stage and for the sample() of each transport, printed as its table."""
    from segclip_tpu_torch.cli import prepare_data
    from segclip_tpu_torch.studies import host_stage_bench
    prepare_data.main(["shapes", "--out-dir", str(tmp_path), "--train-n", "4", "--eval-n", "1"])
    out = host_stage_bench.main([str(tmp_path), "4"])
    assert list(out) == ["decode_rgb", "decode_ycbcr", "crop_resize_rgb", "crop_resize_yuv420",
                         "np_rgb_to_yuv420", "seg_decode", "seg_crop", "tokenize",
                         "sample_rgb", "sample_yuv420", "sample_device_aug"]
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert capsys.readouterr().out.count("ms/sample") == len(out)
