"""ViT-B/32 (`--clip-arch ViT-B/32`, CLIP_ARCH_PRESETS: patch 32) in the
port against the JAX package on the CPU, in float32.

At patch 32 a 224-px image is a 7 × 7 grid: the loader's superpixel crop,
device_aug's superpixel reduction, the MAE target (32·32·3 = 3072 values
per patch), the masked forward's 11 kept patches, the superpixel KL and the
segmenter's windows (floored to multiples of 32) all read the patch size.
The model tests keep the preset's 224 px and patch 32 at
tests/test_torch_train.py's tiny widths; one test runs the full-width
ViT-B/32 `encode_image` at B = 2. The loader at patch 32 is in
tests/test_torch_data.py.

  - `cli.train.build_config(--clip-arch ViT-B/32, --opts ...)` equals the
    JAX CLI's config, as tests/test_cli.py builds it;
  - `superpixel_patch_reduce_batch` at 224 / 32 equals JAX's and the
    host's `crop_seg_from_cache`;
  - the patch embedding, `encode_image` (pooled, hidden, soft and hard
    assignment) and `encode_text` within 2e-5 of JAX's, at the tiny
    widths and at full width;
  - one training step's losses (InfoNCE, superpixel KL on the 7 × 7 grid,
    both MAE losses) rtol 1e-5 and every gradient within 1e-5·(1 + max|g|)
    of `jax.value_and_grad` of JAX's `_loss_fn`, the same noise injected;
    two whole steps of `make_train_step` against
    `make_single_device_train_step` (metrics rtol 1e-5, parameters 1e-5);
  - the segmenter's slide and whole logits (2e-5), argmax and group map
    (equal) against JAX's at crop 224, including an image floored to
    multiples of 32 and resized back;
  - `infer_model_config` recovers the ViT-B/32 preset from a patch-32
    state dict in OpenAI's layout and in the segclip layout, as JAX's does;
  - `cli.train --clip-arch ViT-B/32 --device cpu` at tiny widths for one
    epoch on a shapes corpus hands its step the batches JAX's CLI hands
    its own (each package's step factory patched to record them; JAX's
    step is not run), logs the same config and writes the same
    checkpoints; its losses are finite.
"""
import argparse
import ast
import dataclasses
import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu import config as jconfig
from segclip_tpu.checkpoint import torch_convert as jconvert
from segclip_tpu.checkpoint.torch_convert import convert_state_dict
from segclip_tpu.cli import train as jtrain_cli
from segclip_tpu.data import superpixel as jsp
from segclip_tpu.evalseg.inference import ZeroShotSegmenter as JSegmenter
from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
from segclip_tpu.ops import device_aug as jaug
from segclip_tpu.train import loop as jloop
from segclip_tpu.train.step import _loss_fn, create_train_state, make_single_device_train_step

import test_torch_remat as tr
import test_torch_train as tt
from test_torch_convert import openai_layout
from test_torch_loop import TINY_OPTS
from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint import torch_convert as tconvert
from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax
from segclip_tpu_torch.cli import prepare_data
from segclip_tpu_torch.cli import train as train_cli
from segclip_tpu_torch.data import superpixel as tsp
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip
from segclip_tpu_torch.ops import device_aug as taug
from segclip_tpu_torch.train import loop as tloop

torch.set_num_threads(1)
TOL = 2e-5
INIT_SEED = 3
# the preset (224 px, patch 32) at tests/test_torch_remat.py's tiny widths
B32 = jconfig.model_config_for(
    "ViT-B/32", **{f.name: getattr(tr.CONFIGS["tiny"], f.name)
                   for f in dataclasses.fields(tt.TINY)
                   if f.name not in ("image_resolution", "vision_patch_size")})
FULL = jconfig.model_config_for("ViT-B/32", compute_dtype="float32", grouping_impl="jnp")


def _np(x):
    return x.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def jax_params(cfg):
    """The port's seeded init at `cfg` as a JAX parameter tree, through the
    JAX package's own converter."""
    sd = init_segclip(tt.port_config(cfg), seed=INIT_SEED).state_dict()
    return convert_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)


def test_geometry_is_the_presets():
    assert (B32.vision_patch_size, B32.image_resolution, B32.grid_size) == (32, 224, 7)
    assert int((B32.num_patches + 1) * (1 - B32.mae_vis_mask_ratio)) - 1 == 11
    assert dataclasses.asdict(tt.port_config(FULL)) == dataclasses.asdict(
        tconfig.model_config_for("ViT-B/32", compute_dtype="float32", grouping_impl="jnp"))


@pytest.mark.parametrize("opts", [[], ["model.vision_width=128", "optim.b2=0.999"]],
                         ids=["preset", "opts"])
def test_build_config_equals_the_jax_cli(opts):
    """tests/test_cli.py:61-75's arguments at --clip-arch ViT-B/32."""
    args = argparse.Namespace(
        clip_arch="ViT-B/32", use_seglabel=True, use_vision_mae_recon=True,
        use_text_mae_recon=False, max_words=12, first_stage_layer=None, lr=1e-3,
        lower_lr=0.0, warmup_proportion=0.1, weight_decay=0.05, freeze_layer_num=0,
        freeze_text_layer_num=0, datatype="synthetic", batch_size=8, data_dir="",
        num_workers=0, epochs=1, seed=0, grad_accum_steps=1, n_display=1,
        output_dir="/tmp/x", resume_model=None, eval_each_epoch=False, opts=opts)
    want, got = jtrain_cli.build_config(args), train_cli.build_config(args)
    assert got.model.vision_patch_size == 32 and got.model.grid_size == 7
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_superpixel_reduction_at_patch_32_equals_jax_and_the_host():
    import math
    rng = np.random.default_rng(32)
    s, patch = 224, 32
    seg = rng.integers(0, 60, (300, 420)).astype(np.int32)
    j, i, w, h = 30, 12, 380, 250
    coord = np.array([j / 419, i / 299, (j + w - 1) / 419, (i + h - 1) / 299], np.float32)
    xi0, xi1 = int(coord[0] * 420), math.ceil(coord[2] * 420)
    yi0, yi1 = int(coord[1] * 300), math.ceil(coord[3] * 300)
    canvas = np.zeros((3, 320, 448), np.int32)
    canvas[0, :300, :420] = seg
    canvas[1:] = rng.integers(0, 60, (2, 320, 448))
    windows = np.asarray([[xi0, yi0, xi1 - xi0, yi1 - yi0], [0, 0, 448, 320],
                          [17, 5, 200, 310]], np.int32)
    transposed = np.asarray([0, 1, 0], np.int32)
    ref = np.asarray(jaug.superpixel_patch_reduce_batch(jnp.asarray(canvas), jnp.asarray(windows),
                                                 jnp.asarray(transposed), s, patch))
    out = taug.superpixel_patch_reduce_batch(torch.from_numpy(canvas),
                                             torch.from_numpy(windows).long(),
                                             torch.from_numpy(transposed), s, patch)
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 7, 7)
    np.testing.assert_array_equal(out.numpy(), ref)
    host = tsp.crop_seg_from_cache(seg, coord, s, patch)
    np.testing.assert_array_equal(host, jsp.crop_seg_from_cache(seg, coord, s, patch))
    np.testing.assert_array_equal(out[0].numpy(), host)
    np.testing.assert_array_equal(
        taug.superpixel_patch_reduce_one(torch.from_numpy(canvas[2]),
                                         torch.from_numpy(windows[2]), s, patch).numpy(),
        ref[2])


def _encoders_match(cfg, b: int, seed: int, text: bool = True):
    """The patch embedding (against JAX's and a stride-32 convolution),
    `encode_image` and, with `text`, `encode_text` against JAX's."""
    jparams = jax_params(cfg)
    jmodel = JSegCLIP(cfg)
    model = tt.port_model(jparams, cfg).eval()
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, cfg.image_resolution, cfg.image_resolution, 3)).astype(
        np.float32)
    ref = jmodel.apply({"params": jparams}, jnp.asarray(img),
                       method=lambda m, im: m.encode_image(im, training=False))
    ref_patches = jmodel.apply({"params": jparams}, jnp.asarray(img),
                               method=lambda m, im: m.clip.visual._patch_embed(im))
    visual = model.clip.visual
    with torch.no_grad():
        out = model.encode_image(torch.from_numpy(img))
        patches = visual.patch_embed(torch.from_numpy(img))
        conv = torch.nn.functional.conv2d(torch.from_numpy(img).permute(0, 3, 1, 2),
                                          visual.conv1.weight, stride=32)
    assert tuple(patches.shape) == (b, 49, cfg.vision_width)
    np.testing.assert_allclose(_np(patches), np.asarray(ref_patches), atol=TOL)
    np.testing.assert_allclose(_np(patches), _np(conv.flatten(2).transpose(1, 2)), atol=TOL)
    assert tuple(out.mid["hard_attn"].shape) == (b, cfg.group_num, 49)
    np.testing.assert_allclose(_np(out.pooled), np.asarray(ref.pooled), atol=TOL)
    np.testing.assert_allclose(_np(out.hidden), np.asarray(ref.hidden), atol=TOL)
    np.testing.assert_allclose(_np(out.mid["soft_attn"]), np.asarray(ref.mid["soft_attn"]),
                               atol=TOL)
    np.testing.assert_array_equal(_np(out.mid["hard_attn"]),
                                  np.asarray(ref.mid["hard_attn"]).round())
    if text:
        ids = tt.make_batch(seed, b)["input_ids"]
        ref = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                           method=lambda m, t: m.encode_text(t))
        with torch.no_grad():
            out = model.encode_text(torch.from_numpy(ids).long())
        np.testing.assert_allclose(_np(out.pooled), np.asarray(ref.pooled), atol=TOL)


def test_encoders_match_jax():
    _encoders_match(B32, b=3, seed=5)


@pytest.mark.slow
def test_full_width_encode_image_matches_jax():
    """The preset at full width (768 wide, 10 + 2 blocks, 8 groups), B = 2
    (about 30 s on one CPU worker)."""
    _encoders_match(FULL, b=2, seed=6, text=False)


def test_losses_and_gradients_match_jax():
    """Each loss and every gradient against jax.value_and_grad of the JAX
    step's _loss_fn, the same noise (Gumbel over 49 and 11 patches, the
    masking of 50 tokens and of the text)."""
    jparams = jax_params(B32)
    batch, noise = tr.make_batch(B32, 17), tr.make_noise(B32, 18)
    assert noise["gumbel_mae"].shape[-1] == 11 and batch["image_seg"].shape[1:] == (7, 7)
    loss_fn = jax.jit(jax.value_and_grad(
        functools.partial(_loss_fn, model=JSegCLIP(B32), axis_name=None, trainable=None),
        has_aux=True))
    with tt.jax_noise(noise):
        (_, jlosses), jgrads = loss_fn(
            jparams, batch={k: jnp.asarray(v) for k, v in batch.items()},
            rngs={"gumbel": jax.random.key(0), "mae": jax.random.key(1)})
    model = tt.port_model(jparams, B32)
    tb = tt.torch_batch(batch)
    losses = model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                   training=True, noise=tt.torch_noise(noise))
    losses["loss"].backward()
    assert set(losses) == set(jlosses) >= {"vis_mae_loss", "seglabel_loss", "text_mae_loss"}
    for key in jlosses:
        np.testing.assert_allclose(float(losses[key].detach()), float(jlosses[key]),
                                   rtol=tt.LOSS_RTOL, err_msg=key)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), 32)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    assert ref["vis_mae_decoder.decoder_pred.weight"].shape[0] == 32 * 32 * 3
    for n, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        tol = tt.GRAD_TOL * (1 + ref[n].abs().max().item())
        np.testing.assert_allclose(got.numpy(), ref[n].numpy(), atol=tol, rtol=0, err_msg=n)


def test_two_steps_match_the_jax_step():
    """Two whole steps of make_train_step against the JAX package's
    make_single_device_train_step, the same noise: every metric rtol 1e-5,
    the parameters after them within 1e-5."""
    jparams = jax_params(B32)
    batches, noise = [tr.make_batch(B32, 40 + i) for i in range(2)], tr.make_noise(B32, 21)
    state, tx, trainable = create_train_state(tr.train_config(B32), jparams,
                                              t_total=tr.T_TOTAL, seed=tr.SEED)
    step_fn = make_single_device_train_step(JSegCLIP(B32), tx, trainable=trainable)
    jmetrics = []
    with tt.jax_noise(noise):
        for b in batches:
            state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            jmetrics.append(jax.tree_util.tree_map(float, m))
    model, tmetrics, _ = tr.port_steps(B32, jparams, batches, noise)
    for i, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        assert set(jm) == set(tm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), jm[key], rtol=tt.LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params), 32)
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[n].numpy(), atol=tt.PARAM_TOL, rtol=0,
                                   err_msg=n)


@pytest.fixture(scope="module")
def segmenters():
    """JAX and port segmenters at patch 32 on the same weights and bank
    (crop 224, stride 160: overlapping windows)."""
    jparams = jax_params(B32)
    model = tt.port_model(jparams, B32).eval()
    bank = np.random.default_rng(0).normal(size=(5, B32.embed_dim))
    bank = (bank / np.linalg.norm(bank, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(with_bg=True, bg_thresh=0.5, patch_size=32, crop_size=224, stride=160)
    return (JSegmenter(JSegCLIP(B32), jparams, jnp.asarray(bank), **kw),
            ZeroShotSegmenter(model, torch.from_numpy(bank), **kw))


def _image(h, w, seed):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("mode, hw, orig", [("slide", (224, 300), (240, 320)),
                                            ("whole", (300, 500), (300, 500))],
                         ids=["slide", "whole_floored"])
def test_segmenter_matches_jax(segmenters, mode, hw, orig):
    """Logits within 2e-5 and the argmax equal; whole mode floors 300×500
    to 288×480 and resizes back."""
    jseg, seg = segmenters
    img = _image(*hw, seed=sum(hw))
    ref, out = getattr(jseg, mode)(img), getattr(seg, mode)(img)
    assert out.shape == (6,) + hw
    np.testing.assert_allclose(out, ref, atol=TOL)
    pred = seg.predict(img, orig, mode=mode)
    assert pred.shape == orig
    np.testing.assert_array_equal(pred, jseg.predict(img, orig, mode=mode))


def test_group_map_matches_jax(segmenters):
    jseg, seg = segmenters
    img = _image(224, 224, seed=8)
    out = seg.group_map(img)
    assert out.shape == (224, 224) and len(np.unique(out)) > 1
    np.testing.assert_array_equal(out, jseg.group_map(img))


@pytest.mark.parametrize("layout", ["openai", "segclip"])
def test_infer_model_config_recovers_the_preset(layout):
    """From a state dict of the preset's shapes (zero-stride tensors, the
    model built on the meta device) in each layout: the preset, as the JAX
    package infers it."""
    preset = tconfig.model_config_for("ViT-B/32")
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in SegCLIP(preset).state_dict().items()}
    sd = {k: torch.zeros(()).expand(shape) for k, shape in shapes.items()}
    if layout == "openai":
        sd = openai_layout(sd, preset.first_stage_layer)
    want = jconvert.infer_model_config({k: np.broadcast_to(np.float32(0), tuple(v.shape))
                                        for k, v in sd.items()})
    got = tconvert.infer_model_config(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == preset


def test_train_cli_at_vit_b32_hands_its_step_the_jax_batches(tmp_path):
    """`--clip-arch ViT-B/32` at tiny widths, one epoch of a 16-sample
    shapes corpus at B = 8, on the CLI's default transport (yuv420), in
    each package's CLI: the same config, the same batches (7 × 7 superpixel
    grids) in the same order, the same checkpoints; the port's steps run
    and log finite losses."""
    corpus = tmp_path / "shapes"
    prepare_data.main(["shapes", "--out-dir", str(corpus), "--train-n", "8",
                       "--eval-n", "1"])
    argv = ["--clip-arch", "ViT-B/32", "--datatype", "shapes", "--data-dir", str(corpus),
            "--batch-size", "8", "--epochs", "1", "--max-words", "12", "--n-display", "1",
            "--use-seglabel", "--use-vision-mae-recon", "--opts"] + TINY_OPTS + [
            "train.eval_each_epoch=false"]
    seen = {"jax": [], "port": []}

    def jax_factory(mesh, model, tx, **kw):
        def step(state, batch):
            seen["jax"].append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": jnp.float32(1.0)}
        return step

    real = tloop.make_train_step

    def port_factory(model, optimizer, cfg):
        step = real(model, optimizer, cfg)

        def recorded(state, batch, noise=None):
            seen["port"].append({k: v.numpy() for k, v in batch.items()})
            return step(state, batch, noise)
        return recorded

    with mock.patch.object(jloop, "make_sharded_train_step", jax_factory):
        jtrain_cli.main(argv + ["data.packed_transfer=false", "--output-dir",
                                str(tmp_path / "j")])
    with mock.patch.object(tloop, "make_train_step", port_factory):
        result = train_cli.main(argv + ["--device", "cpu", "--output-dir",
                                        str(tmp_path / "t")])
    configs = []
    for side in ("j", "t"):
        line = next(x for x in (tmp_path / side / "log.txt").read_text().splitlines()
                    if "config: " in x)
        configs.append(ast.literal_eval(line.split("config: ", 1)[1]))
    for cfg in configs:
        cfg["train"].pop("output_dir")
        cfg["data"].pop("packed_transfer")
    assert configs[0] == configs[1]
    assert configs[1]["model"]["vision_patch_size"] == 32
    ref, out = seen["jax"], seen["port"]
    assert len(out) == len(ref) == 2
    for a, b in zip(ref, out):
        assert sorted(b) == sorted(a) and a["image_seg"].shape == (8, 7, 7)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    ckpts = [sorted(d for d in os.listdir(tmp_path / side) if d.startswith("ckpt"))
             for side in ("j", "t")]
    assert ckpts[0] == ckpts[1] == ["ckpt_epoch_0"]
    assert result["epochs_run"] == 1 and np.isfinite(result["final_loss"])
