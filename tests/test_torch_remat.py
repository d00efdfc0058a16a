"""Block rematerialisation in the port (ModelConfig.remat,
models/layers.run_blocks) on the CPU, in float32 at tiny widths, with
inputs and noise made by numpy.

  - remat changes no bit: every loss and gradient and the parameters after
    two `make_train_step` steps (vision and text MAE on), and
    `encode_image` / `encode_text` under `no_grad`, equal the step without
    it; at the tiny widths of tests/test_torch_train.py and at a
    ViT-L/14-shaped config (patch 14, a 2/2 split, vision width ≠ text
    width ≠ embed dim);
  - it wraps exactly the stacks JAX wraps: in a training step every module
    of `layers0`, `layers2`, `layers_mae2`, the text `resblocks` and both
    decoders' `decoder_blocks` runs twice as often (the recompute), every
    other module as often as without remat; under `no_grad` nothing runs
    again;
  - the step with remat against the JAX package's with
    `ModelConfig(remat=True)`, the same weights and injected noise, at
    tests/test_torch_train.py's tolerances: each loss and every gradient
    against `jax.value_and_grad` of its `_loss_fn` (rtol 1e-5; per tensor
    within 1e-5·(1 + max|g|)) at both configs, and two whole steps of
    `make_single_device_train_step` (every metric rtol 1e-5, parameters
    1e-5) at the tiny one;
  - `cli.train --device cpu --opts model.remat=true` reaches the model and
    logs the losses of the run without it.

The dp1 × tp2 case with remat is in tests/test_torch_tensor_parallel.py.
"""
import collections
import dataclasses
import functools
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.config import Config, OptimConfig, TrainConfig
from segclip_tpu.checkpoint.torch_convert import convert_state_dict
from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
from segclip_tpu.train.step import (_loss_fn, create_train_state,
                                    make_single_device_train_step)

import test_torch_train as tt
from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax
from segclip_tpu_torch.cli import train as train_cli
from segclip_tpu_torch.models import layers
from segclip_tpu_torch.models.segclip import init_segclip
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

torch.set_num_threads(1)
B, T_TOTAL, SEED, INIT_SEED = 4, 100, 4, 3
CONFIGS = {
    # tests/test_torch_train.py's widths, one block less per stack (each
    # JAX compile costs seconds per block)
    "tiny": dataclasses.replace(tt.TINY, vision_layers=3, first_stage_layer=2,
                                transformer_layers=1),
    # ViT-L/14's shape, cut: patch 14, the blocks split 2 + 2, 64-dim heads,
    # vision 192 (3 heads) ≠ text 128 (2 heads) ≠ embed 96
    "vit_l14_shape": dataclasses.replace(
        tt.TINY, image_resolution=56, vision_patch_size=14, vision_width=192,
        vision_layers=4, first_stage_layer=2, transformer_width=128,
        transformer_layers=1, embed_dim=96),
}
# the stacks JAX puts under nn.remat (seg_vit.py:191, clip.py:147,
# mae_decoder.py:99), by the port's module names
REMAT_STACKS = ("clip.visual.transformer.layers0.", "clip.visual.transformer.layers2.",
                "clip.visual.transformer.layers_mae2.", "clip.transformer.resblocks.",
                "vis_mae_decoder.decoder_blocks.", "seq_mae_decoder.decoder_blocks.")


def make_batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, cfg.max_words), np.int32)
    ids[:, 0] = 510
    for i, n in enumerate(rng.integers(2, 8, size=B)):
        ids[i, 1:n] = rng.integers(1, 500, size=n - 1)
        ids[i, n] = 511
    res, grid = cfg.image_resolution, cfg.grid_size
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "image": (rng.normal(size=(B, res, res, 3)) * 0.4).astype(np.float32),
            "image_seg": rng.integers(0, 4, size=(B, grid, grid)).astype(np.int32)}


def make_noise(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    g, l = cfg.group_num, cfg.num_patches
    kept = int((l + 1) * (1 - cfg.mae_vis_mask_ratio)) - 1
    return {"gumbel": rng.gumbel(size=(B, g, l)).astype(np.float32),
            "gumbel_mae": rng.gumbel(size=(B, g, kept)).astype(np.float32),
            "mask_vis": rng.random((B, l + 1)).astype(np.float32),
            "mask_txt": rng.random((B, cfg.max_words)).astype(np.float32)}


def train_config(cfg) -> Config:
    return Config(model=cfg, optim=OptimConfig(lr=1e-3, lower_lr=1e-4),
                  train=TrainConfig(seed=SEED))


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    """The port's seeded init as a JAX parameter tree, through the JAX
    package's own converter (a JAX init compiles for seconds)."""
    cfg = CONFIGS[name]
    sd = init_segclip(tt.port_config(cfg), seed=INIT_SEED).state_dict()
    return convert_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)


def port_steps(cfg, jparams, batches, noise=None):
    """make_train_step over `batches` from the JAX init's weights: (the
    model, each step's metrics, the last step's gradients)."""
    tcfg = tt.port_config(train_config(cfg))
    model = tt.port_model(jparams, cfg)
    step = make_train_step(model, create_optimizer(model, tcfg, t_total=T_TOTAL), tcfg)
    state = TrainState(step=0, seed=SEED)
    tnoise = None if noise is None else tt.torch_noise(noise)
    metrics = [step(state, tt.torch_batch(b), tnoise) for b in batches]
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return model, metrics, grads


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_changes_no_bit_of_the_step_or_the_encoders(name):
    cfg = CONFIGS[name]
    jparams = jax_params(name)
    batches = [make_batch(cfg, 30 + i) for i in range(2)]
    plain = port_steps(cfg, jparams, batches)
    with mock.patch.object(layers, "checkpoint", wraps=layers.checkpoint) as ckpt:
        remat = port_steps(dataclasses.replace(cfg, remat=True), jparams, batches)
        # per step, each block of a stack: the image and the masked image
        # through the vision stacks, the text and the masked text, both decoders
        blocks = 2 * (cfg.vision_layers + cfg.transformer_layers + cfg.mae_decoder_depth)
        assert ckpt.call_count == 2 * blocks
        ckpt.reset_mock()
        tb = tt.torch_batch(batches[0])
        with torch.no_grad():
            enc = [(m.encode_image(tb["image"]), m.encode_text(tb["input_ids"]))
                   for m in (plain[0], remat[0])]
        assert ckpt.call_count == 0
    for i, (a, b) in enumerate(zip(plain[1], remat[1])):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), f"step {i} {key}"
    assert plain[2].keys() == remat[2].keys()
    for n, g in plain[2].items():
        assert torch.equal(g, remat[2][n]), n
    for (n, p), q in zip(plain[0].state_dict().items(), remat[0].state_dict().values()):
        assert torch.equal(p, q), n
    (img_a, txt_a), (img_b, txt_b) = enc
    for x, y in ((img_a.pooled, img_b.pooled), (img_a.hidden, img_b.hidden),
                 (img_a.mid["hard_attn"], img_b.mid["hard_attn"]),
                 (txt_a.pooled, txt_b.pooled), (txt_a.hidden, txt_b.hidden)):
        assert torch.equal(x, y)


def _module_calls(model, fn) -> collections.Counter:
    """How often each named submodule of `model` is called while fn runs."""
    calls = collections.Counter()
    handles = [m.register_forward_pre_hook(lambda *_, name=name: calls.update([name]))
               for name, m in model.named_modules() if name]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return calls


def test_remat_wraps_exactly_the_jax_stacks_and_only_under_grad():
    """A training forward and backward: the remat stacks' modules run once
    more (the recompute), no other module does; under no_grad none does."""
    cfg = CONFIGS["tiny"]
    tb = tt.torch_batch(make_batch(cfg, 7))
    noise = tt.torch_noise(make_noise(cfg, 8))
    counts = []
    for remat in (False, True):
        model = tt.port_model(jax_params("tiny"), dataclasses.replace(cfg, remat=remat))

        def train():
            model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                  training=True, noise=noise)["loss"].backward()

        def evaluate():
            with torch.no_grad():
                model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                      training=False)
        counts.append((_module_calls(model, train), _module_calls(model, evaluate)))
    (train_plain, eval_plain), (train_remat, eval_remat) = counts
    assert train_plain.keys() == train_remat.keys() and eval_plain == eval_remat
    wrapped = {n for n in train_plain if n.startswith(REMAT_STACKS)}
    for stack in REMAT_STACKS:
        assert any(n.startswith(stack) for n in wrapped), stack
    for name, n in train_plain.items():
        want = 2 * n if name in wrapped else n
        assert train_remat[name] == want, (name, n, train_remat[name])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_losses_and_gradients_match_jax_remat(name):
    """Each loss and every gradient against jax.value_and_grad of the JAX
    step's _loss_fn, both sides at remat=True with the same noise."""
    cfg = dataclasses.replace(CONFIGS[name], remat=True)
    jparams = jax_params(name)
    batch, noise = make_batch(cfg, 17), make_noise(cfg, 18)
    loss_fn = jax.jit(jax.value_and_grad(
        functools.partial(_loss_fn, model=JSegCLIP(cfg), axis_name=None, trainable=None),
        has_aux=True))
    with tt.jax_noise(noise):
        (_, jlosses), jgrads = loss_fn(
            jparams, batch={k: jnp.asarray(v) for k, v in batch.items()},
            rngs={"gumbel": jax.random.key(0), "mae": jax.random.key(1)})
    model = tt.port_model(jparams, cfg)
    tb = tt.torch_batch(batch)
    losses = model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                   training=True, noise=tt.torch_noise(noise))
    losses["loss"].backward()
    assert set(losses) == set(jlosses)
    for key in jlosses:
        np.testing.assert_allclose(float(losses[key].detach()), float(jlosses[key]),
                                   rtol=tt.LOSS_RTOL, err_msg=key)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              cfg.vision_patch_size)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        tol = tt.GRAD_TOL * (1 + ref[n].abs().max().item())
        np.testing.assert_allclose(got.numpy(), ref[n].numpy(), atol=tol, rtol=0, err_msg=n)


def test_remat_steps_match_the_jax_remat_step():
    """Two whole steps of make_train_step against the JAX package's
    make_single_device_train_step, both at remat=True, the same noise:
    every metric rtol 1e-5, the parameters after them within 1e-5."""
    cfg = dataclasses.replace(CONFIGS["tiny"], remat=True)
    jparams = jax_params("tiny")
    batches, noise = [make_batch(cfg, 40 + i) for i in range(2)], make_noise(cfg, 21)
    state, tx, trainable = create_train_state(train_config(cfg), jparams, t_total=T_TOTAL,
                                              seed=SEED)
    step_fn = make_single_device_train_step(JSegCLIP(cfg), tx, trainable=trainable)
    jmetrics = []
    with tt.jax_noise(noise):
        for b in batches:
            state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            jmetrics.append(jax.tree_util.tree_map(float, m))
    model, tmetrics, _ = port_steps(cfg, jparams, batches, noise)
    for i, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        assert set(jm) == set(tm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), jm[key], rtol=tt.LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                                cfg.vision_patch_size)
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[n].numpy(), atol=tt.PARAM_TOL, rtol=0,
                                   err_msg=n)


def test_train_cli_remat_reaches_the_model_and_logs_the_same_losses(tmp_path):
    """`--opts model.remat=true` puts the stacks under checkpointing in the
    CLI's run, and its losses are those of the run without it."""
    argv = ["--device", "cpu", "--datatype", "synthetic", "--batch-size", "256",
            "--epochs", "1", "--max-words", "12", "--n-display", "1",
            "--use-seglabel", "--use-vision-mae-recon", "--opts",
            "model.image_resolution=32", "model.vision_patch_size=8",
            "model.vision_width=64", "model.vision_layers=4", "model.first_stage_layer=3",
            "model.group_num=4", "model.cross_layer=1", "model.transformer_width=64",
            "model.transformer_layers=2", "model.embed_dim=32",
            "model.mae_decoder_depth=1", "model.mae_decoder_num_heads=2",
            "model.compute_dtype=float32", "train.eval_each_epoch=false"]
    runs = {}
    for remat in ("false", "true"):
        out = tmp_path / remat
        with mock.patch.object(layers, "checkpoint", wraps=layers.checkpoint) as ckpt:
            train_cli.main(argv + [f"model.remat={remat}", "--output-dir", str(out)])
        with open(out / "metrics.jsonl") as f:
            runs[remat] = ([json.loads(line) for line in f], ckpt.call_count)
    (plain, plain_calls), (remat, remat_calls) = runs["false"], runs["true"]
    # 512 synthetic samples: 2 steps, each through 4 + 4 vision, 2 text and
    # 1 decoder block
    assert plain_calls == 0 and remat_calls == 2 * (2 * 4 + 2 + 1)
    assert len(plain) == 2 and all(np.isfinite(m["loss"]) for m in plain)
    assert [{k: v for k, v in m.items() if k != "time"} for m in plain] == \
        [{k: v for k, v in m.items() if k != "time"} for m in remat]
