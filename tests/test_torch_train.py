"""The PyTorch port's training slice against the JAX package on the CPU, at
the tiny widths of tests/test_training_drift.py in float32, with inputs and
noise made by numpy and handed to both frameworks.

On the CPU the kernel wrappers take their plain versions, so these tests
hold the oracles of the CUDA kernels, and everything around them, to JAX.
The JAX side draws its Gumbel and masking noise from patched
`jax.random.gumbel` and `random_masking`, by shape, as
tests/test_golden_replay.py does.

Tolerances: losses rtol 1e-5; gradients, per tensor, within
1e-5·(1 + max|g|); AdaptAdamW 1e-6 after 6 steps; three whole steps: the
loss trajectory rtol 1e-5 and the final parameters within 1e-5 (only the
order of fp32 sums differs). The golden pack's total loss at its
docs/PARITY.md bound, rtol 2e-4.
"""
import contextlib
import dataclasses
import functools
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.config import Config, ModelConfig, OptimConfig, TrainConfig
from segclip_tpu.models import clip as jclip
from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
from segclip_tpu.ops import masking as jmasking
from segclip_tpu.train import optimizer as joptim
from segclip_tpu.train.param_groups import flat_paths, lr_wd_trees, trainable_tree
from segclip_tpu.train.step import (_loss_fn, create_train_state,
                                    make_single_device_train_step)

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint.convert import load_into, state_dict_from_jax
from segclip_tpu_torch.models.segclip import SegCLIP
from segclip_tpu_torch.parallel import collectives
from segclip_tpu_torch.train.optimizer import AdaptAdamW, global_norm_clip
from segclip_tpu_torch.train.param_groups import (freeze, group_lrs, group_of,
                                                  is_no_decay, param_groups)
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_reference.npz")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5

TINY = ModelConfig(
    image_resolution=32, vision_patch_size=8, vision_width=64,
    vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
    context_length=16, vocab_size=512, transformer_width=64,
    transformer_layers=2, embed_dim=32, max_words=12,
    use_vision_mae_recon=True, use_text_mae_recon=True, use_seglabel=True,
    mae_decoder_depth=1, mae_decoder_num_heads=2, compute_dtype="float32",
    grouping_impl="jnp")
B = 4
KEPT = int((TINY.num_patches + 1) * (1 - TINY.mae_vis_mask_ratio)) - 1


def _np(x):
    return x.detach().cpu().numpy()


def port_config(cfg):
    """The port's config dataclass (segclip_tpu_torch/config.py) with the
    fields of a JAX package config, nested configs included."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(tconfig, type(cfg).__name__)(**{
        k: port_config(v) if dataclasses.is_dataclass(v) else v
        for k, v in fields.items()})


def make_batch(seed: int, b: int = B, uint8: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, TINY.max_words), np.int32)
    ids[:, 0] = 510
    for i, n in enumerate(rng.integers(2, 8, size=b)):
        ids[i, 1:n] = rng.integers(1, 500, size=n - 1)
        ids[i, n] = 511
    image = (rng.integers(0, 256, size=(b, 32, 32, 3), dtype=np.uint8) if uint8
             else (rng.normal(size=(b, 32, 32, 3)) * 0.4).astype(np.float32))
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "image": image,
            "image_seg": rng.integers(0, 4, size=(b, 4, 4)).astype(np.int32)}


def make_noise(seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    g, l = TINY.group_num, TINY.num_patches
    return {"gumbel": rng.gumbel(size=(b, g, l)).astype(np.float32),
            "gumbel_mae": rng.gumbel(size=(b, g, KEPT)).astype(np.float32),
            "mask_vis": rng.random((b, l + 1)).astype(np.float32),
            "mask_txt": rng.random((b, TINY.max_words)).astype(np.float32)}


@contextlib.contextmanager
def jax_noise(noise: dict):
    """JAX draws `noise` instead of its PRNG streams, matched by shape."""
    masks = {noise[k].shape: noise[k] for k in ("mask_vis", "mask_txt")}
    gumbels = {noise[k].shape: noise[k] for k in ("gumbel", "gumbel_mae")}
    assert len(masks) == 2 and len(gumbels) == 2, "noise shapes must differ"
    orig = jmasking.random_masking

    def masking(x, ratio, key=None, **kw):
        kw.pop("noise", None)
        return orig(x, ratio, noise=jnp.asarray(masks[tuple(x.shape[:2])]), **kw)

    def gumbel(key, shape, dtype=jnp.float32):
        return jnp.asarray(gumbels[tuple(shape)])

    with mock.patch.object(jclip, "random_masking", masking), \
            mock.patch("jax.random.gumbel", gumbel):
        yield


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("input_ids", "attention_mask", "image_seg", "text_class", "scene_classes"):
        if k in out:
            out[k] = out[k].long()
    return out


def torch_noise(noise: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in noise.items()}


@pytest.fixture(scope="module")
def jax_init():
    jmodel, jparams = jax_init_segclip(TINY, seed=3)
    return jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def port_model(jparams, cfg: ModelConfig = TINY) -> SegCLIP:
    model = SegCLIP(port_config(cfg))
    assert load_into(model, state_dict_from_jax(jparams, cfg.vision_patch_size)) == []
    return model


def test_golden_pack_training_loss():
    """The torch reference's recorded pretraining loss (all four losses,
    text MAE included), with zero Gumbel noise and the pack's masking
    noise."""
    pack = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(pack[k]) for k in pack.files if k.startswith("sd/")}
    inp = {k[3:]: pack[k] for k in pack.files if k.startswith("in/")}
    cfg = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64,
                      vision_layers=12, first_stage_layer=3, group_num=8,
                      cross_layer=2, context_length=16, vocab_size=512,
                      transformer_width=64, transformer_layers=2, embed_dim=32,
                      max_words=16, use_text_mae_recon=True, mae_seq_mask_ratio=0.25,
                      mae_decoder_depth=3, mae_decoder_num_heads=8,
                      compute_dtype="float32")
    model = SegCLIP(port_config(cfg))
    assert load_into(model, sd) == ["seq_mae_decoder.decoder_pos_embed",
                                    "vis_mae_decoder.decoder_pos_embed"]
    b, kept = inp["img"].shape[0], int(17 * 0.25) - 1
    noise = {"gumbel": torch.zeros(b, 8, 16), "gumbel_mae": torch.zeros(b, 8, kept),
             "mask_txt": torch.from_numpy(inp["noise_txt"]),
             "mask_vis": torch.from_numpy(inp["noise_vis"])}
    with torch.no_grad():
        losses = model(torch.from_numpy(inp["ids"]).long(),
                       torch.from_numpy(inp["attn_mask"]).long(),
                       torch.from_numpy(inp["img"]), torch.from_numpy(inp["seg"]).long(),
                       training=True, noise=noise)
    assert set(losses) == {"sim_loss", "seglabel_loss", "text_mae_loss",
                           "vis_mae_loss", "loss"}
    np.testing.assert_allclose(float(losses["loss"]), float(pack["out/total_loss"]),
                               rtol=2e-4)


@pytest.mark.parametrize("variant", ["default", "class_mask_and_balance"])
def test_losses_and_gradients_match_jax(jax_init, variant):
    """Each loss and every parameter's gradient against
    jax.value_and_grad of the JAX step's _loss_fn, same noise."""
    _, jparams = jax_init
    cfg = TINY
    batch = make_batch(17)
    if variant != "default":
        cfg = dataclasses.replace(TINY, infonce_mask="class", group_balance_weight=0.1)
        batch["text_class"] = np.array([1, 0, 2, 1], np.int32)
        batch["scene_classes"] = np.array([0b011, 0b001, 0b110, 0b101], np.int32)
    noise = make_noise(18)
    loss_fn = jax.jit(jax.value_and_grad(
        functools.partial(_loss_fn, model=JSegCLIP(cfg), axis_name=None, trainable=None),
        has_aux=True))
    with jax_noise(noise):
        (_, jlosses), jgrads = loss_fn(
            jparams, batch={k: jnp.asarray(v) for k, v in batch.items()},
            rngs={"gumbel": jax.random.key(0), "mae": jax.random.key(1)})

    model = port_model(jparams, cfg)
    tb = torch_batch(batch)
    losses = model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                   training=True, text_class=tb.get("text_class"),
                   scene_classes=tb.get("scene_classes"), noise=torch_noise(noise))
    losses["loss"].backward()
    assert set(losses) == set(jlosses)
    for key in jlosses:
        np.testing.assert_allclose(float(losses[key].detach()), float(jlosses[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              cfg.vision_patch_size)
    names = dict(model.named_parameters())
    assert set(names) == set(ref)
    for name, p in names.items():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        tol = GRAD_TOL * (1 + ref[name].abs().max().item())
        np.testing.assert_allclose(_np(got), _np(ref[name]), atol=tol, rtol=0,
                                   err_msg=name)


def test_class_mask_raises_on_missing_or_overflowing_classes(jax_init):
    model = port_model(jax_init[1], dataclasses.replace(TINY, infonce_mask="class"))
    tb = torch_batch(make_batch(17))
    args = (tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"])
    noise = torch_noise(make_noise(18))
    with pytest.raises(ValueError, match="scene_classes"):
        model(*args, text_class=torch.ones(B, dtype=torch.long), noise=noise)
    with pytest.raises(ValueError, match="31"):
        model(*args, text_class=torch.tensor([1, 32, 0, 2]),
              scene_classes=torch.ones(B, dtype=torch.long), noise=noise)
    with pytest.raises(ValueError, match="bitmask"):
        model(*args, text_class=torch.ones(B, dtype=torch.long),
              scene_classes=torch.tensor([1, 2 ** 31, 0, 2]), noise=noise)


def test_adapt_adamw_matches_jax_transform():
    """6 steps, 2 groups (lr, wd) and a frozen leaf, against the JAX
    transform on the same gradients."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "f": (3,)}
    lrs, wds = {"a": 1e-2, "b": 1e-4, "f": 1e-2}, {"a": 0.05, "b": 0.0, "f": 0.05}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = joptim.adapt_adamw(lr_tree=lrs, wd_tree=wds,
                            trainable_tree={"a": True, "b": True, "f": False},
                            t_total=20, warmup=0.15, b1=0.9, b2=0.98, eps=1e-6)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    tp["f"].requires_grad_(False)
    opt = AdaptAdamW([{"params": [tp["a"]], "lr": lrs["a"], "weight_decay": wds["a"]},
                      {"params": [tp["b"]], "lr": lrs["b"], "weight_decay": wds["b"]}],
                     t_total=20, warmup=0.15, b1=0.9, b2=0.98, eps=1e-6)
    for _ in range(6):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, st = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, st, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k in ("a", "b"):
            tp[k].grad = torch.from_numpy(grads[k])
        opt.step()
    assert opt.step_count == int(st.step) == 6
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(tp["f"]), init["f"])


def test_global_norm_clip_matches_jax():
    rng = np.random.default_rng(4)
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("a", (4, 5)), ("b", (7,)))}
    for max_norm in (1.0, 100.0):
        clipped, norm = joptim.global_norm_clip(
            {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
        params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in grads.values()]
        for p, v in zip(params, grads.values()):
            p.grad = torch.from_numpy(v.copy())
        tnorm = global_norm_clip(params, max_norm)
        np.testing.assert_allclose(float(tnorm), float(norm), rtol=1e-6)
        for p, k in zip(params, grads):
            np.testing.assert_allclose(_np(p.grad), np.asarray(clipped[k]), rtol=1e-6)


def _torch_to_jax_paths(jparams) -> dict:
    """Port parameter name → JAX param path, through export_state_dict on a
    tree whose leaf i is filled with i."""
    paths = [p for p, _ in flat_paths(jparams)]
    ids = {}
    for i, (path, leaf) in enumerate(flat_paths(jparams)):
        node = ids
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.full(np.shape(leaf), i, np.float32)
    return {name: paths[int(np.asarray(arr).flat[0])]
            for name, arr in export_state_dict(ids, TINY.vision_patch_size).items()}


def _tree_get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("freeze_layer_num, freeze_text_layer_num",
                         [(0, 0), (-1, 0), (11, 0), (0, 2)])
def test_param_groups_match_jax(jax_init, freeze_layer_num, freeze_text_layer_num):
    """Per parameter: peak lr, weight decay and trainable equal JAX's
    lr_wd_trees / trainable_tree, names mapped through export_state_dict."""
    _, jparams = jax_init
    ocfg = OptimConfig(lr=4e-3, lower_lr=4e-6, lower_text_lr=1e-6,
                       freeze_layer_num=freeze_layer_num,
                       freeze_text_layer_num=freeze_text_layer_num)
    lr_tree, wd_tree = lr_wd_trees(jparams, ocfg)
    trainable = trainable_tree(jparams, ocfg, first_stage_layer=TINY.first_stage_layer)
    model = SegCLIP(port_config(TINY))
    tcfg = port_config(ocfg)
    frozen = set(freeze(model, tcfg, first_stage_layer=TINY.first_stage_layer))
    groups = {n: (g["lr"], g["weight_decay"])
              for g in param_groups(model, tcfg) for n in g["param_names"]}
    to_jax = _torch_to_jax_paths(jparams)
    assert set(to_jax) == {n for n, _ in model.named_parameters()}
    lrs = group_lrs(tcfg)
    for name, p in model.named_parameters():
        path = to_jax[name]
        assert p.requires_grad == bool(_tree_get(trainable, path)), name
        assert (name in frozen) != p.requires_grad, name
        expected = (_tree_get(lr_tree, path), _tree_get(wd_tree, path))
        assert (lrs[group_of(name)], 0.0 if is_no_decay(name) else ocfg.weight_decay) \
            == expected, name
        if p.requires_grad:
            assert groups[name] == expected, name


TRAIN_CFG = Config(model=TINY, optim=OptimConfig(lr=1e-3, lower_lr=1e-4),
                   train=TrainConfig(seed=4))
T_TOTAL = 100
STEP_NOISE = make_noise(21)


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX train step (its noise patched in at the first call,
    the trace) for every scenario of the same shapes."""
    jmodel = JSegCLIP(TINY)
    _, tx, trainable = create_train_state(TRAIN_CFG, jax_init_segclip(TINY, seed=3)[1],
                                          t_total=T_TOTAL, seed=4)
    return make_single_device_train_step(jmodel, tx, trainable=trainable), tx


def _run_both(jparams, batches, step_fn, accum: int = 1):
    """The same batches through the JAX step and the port's; returns both
    metric lists, the JAX state and the port's model and optimizer."""
    state, _, _ = create_train_state(TRAIN_CFG, jparams, t_total=T_TOTAL, seed=4)
    noise = STEP_NOISE if accum == 1 else make_noise(21, b=B // accum)
    jmetrics = []
    with jax_noise(noise):
        for batch in batches:
            state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
            jmetrics.append(jax.tree_util.tree_map(float, m))
    cfg = port_config(dataclasses.replace(
        TRAIN_CFG, train=TrainConfig(seed=4, grad_accum_steps=accum)))
    model = port_model(jax.tree_util.tree_map(np.asarray, jparams))
    optimizer = create_optimizer(model, cfg, t_total=T_TOTAL)
    step = make_train_step(model, optimizer, cfg)
    tstate = TrainState(step=0, seed=4)
    tmetrics = [{k: float(v) for k, v in step(tstate, torch_batch(batch),
                                             torch_noise(noise)).items()}
                for batch in batches]
    assert tstate.step == int(state.step) == len(batches)
    return jmetrics, tmetrics, state, model, optimizer


def _assert_same_run(jmetrics, tmetrics, state, model, optimizer):
    for i, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        assert set(jm) == set(tm)
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert optimizer.step_count == int(state.opt_state.step)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                              TINY.vision_patch_size)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(_np(p), _np(ref[name]), atol=PARAM_TOL, rtol=0,
                                   err_msg=name)


def _float_images(batch):
    from segclip_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    img = (batch["image"].astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN)) \
        / np.asarray(CLIP_STD)
    return {**batch, "image": img.astype(np.float32)}


@pytest.mark.parametrize("scenario", ["three_steps", "clamp_nan_skip"])
def test_train_steps_match_jax(jax_init, jax_step, scenario):
    """Three whole steps of make_train_step against JAX's single-device
    step: uint8 batches normalised on the device, the same noise each step.
    clamp_nan_skip starts logit_scale above ln 100 (step 1 clamps it) and
    feeds a NaN image at step 2 (skipped: no parameter, moment or schedule
    change; the state's step still advances)."""
    _, jparams = jax_init
    batches = [make_batch(30 + i, uint8=True) for i in range(3)]
    if scenario == "clamp_nan_skip":
        jparams = jax.tree_util.tree_map(lambda x: x, jparams)
        jparams["clip"]["logit_scale"] = np.float32(4.7)
        batches = [_float_images(b) for b in batches]
        batches[1]["image"] = np.full_like(batches[1]["image"], np.nan)
    jm, tm, state, model, optimizer = _run_both(jparams, batches, jax_step[0])
    _assert_same_run(jm, tm, state, model, optimizer)
    skipped = [m["skipped_nan"] for m in tm]
    if scenario == "clamp_nan_skip":
        assert skipped == [0.0, 1.0, 0.0] and optimizer.step_count == 2
        # clamped from 4.7 at step 1; step 3 moved it by one small update
        assert 0 <= math.log(100.0) - float(model.clip.logit_scale.detach()) < 1e-4
    else:
        assert skipped == [0.0, 0.0, 0.0]


def test_grad_accumulation_matches_jax(jax_init):
    """grad_accum_steps=2: two micro-batches of 2, gradients averaged."""
    _, jparams = jax_init
    _, tx, trainable = create_train_state(TRAIN_CFG, jparams, t_total=T_TOTAL, seed=4)
    step_fn = make_single_device_train_step(JSegCLIP(TINY), tx, trainable=trainable,
                                            grad_accum_steps=2)
    batches = [make_batch(40 + i, uint8=True) for i in range(2)]
    _assert_same_run(*_run_both(jparams, batches, step_fn, accum=2))


def test_collectives_are_the_identity_at_world_size_one(monkeypatch):
    """At world size 1 the gather is the identity and the rank 0; at a
    larger world (tests/test_torch_parallel.py runs one) it places this
    rank's rows in a (world·B, …) buffer and its backward keeps them."""
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.global_gather(x) is x and collectives.rank_of() == 0
    monkeypatch.setattr(collectives, "data_size", lambda: 2)
    leaf = x.clone().requires_grad_()
    gathered = collectives.global_gather(leaf)
    assert gathered.shape == (6, 2) and torch.equal(gathered[:3], x)
    assert torch.equal(gathered[3:], torch.zeros(3, 2))
    (gathered * torch.arange(12.0).reshape(6, 2)).sum().backward()
    assert torch.equal(leaf.grad, torch.arange(6.0).reshape(3, 2))


def test_load_into_checks_the_fixed_position_tables(jax_init):
    model = SegCLIP(port_config(TINY))
    sd = state_dict_from_jax(jax_init[1], TINY.vision_patch_size)
    table = model.vis_mae_decoder.pos_table.clone()[None]
    assert load_into(model, {**sd, "vis_mae_decoder.decoder_pos_embed": table}) == \
        ["vis_mae_decoder.decoder_pos_embed"]
    with pytest.raises(ValueError, match="fixed table"):
        load_into(model, {**sd, "vis_mae_decoder.decoder_pos_embed": table + 0.1})
