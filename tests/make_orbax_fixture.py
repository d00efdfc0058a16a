"""Writes tests/fixtures/orbax/: Orbax directories written by the JAX
package's own `save_params` / `save_checkpoint`, with what the JAX package
computed from them on the CPU, for the port to read without JAX
(tests/test_torch_orbax.py on the CPU, chip_smoke.py's phase 15 on the card).

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py [out_dir]

The model is SegCLIP at the golden pack's widths (64, resolution 32, patch
8, context 16) with each stack one block deep and no MAE decoder, the least
depth the model takes, so that the directories stay small (random float32
weights do not compress). Written:

  params/           save_params of the seeded init (seed 3), in two
                    processes' worth of devices: the token embedding sharded
                    over two, so its zarr array has two chunks; zstd as orbax
                    writes it
  ckpt_epoch_1/     save_checkpoint after two float32 training steps (bf16
                    Adam moments), every Gumbel draw injected from GUMBEL
  fixture.json      the config, the optimizer, the SHA-256 of every leaf's
                    bytes (C order; bf16 as its bits), the steps' losses and
                    the next step's (the third, from ckpt_epoch_1), the
                    orbax and tensorstore versions
  fixture.npz       the batch, the Gumbel draw, one seeded image, the text
                    bank, and the JAX segmenter's whole-image logits and
                    group map on that image at float32 and bfloat16, from
                    params/
"""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "fixtures", "orbax")
MODEL = dict(image_resolution=32, vision_patch_size=8, vision_width=64, vision_layers=2,
             first_stage_layer=1, group_num=4, cross_layer=1, context_length=16,
             vocab_size=64, transformer_width=64, transformer_layers=1, embed_dim=32,
             max_words=12, use_seglabel=True, use_vision_mae_recon=False,
             use_text_mae_recon=False, compute_dtype="float32")
OPTIM = dict(lr=1e-3, lower_lr=1e-4, moment_dtype="bfloat16")
T_TOTAL, INIT_SEED, TRAIN_SEED, B = 100, 3, 4, 8
IMAGE_HW = (40, 56)
CLASSES = 5
SEGMENTER = dict(with_bg=True, bg_thresh=0.5, patch_size=8, crop_size=32, stride=24)
SHARDED = ("clip", "token_embedding", "embedding")


def batch_and_noise() -> tuple:
    """The training batch and the one Gumbel draw of every step, seeded."""
    rng = np.random.default_rng(23)
    v, w = MODEL["vocab_size"], MODEL["max_words"]
    ids = np.zeros((B, w), np.int32)
    ids[:, 0] = v - 2
    for i, n in enumerate(rng.integers(2, w - 1, size=B)):
        ids[i, 1:n] = rng.integers(1, v - 2, size=n - 1)
        ids[i, n] = v - 1
    g = MODEL["image_resolution"] // MODEL["vision_patch_size"]
    batch = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
             "image": (rng.normal(size=(B, 32, 32, 3)) * 0.4).astype(np.float32),
             "image_seg": rng.integers(0, 4, size=(B, g, g)).astype(np.int32)}
    gumbel = rng.gumbel(size=(B, MODEL["group_num"], g * g)).astype(np.float32)
    return batch, gumbel


def image_and_bank() -> tuple:
    rng = np.random.default_rng(29)
    image = rng.normal(size=IMAGE_HW + (3,)).astype(np.float32)
    bank = rng.normal(size=(CLASSES, MODEL["embed_dim"]))
    bank = (bank / np.linalg.norm(bank, axis=-1, keepdims=True)).astype(np.float32)
    return image, bank


def leaf_sha256(tree: dict, prefix: tuple = ()) -> dict:
    """{dotted name: SHA-256 of the leaf's C-order bytes}."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(leaf_sha256(tree[k], prefix + (k,)))
        else:
            leaf = np.ascontiguousarray(np.asarray(tree[k]))
            out[".".join(prefix + (k,))] = hashlib.sha256(leaf.tobytes()).hexdigest()
    return out


def generate(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from importlib.metadata import version
    from unittest import mock
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from segclip_tpu.checkpoint.orbax_io import save_checkpoint, save_params
    from segclip_tpu.config import Config, ModelConfig, OptimConfig
    from segclip_tpu.evalseg.inference import ZeroShotSegmenter
    from segclip_tpu.models.segclip import init_segclip
    from segclip_tpu.train.step import create_train_state, make_single_device_train_step

    if len(jax.devices()) < 2:
        raise SystemExit("needs two devices: XLA_FLAGS=--xla_force_host_platform_device_count=2")
    cfg = ModelConfig(**MODEL)
    model, params = init_segclip(cfg, seed=INIT_SEED)
    host = jax.tree_util.tree_map(np.asarray, params)

    # params/: one leaf sharded over two devices (two zarr chunks)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    placed = jax.tree_util.tree_map(jnp.asarray, host)
    node = placed
    for k in SHARDED[:-1]:
        node = node[k]
    node[SHARDED[-1]] = jax.device_put(node[SHARDED[-1]],
                                       NamedSharding(mesh, PartitionSpec("x", None)))
    save_params(out_dir, "params", placed)

    # ckpt_epoch_1/: two steps, the third's loss recorded
    batch, gumbel = batch_and_noise()
    train_cfg = Config(model=cfg, optim=OptimConfig(**OPTIM))
    state, tx, trainable = create_train_state(train_cfg, params, t_total=T_TOTAL,
                                              seed=TRAIN_SEED)
    step = make_single_device_train_step(model, tx, trainable=trainable)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    with mock.patch("jax.random.gumbel", lambda key, shape, dtype=jnp.float32:
                    jnp.asarray(gumbel).reshape(shape)):
        for i in range(3):
            if i == 2:
                save_checkpoint(out_dir, 1, state)
            state, metrics = step(state, jbatch)
            if float(metrics["skipped_nan"]):
                raise SystemExit(f"step {i + 1} was skipped as NaN")
            losses.append(float(metrics["loss"]))

    # the JAX segmenter on params/'s weights, float32 and bfloat16
    image, bank = image_and_bank()
    arrays = {"image": image, "text_bank": bank, "gumbel": gumbel,
              **{f"batch/{k}": v for k, v in batch.items()}}
    for dtype in ("float32", "bfloat16"):
        m, _ = init_segclip(dataclasses.replace(cfg, compute_dtype=dtype), seed=INIT_SEED)
        seg = ZeroShotSegmenter(m, host, jnp.asarray(bank), **SEGMENTER)
        arrays[f"logits_{dtype}"] = np.asarray(seg.whole(image), np.float32)
        arrays[f"group_map_{dtype}"] = np.asarray(seg.group_map(image))

    saved = ocp.StandardCheckpointer().restore(os.path.join(out_dir, "ckpt_epoch_1"))
    meta = {
        "model": MODEL, "optim": OPTIM, "t_total": T_TOTAL, "init_seed": INIT_SEED,
        "train_seed": TRAIN_SEED, "epoch": 1, "segmenter": SEGMENTER,
        "sharded": ".".join(("params",) + SHARDED),
        "losses": losses[:2], "next_loss": losses[2],
        "sha256": {"params": leaf_sha256({"params": host}),
                   "ckpt_epoch_1": leaf_sha256(jax.tree_util.tree_map(np.asarray, saved))},
        "versions": {name: version(name) for name in ("jax", "orbax-checkpoint",
                                                       "tensorstore")},
    }
    with open(os.path.join(out_dir, "fixture.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    np.savez_compressed(os.path.join(out_dir, "fixture.npz"), **arrays)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2").strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    out = sys.argv[1] if len(sys.argv) > 1 else FIXTURE_DIR
    if os.path.exists(out) and os.listdir(out):
        raise SystemExit(f"{out} is not empty")
    os.makedirs(out, exist_ok=True)
    generate(out)
    print(f"wrote {out}")
