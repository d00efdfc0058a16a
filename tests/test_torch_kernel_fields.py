"""`model.attention_impl` and `model.grouping_impl` in the port, on the CPU.

The JAX package routes on both fields: attention_impl "xla" or
"pallas_vmem" (any other value raises, segclip_tpu/ops/attention.py:63-66)
and grouping_impl between its fused kernel and the jnp path
(segclip_tpu/models/seg_vit.py:129-131). The port routes by the tensors'
device instead, so here:

  - an attention_impl the JAX package refuses raises its ValueError in
    SegCLIP and in each entry point (train, eval, demo, a study), before
    any data or checkpoint is read;
  - setting either field to another value the JAX package takes logs one
    line per field in each entry point, and the run goes on;
  - the route does not follow the fields: a training step calls the same
    kernel wrappers (which launch the kernels on CUDA tensors) as often,
    with the same bits, whatever they say;
  - `model.param_dtype`, which the JAX package accepts and never reads
    (its parameters are float32), logs one line when set away from
    "float32" and never raises; the parameters stay float32.
"""
import dataclasses
import functools
import json
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_loop import TINY_EVAL_OPTS, TINY_OPTS, _voc
from test_torch_train import (TINY, make_batch, make_noise, port_config, torch_batch,
                              torch_noise)
from segclip_tpu_torch.cli import demo, eval_zeroshot, prepare_data
from segclip_tpu_torch.cli import train as train_cli
from segclip_tpu_torch.config import ModelConfig
from segclip_tpu_torch.models.segclip import (KERNEL_FIELDS, SegCLIP, check_kernel_fields,
                                              init_segclip)
from segclip_tpu_torch.ops.kernels import attention as kattention
from segclip_tpu_torch.ops.kernels import grouping as kgrouping
from segclip_tpu_torch.studies import classprobe
from segclip_tpu_torch.utils.logging import get_logger

torch.set_num_threads(1)
REFUSED = "attention impl 'flash' removed"
SET = {"attention_impl": "pallas_vmem", "grouping_impl": "jnp"}
# the studies infer the widths from the checkpoint
STUDY_OPTS = ["compute_dtype=float32"]
# the fields at their defaults, on test_torch_train's tiny widths
BASE = dataclasses.replace(TINY, attention_impl="xla", grouping_impl="auto")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 2-image VOC split, one image, and, for the study, a tiny shapes
    corpus and a seeded checkpoint at the studies' grid (224 px, patch 32)."""
    root = tmp_path_factory.mktemp("inputs")
    voc = _voc(root / "voc")
    image = root / "img.jpg"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (64, 80, 3)).astype(
        np.uint8)).save(image)
    corpus = root / "shapes"
    prepare_data.main(["shapes", "--out-dir", str(corpus), "--train-n", "1",
                       "--eval-n", "2"])
    ckpt = root / "model.pt"
    cfg = ModelConfig(vision_patch_size=32, vision_width=64, vision_layers=4,
                      first_stage_layer=3, transformer_width=64, transformer_layers=2,
                      embed_dim=32, use_vision_mae_recon=True)
    torch.save(init_segclip(cfg, seed=0).state_dict(), ckpt)
    return {"voc": str(voc), "image": str(image), "corpus": str(corpus), "ckpt": str(ckpt)}


def run(entry: str, inputs: dict, out, fields: dict):
    """One entry point at tiny widths on the CPU, with `fields` set."""
    model_opts = [f"{k}={v}" for k, v in fields.items()]
    if entry == "train":
        return train_cli.main(
            ["--device", "cpu", "--datatype", "synthetic", "--batch-size", "512",
             "--epochs", "1", "--max-words", "12", "--output-dir", str(out), "--opts"]
            + TINY_OPTS + ["model.image_resolution=32", "model.vision_patch_size=8",
                           "train.eval_each_epoch=false"]
            + [f"model.{o}" for o in model_opts])
    if entry == "eval":
        return eval_zeroshot.main(
            ["--device", "cpu", "--dataset", "voc", "--data-root", inputs["voc"],
             "--output-dir", str(out), "--opts"] + TINY_EVAL_OPTS + model_opts)
    if entry == "demo":
        return demo.main(["--device", "cpu", "--input", inputs["image"], "--output-dir",
                          str(out), "--opts"] + TINY_EVAL_OPTS + model_opts)
    return classprobe.main(["--device", "cpu", "--ckpt", inputs["ckpt"], "--data-root",
                            inputs["corpus"], "--batch", "2", "--out", str(out / "r.json"),
                            "--opts"] + STUDY_OPTS + model_opts)


ENTRIES = ("train", "eval", "demo", "study")


def test_segclip_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match=REFUSED):
        SegCLIP(port_config(dataclasses.replace(BASE, attention_impl="flash")))
    for impl in ("xla", "pallas_vmem"):
        SegCLIP(port_config(dataclasses.replace(BASE, attention_impl=impl)))


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_refuse_an_attention_impl_jax_refuses(entry, inputs, tmp_path):
    with pytest.raises(ValueError, match=REFUSED):
        run(entry, {**inputs, "ckpt": str(tmp_path / "absent.pt")}, tmp_path / "out",
            {"attention_impl": "flash"})
    assert not (tmp_path / "out" / "ckpt_epoch_0").exists()


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_log_one_line_per_field_and_run(entry, inputs, tmp_path, caplog):
    logger = get_logger()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            for i, fields in enumerate(({}, SET)):
                caplog.clear()
                out = tmp_path / str(i)
                out.mkdir()
                result = run(entry, inputs, out, fields)
                lines = [r.getMessage() for r in caplog.records
                         if "is ignored: the port launches its kernels" in r.getMessage()]
                assert lines == [f"model.{k}={v} is ignored: the port launches its kernels "
                                 "on CUDA tensors and their plain versions on the CPU, "
                                 "whatever the field says" for k, v in fields.items()]
                if entry == "train":
                    assert result["epochs_run"] == 1 and np.isfinite(result["final_loss"])
                elif entry == "eval":
                    assert 0.0 <= result["mIoU"] <= 100.0
                elif entry == "demo":
                    assert (out / "input_pred" / "img.jpg").exists()
                else:
                    assert json.loads((out / "r.json").read_text())["n_images"] == 2
    finally:
        logger.removeHandler(caplog.handler)


def _counted(module, name, calls):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def counted(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)
    return counted


def test_the_route_does_not_follow_the_fields(monkeypatch):
    """One training forward and backward at each setting: the kernel
    wrappers (attention forward and backward, the grouping) are called as
    often, and the losses and gradients are the same bits."""
    tb, noise = torch_batch(make_batch(17)), torch_noise(make_noise(18))
    runs = []
    for fields in ({}, SET):
        calls = {"attention_fwd": 0, "attention_bwd": 0, "group_assign_fwd": 0}
        for module, name in ((kattention, "attention_fwd"), (kattention, "attention_bwd"),
                             (kgrouping, "group_assign_fwd")):
            monkeypatch.setattr(module, name, _counted(module, name, calls))
        model = init_segclip(port_config(dataclasses.replace(BASE, **fields)), seed=3)
        losses = model(tb["input_ids"], tb["attention_mask"], tb["image"], tb["image_seg"],
                       training=True, noise=noise)
        losses["loss"].backward()
        monkeypatch.undo()
        runs.append((calls, {k: v.detach() for k, v in losses.items()},
                     {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
    (calls, losses, grads), (calls_set, losses_set, grads_set) = runs
    assert calls == calls_set and min(calls.values()) > 0 and set(SET) == set(KERNEL_FIELDS)
    assert losses.keys() == losses_set.keys() and grads.keys() == grads_set.keys()
    assert all(torch.equal(losses[k], losses_set[k]) for k in losses)
    assert all(torch.equal(grads[k], grads_set[k]) for k in grads)


@pytest.mark.parametrize("param_dtype, logged", [("float32", False), ("bfloat16", True),
                                                 ("float16", True)])
def test_param_dtype_logs_one_line_and_is_never_read(param_dtype, logged):
    """The JAX package's ModelConfig takes any param_dtype and its modules
    store float32 parameters whatever it says; the port's entry-point check
    logs one line for a value other than "float32" (and nothing else),
    raises for none, and SegCLIP's parameters stay float32."""
    from segclip_tpu.config import ModelConfig as JaxModelConfig
    assert JaxModelConfig(param_dtype=param_dtype).param_dtype == param_dtype
    lines = []
    cfg = dataclasses.replace(BASE, param_dtype=param_dtype)
    check_kernel_fields(cfg, lines.append)
    assert len(lines) == int(logged), lines
    if logged:
        assert lines[0].startswith(f"model.param_dtype={param_dtype} is ignored")
    model = SegCLIP(cfg)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
