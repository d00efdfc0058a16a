"""The PyTorch port's zero-shot segmentation (segclip_tpu_torch/evalseg and
cli/eval_zeroshot) against the JAX package on the CPU, and against the
golden pack's recorded whole-image decode.

Float32 throughout: the JAX segmenter's predictions are argmax maps, and a
float32 argmax is stable against summation order where bf16's is not
(docs/PERF.md "Deterministic eval mode"). Logit tolerance 2e-5 against JAX;
the golden decode at its docs/PARITY.md bound of 2e-4.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from segclip_tpu.config import ModelConfig
from segclip_tpu.evalseg.inference import ZeroShotSegmenter as JSegmenter
from segclip_tpu.evalseg.text_bank import build_text_bank as jax_text_bank
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch.config import ModelConfig as TModelConfig
from segclip_tpu_torch.checkpoint.convert import load_into, state_dict_from_jax
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter
from segclip_tpu_torch.evalseg.text_bank import build_text_bank
from segclip_tpu_torch.models.segclip import SegCLIP

torch.set_num_threads(1)
TOL = 2e-5
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_reference.npz")
CFG = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=128,
                  vision_layers=4, first_stage_layer=3, group_num=4,
                  cross_layer=1, context_length=16, transformer_width=128,
                  transformer_layers=2, embed_dim=32, max_words=16,
                  mae_decoder_depth=1, mae_decoder_num_heads=2,
                  compute_dtype="float32", grouping_impl="jnp")
# The port takes its own dataclass, built from the same fields.
TCFG = TModelConfig(**dataclasses.asdict(CFG))
CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car")


@pytest.fixture(scope="module")
def pair():
    """JAX and port segmenters on the same weights and the same text bank
    (crop 32, stride 24: overlapping windows)."""
    jmodel, jparams = jax_init_segclip(CFG, seed=0)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    model = SegCLIP(TCFG)
    load_into(model, state_dict_from_jax(jparams, TCFG.vision_patch_size))
    model.eval()
    bank = np.random.default_rng(0).normal(size=(len(CLASSES), 32))
    bank = (bank / np.linalg.norm(bank, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(with_bg=True, bg_thresh=0.5, patch_size=8, crop_size=32, stride=24)
    jseg = JSegmenter(jmodel, jparams, jnp.asarray(bank), **kw)
    seg = ZeroShotSegmenter(model, torch.from_numpy(bank), **kw)
    return jmodel, jparams, model, jseg, seg


def _image(h, w, seed):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)


def test_text_bank_matches_jax(pair):
    jmodel, jparams, model, _, _ = pair
    ref = jax_text_bank(jmodel, jparams, CLASSES, "simple", context_length=16)
    out = build_text_bank(model, CLASSES, "simple", context_length=16)
    assert tuple(out.shape) == (len(CLASSES), 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("hw", [(40, 70), (24, 70)], ids=["overlap", "padded"])
def test_slide_logits_match_jax(pair, hw):
    *_, jseg, seg = pair
    img = _image(*hw, seed=sum(hw))
    ref = jseg.slide(img)
    out = seg.slide(img)
    assert out.shape == (len(CLASSES) + 1,) + hw
    np.testing.assert_allclose(out, ref, atol=TOL)


@pytest.mark.parametrize("mode, hw, orig", [("slide", (40, 70), (50, 90)),
                                            ("whole", (40, 56), (60, 84)),
                                            ("whole", (44, 52), (44, 52))],
                         ids=["slide", "whole_resized", "whole_floored"])
def test_predict_argmax_equals_jax(pair, mode, hw, orig):
    *_, jseg, seg = pair
    img = _image(*hw, seed=7)
    ref = jseg.predict(img, orig, mode=mode)
    out = seg.predict(img, orig, mode=mode)
    assert out.shape == orig and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


def test_group_map_equals_jax(pair):
    *_, jseg, seg = pair
    img = _image(40, 56, seed=8)
    np.testing.assert_array_equal(seg.group_map(img), jseg.group_map(img))


def test_golden_zero_shot_decode():
    """The recorded whole-mode decode of the torch reference (soft-attention
    upsample, group/text affinity, top-5 gate, background threshold)."""
    pack = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(pack[k]) for k in pack.files
          if k.startswith("sd/")}
    cfg = TModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64,
                       vision_layers=12, first_stage_layer=3, group_num=8,
                       cross_layer=2, context_length=16, vocab_size=512,
                       transformer_width=64, transformer_layers=2, embed_dim=32,
                       compute_dtype="float32")
    model = SegCLIP(cfg)
    load_into(model, sd)
    seg = ZeroShotSegmenter(model.eval(), torch.from_numpy(pack["in/text_bank"]),
                            with_bg=True, bg_thresh=0.8, patch_size=8,
                            crop_size=32, stride=32)
    logits = seg.whole(pack["in/img"][0])
    ref = pack["out/decode_logits"]
    np.testing.assert_allclose(logits, ref, atol=2e-4)
    np.testing.assert_array_equal(logits.argmax(0), ref.argmax(0))


TINY_OPTS = ["vision_width=64", "vision_layers=4", "first_stage_layer=3",
             "group_num=4", "cross_layer=1", "transformer_width=64",
             "transformer_layers=2", "embed_dim=32"]


def test_eval_zeroshot_cli_end_to_end(tmp_path, capsys):
    from segclip_tpu_torch.cli.eval_zeroshot import main
    rng = np.random.default_rng(23)
    root = tmp_path / "voc"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "SegmentationClass").mkdir()
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate(((230, 300), (260, 240))):
        name = f"img{i}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg")
        label = rng.integers(0, 21, (h, w)).astype(np.uint8)
        label[:4] = 255
        Image.fromarray(label).save(root / "SegmentationClass" / f"{name}.png")
        names.append(name)
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(
        "\n".join(names) + "\n")

    out = tmp_path / "out"
    results = main(["--dataset", "voc", "--data-root", str(root),
                    "--compute-dtype", "float32", "--output-dir", str(out),
                    "--device", "cpu", "--opts"] + TINY_OPTS)
    assert 0.0 <= results["mIoU"] <= 100.0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["dataset"] == "voc" and payload["mIoU"] == results["mIoU"]
    snap = json.loads((out / "config.json").read_text())
    assert snap["model"]["compute_dtype"] == "float32"
    assert snap["model"]["vision_width"] == 64 and snap["device"] == "cpu"
    assert (out / "log.txt").exists()


def test_eval_zeroshot_cli_runs_on_the_card_unless_told(tmp_path):
    """With no --device the CLI asks for the card; without one it raises
    instead of evaluating on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run would use it")
    from segclip_tpu_torch.cli.eval_zeroshot import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset", "voc", "--data-root", str(tmp_path),
              "--output-dir", str(tmp_path / "out"), "--opts"] + TINY_OPTS)
