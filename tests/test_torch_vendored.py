"""The port's copies of the JAX package's JAX-free modules, each held equal
to its original.

The port imports nothing of segclip_tpu (tests/test_torch_isolation.py), so
it keeps its own copies of what it needs: the config tree, the
reference-layout exporter, the CLIP tokenizer and its vocabulary, the eval
datasets, templates and mIoU meter, and the CLIP normalisation statistics.
These tests run the original and the copy on the same inputs and ask for
equal results: values, types and raised errors alike.
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
from PIL import Image

import jax

from segclip_tpu import config as jconfig
from segclip_tpu.checkpoint import torch_export as jexport
from segclip_tpu.data import tokenizer as jtok
from segclip_tpu.data import transforms as jtransforms
from segclip_tpu.evalseg import datasets as jdatasets
from segclip_tpu.evalseg import miou as jmiou
from segclip_tpu.evalseg import templates as jtemplates
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint import torch_export as texport
from segclip_tpu_torch.data import tokenizer as ttok
from segclip_tpu_torch.data import transforms as ttransforms
from segclip_tpu_torch.evalseg import datasets as tdatasets
from segclip_tpu_torch.evalseg import miou as tmiou
from segclip_tpu_torch.evalseg import templates as ttemplates

CONFIGS = ("ModelConfig", "OptimConfig", "DataConfig", "TrainConfig",
           "EvalConfig", "Config")


def _same_tree(a, b):
    """Equal dataclass trees of the same class names, field by field."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_tree(x, y)
        else:
            assert type(x) is type(y), f.name


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_field_by_field(name):
    orig, copy = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert [f.name for f in dataclasses.fields(orig)] == \
        [f.name for f in dataclasses.fields(copy)]
    assert [str(f.type) for f in dataclasses.fields(orig)] == \
        [str(f.type) for f in dataclasses.fields(copy)]
    _same_tree(orig, copy)


@pytest.mark.parametrize("arch", sorted(jconfig.CLIP_ARCH_PRESETS))
def test_model_config_presets_and_properties(arch):
    orig = jconfig.model_config_for(arch, group_num=4)
    copy = tconfig.model_config_for(arch, group_num=4)
    _same_tree(orig, copy)
    for prop in ("vision_heads", "transformer_heads", "grid_size", "patch_len",
                 "num_patches"):
        assert getattr(orig, prop) == getattr(copy, prop), prop
    with pytest.raises(KeyError):
        tconfig.model_config_for("ViT-X/1")


@pytest.mark.parametrize("dotlist", [
    [],
    ["model.vision_width=64", "model.compute_dtype=float32"],
    ["optim.lr=3e-4", "optim.freeze_layer_num=-1", "train.seed=7"],
    ["data.crop_scale=(0.6, 1.0)"],
    ["data.crop_scale=0.7,0.9"],
    ["model.use_text_mae_recon=true", "model.use_seglabel=off"],
    ["eval.dataset=context", "eval.compute_dtype=none", "train.resume=none"],
    ["data.transfer=rgb", "data.device_aug=1", "train.output_dir=/tmp/x"],
])
def test_apply_overrides_on_dotlists(dotlist):
    _same_tree(jconfig.apply_overrides(jconfig.Config(), dotlist),
               tconfig.apply_overrides(tconfig.Config(), dotlist))


@pytest.mark.parametrize("dotlist, error", [
    (["model.no_such_field=1"], KeyError),
    (["model.vision_width=wide"], ValueError),
    (["model.vision_width"], ValueError),
    (["model.vision_width.x=1"], TypeError),
])
def test_apply_overrides_raises_alike(dotlist, error):
    for module in (jconfig, tconfig):
        with pytest.raises(error):
            module.apply_overrides(module.Config(), dotlist)


CAPTIONS = [
    "a photo of a cat.",
    "Two dogs   playing in the SNOW, near a red car!",
    "the café's crème brûlée — naïve façade",
    "東京の夜景 and a neon sign 🚀",
    "it's 3:45pm; we've got 1,000 items (approx.)",
    "&amp; html &lt;escaped&gt; text",
    "",
]


def test_tokenizer_vocabulary_is_the_same_file():
    assert filecmp.cmp(jtok._ASSET, ttok._ASSET, shallow=False)
    assert os.path.dirname(ttok._ASSET).startswith(
        os.path.dirname(os.path.dirname(ttok.__file__)))


@pytest.mark.parametrize("caption", CAPTIONS)
def test_tokenizer_ids_on_captions(caption):
    orig, copy = jtok.default_tokenizer(), ttok.default_tokenizer()
    assert copy.encode(caption) == orig.encode(caption)
    np.testing.assert_array_equal(copy.tokenize(caption, 16), orig.tokenize(caption, 16))
    assert copy.decode(copy.encode(caption)) == orig.decode(orig.encode(caption))


def test_tokenizer_batch_and_specials():
    orig, copy = jtok.default_tokenizer(), ttok.default_tokenizer()
    np.testing.assert_array_equal(copy.batch_tokenize(CAPTIONS, 77),
                                  orig.batch_tokenize(CAPTIONS, 77))
    assert (copy.bos_id, copy.eos_id, ttok.VOCAB_SIZE) == \
        (orig.bos_id, orig.eos_id, jtok.VOCAB_SIZE)


@pytest.mark.parametrize("seed, classes", [(0, 21), (1, 7), (2, 60)])
def test_miou_meter_on_seeded_label_maps(seed, classes):
    rng = np.random.default_rng(seed)
    meters = (jmiou.MIoUMeter(classes), tmiou.MIoUMeter(classes))
    for _ in range(3):
        h, w = rng.integers(20, 60, size=2)
        label = rng.integers(0, classes, (h, w))
        label[rng.random((h, w)) < 0.1] = 255
        pred = np.where(rng.random((h, w)) < 0.6, label, rng.integers(0, classes, (h, w)))
        pred[pred == 255] = 0
        for m in meters:
            m.update(pred, label)
    names = [f"c{i}" for i in range(classes)]
    np.testing.assert_array_equal(meters[0].state(), meters[1].state())
    np.testing.assert_equal(meters[1].results(names), meters[0].results(names))


def test_templates_specs_and_clip_statistics():
    assert ttemplates.TEMPLATE_SETS == jtemplates.TEMPLATE_SETS
    assert tdatasets.DATASET_SPECS.keys() == jdatasets.DATASET_SPECS.keys()
    for name, spec in jdatasets.DATASET_SPECS.items():
        copy = tdatasets.DATASET_SPECS[name]
        assert dataclasses.asdict(copy) == dataclasses.asdict(spec)
        assert copy.with_bg == spec.with_bg
        np.testing.assert_array_equal(copy.palette, spec.palette)
    for stat in ("CLIP_MEAN", "CLIP_STD"):
        orig, copy = getattr(jtransforms, stat), getattr(ttransforms, stat)
        assert copy.dtype == orig.dtype
        np.testing.assert_array_equal(copy, orig)


def test_eval_dataset_loads_the_same_samples(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "voc"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (root / d).mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate(((230, 300), (500, 180))):
        names.append(f"img{i}")
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "JPEGImages" / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 21, (h, w)).astype(np.uint8)).save(
            root / "SegmentationClass" / f"img{i}.png")
    (root / "ImageSets/Segmentation/val.txt").write_text("\n".join(names) + "\n")
    orig = jdatasets.SegEvalDataset(jdatasets.DATASET_SPECS["voc"], str(root))
    copy = tdatasets.SegEvalDataset(tdatasets.DATASET_SPECS["voc"], str(root))
    assert len(copy) == len(orig) == 2
    for a, b in zip(orig, copy):
        assert (a.name, a.orig_shape) == (b.name, b.orig_shape)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.label, b.label)


@pytest.mark.parametrize("heads", [1, 2])
def test_export_state_dict_on_init_params(heads):
    cfg = jconfig.ModelConfig(
        image_resolution=32, vision_patch_size=8, vision_width=64 * heads,
        vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
        context_length=16, vocab_size=512, transformer_width=64,
        transformer_layers=2, embed_dim=32, max_words=12,
        use_vision_mae_recon=True, use_text_mae_recon=True,
        mae_decoder_depth=1, mae_decoder_num_heads=2, compute_dtype="float32")
    _, params = jax_init_segclip(cfg, seed=heads)
    params = jax.tree_util.tree_map(np.asarray, params)
    orig = jexport.export_state_dict(params, cfg.vision_patch_size, cfg.vision_heads)
    copy = texport.export_state_dict(params, cfg.vision_patch_size, cfg.vision_heads)
    assert list(copy) == list(orig) and len(orig) > 50
    for key, arr in orig.items():
        assert copy[key].dtype == arr.dtype and copy[key].shape == arr.shape, key
        np.testing.assert_array_equal(copy[key], arr, err_msg=key)
