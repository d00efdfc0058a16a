"""The port's checkpoint ingest (segclip_tpu_torch/checkpoint/torch_convert.py
and cli/common.load_model) against the JAX package's, on the CPU.

No released checkpoint is in the repository, so the tests write files in
the two released layouts from seeded JAX weights: OpenAI's TorchScript
`ViT-B-16.pt` (fp16, `resblocks` keys, metadata tensors, no semantic
learner) and the reference's `segclip.bin` (a torch.save'd state dict of
the whole model, `clip.`-prefixed, layers0/layers2, with the MAE decoders
and their fixed position tables).

Exact comparisons throughout (the same fp16 → fp32 casts on both sides),
except the forward logits of the loaded models: 1e-5 (fp32 sums in another
order).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.checkpoint import torch_convert as jconvert
from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.cli.common import load_model as jax_load_model
from segclip_tpu.config import ModelConfig
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint import torch_convert as tconvert
from segclip_tpu_torch.cli.common import load_model
from segclip_tpu_torch.models.segclip import init_segclip

torch.set_num_threads(1)
# chip_smoke.py writes the same two layouts on the card (phase 7); its
# writers are the ones held to the JAX loader here.
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
openai_layout, save_torchscript = chip_smoke.openai_layout, chip_smoke.save_torchscript
NOT_IN_CLIP = chip_smoke.NOT_IN_CLIP
LOGIT_TOL = 1e-5
# Tiny widths; the fields the JAX package neither infers nor passes on stay
# at their defaults, so both packages' inferred configs can be equal.
TINY = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64,
                   vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
                   context_length=16, vocab_size=512, transformer_width=64,
                   transformer_layers=2, embed_dim=32, max_words=16,
                   use_text_mae_recon=True, compute_dtype="float32")
METADATA = {"input_resolution": 32, "context_length": 16, "vocab_size": 512}
def port_cfg(cfg: ModelConfig) -> tconfig.ModelConfig:
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def reference_sd():
    """A segclip.bin-layout state dict (numpy, float32) of seeded JAX
    weights, text MAE decoder included, and the JAX init tree."""
    _, params = jax_init_segclip(TINY, seed=5)
    params = jax.tree_util.tree_map(np.asarray, params)
    return export_state_dict(params, vision_patch_size=TINY.vision_patch_size), params


@pytest.fixture(scope="module")
def openai_pt(tmp_path_factory, reference_sd):
    sd, _ = reference_sd
    tensors = {k: torch.from_numpy(v).half()
               for k, v in openai_layout(sd, TINY.first_stage_layer).items()}
    tensors.update({k: torch.tensor(v) for k, v in METADATA.items()})
    path = tmp_path_factory.mktemp("ckpt") / "ViT-B-16.pt"
    save_torchscript(str(path), tensors)
    return str(path)


@pytest.fixture(scope="module")
def segclip_bin(tmp_path_factory, reference_sd):
    """The whole model, both decoders and their fixed tables, fp32."""
    sd, _ = reference_sd
    model = init_segclip(port_cfg(TINY))
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    for name in ("vis_mae_decoder", "seq_mae_decoder"):
        full[f"{name}.decoder_pos_embed"] = getattr(model, name).pos_table[None].clone()
    path = tmp_path_factory.mktemp("ckpt") / "segclip.bin"
    torch.save(full, path)
    return str(path)


def test_strip_prefix_and_layer_surgery_match_jax(reference_sd):
    sd, _ = reference_sd
    raw = openai_layout(sd, TINY.first_stage_layer)
    raw.update({k: np.asarray(v) for k, v in METADATA.items()})
    for inp in (raw, sd):
        tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
        ref = jconvert.strip_prefix(inp)
        out = tconvert.strip_prefix(tin)
        assert list(out) == list(ref)
        for split in (3, 1):
            jcut = jconvert.apply_layer_surgery(ref, split)
            tcut = tconvert.apply_layer_surgery(out, split)
            assert list(tcut) == list(jcut)
            assert all(np.array_equal(tcut[k].numpy(), jcut[k]) for k in jcut)
    assert not any(k in tconvert.strip_prefix(
        {k: torch.tensor(v) for k, v in METADATA.items()}) for k in METADATA)


VARIANT = dataclasses.replace(TINY, image_resolution=48, vision_width=128,
                              vision_layers=5, first_stage_layer=4, group_num=6,
                              cross_layer=2, context_length=20, vocab_size=300,
                              transformer_layers=3, embed_dim=48, max_words=20)


@pytest.mark.parametrize("layout, arg, overrides", [
    ("openai", 3, {}),                         # pre-surgery: the argument
    ("segclip", 10, {}),                       # the layers0 count wins over the default
    ("segclip", 2, {}),                        # ...and over a disagreeing argument
    ("segclip", 4, {"group_num": 3, "max_words": 10}),
    ("variant", 10, {}),                        # 6 groups, 2 cross layers inferred
], ids=["openai", "split_default", "split_disagrees", "overrides", "variant"])
def test_infer_model_config_matches_jax(reference_sd, layout, arg, overrides):
    if layout == "variant":
        _, params = jax_init_segclip(VARIANT, seed=1)
        sd = export_state_dict(jax.tree_util.tree_map(np.asarray, params),
                               vision_patch_size=VARIANT.vision_patch_size)
    else:
        sd = reference_sd[0]
        if layout == "openai":
            sd = openai_layout(sd, TINY.first_stage_layer)
    want = jconvert.infer_model_config(sd, first_stage_layer=arg, **overrides)
    got = tconvert.infer_model_config({k: torch.from_numpy(np.asarray(v))
                                       for k, v in sd.items()},
                                      first_stage_layer=arg, **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if layout == "variant":
        assert (got.group_num, got.cross_layer, got.vision_layers) == (6, 2, 5)


def test_infer_model_config_keeps_the_base_fields(reference_sd):
    """The fields the shapes do not give come from `base`; the JAX package
    resets them to ModelConfig()'s."""
    base = port_cfg(dataclasses.replace(TINY, gumbel_tau=3.0, mae_decoder_depth=1))
    got = tconvert.infer_model_config(
        {k: torch.from_numpy(v) for k, v in reference_sd[0].items()}, base=base)
    assert got == base


def _flax_to_reference(tree) -> dict:
    """flax path → reference key, through export_state_dict on a tree whose
    leaf i is filled with i."""
    paths, ids = [], {}
    for i, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(tree)[0]):
        keys = [p.key for p in path]
        paths.append("/".join(keys))
        node = ids
        for part in keys[:-1]:
            node = node.setdefault(part, {})
        node[keys[-1]] = np.full(np.shape(leaf), i, np.float32)
    exported = export_state_dict(ids, vision_patch_size=TINY.vision_patch_size)
    return {paths[int(arr.flat[0])]: key for key, arr in exported.items()}


def _jax_merge_report(path: str, cfg: ModelConfig):
    """The JAX load_model's inputs to merge_params: its missing and
    unexpected flax paths, as reference keys."""
    sd = jconvert.load_torch_state_dict(path)
    _, init = jax_init_segclip(cfg, seed=0)
    converted = jconvert.convert_state_dict(sd, cfg)
    init_names, conv_names = _flax_to_reference(init), _flax_to_reference(converted)
    return (sorted(init_names[p] for p in set(init_names) - set(conv_names)),
            sorted(conv_names[p] for p in set(conv_names) - set(init_names)))


@pytest.mark.parametrize("which, use_text_mae", [("openai", False), ("segclip", False),
                                                 ("segclip", True)],
                         ids=["openai_pt", "segclip_bin", "segclip_bin_text_mae"])
def test_load_model_matches_jax(openai_pt, segclip_bin, which, use_text_mae):
    """Inferred config, every tensor the file provides, and the missing and
    unexpected sets, against the JAX load_model on the same file."""
    path = openai_pt if which == "openai" else segclip_bin
    jcfg = dataclasses.replace(ModelConfig(), first_stage_layer=TINY.first_stage_layer,
                               group_num=TINY.group_num, cross_layer=TINY.cross_layer,
                               use_text_mae_recon=use_text_mae, max_words=16,
                               compute_dtype="float32")
    _, jparams, jinferred = jax_load_model(path, jcfg)
    model, inferred = load_model(path, port_cfg(jcfg), torch.device("cpu"))
    assert dataclasses.asdict(inferred) == dataclasses.asdict(jinferred)

    provided = tconvert.to_port_layout(tconvert.load_torch_state_dict(path),
                                       inferred.first_stage_layer)
    fresh = init_segclip(inferred, seed=0)
    messages = []
    missing, unexpected = tconvert.merge_state_dict(fresh, provided,
                                                    log_fn=messages.append)
    want_missing, want_unexpected = _jax_merge_report(path, dataclasses.replace(
        jinferred, grouping_impl="jnp"))
    assert (missing, unexpected) == (want_missing, want_unexpected)
    if which == "openai":
        assert missing and all(k.startswith(NOT_IN_CLIP) for k in missing)
        assert {k.split(".")[0] if not k.startswith("clip.") else k.split(".")[3]
                for k in missing} == {"semantic_layer2", "layers_mae2",
                                      "reconstruct_layer2", "vis_mae_decoder"}
        assert unexpected == []
    else:
        assert missing == []
        assert unexpected == ([] if use_text_mae else
                              sorted(k for k in provided if k.startswith("seq_mae")
                                     and not k.endswith("decoder_pos_embed")))

    state = model.state_dict()
    jsd = export_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                            vision_patch_size=inferred.vision_patch_size)
    loaded = [k for k in provided if k in state]
    assert loaded and len(loaded) == len(state) - len(missing)
    for key in loaded:
        np.testing.assert_array_equal(state[key].numpy(), provided[key].numpy(),
                                      err_msg=key)
        np.testing.assert_array_equal(state[key].numpy(), jsd[key], err_msg=key)
    seed0 = init_segclip(inferred, seed=0).state_dict()
    assert all(torch.equal(state[k], seed0[k]) for k in missing)
    assert any("kept random" in m for m in messages) == bool(missing)
    assert any("no destination" in m for m in messages) == bool(unexpected)


def test_segclip_bin_forward_matches_jax(segclip_bin):
    """The loaded models' image–text logits on the same inputs."""
    jcfg = dataclasses.replace(TINY, use_text_mae_recon=False)
    jmodel, jparams, _ = jax_load_model(segclip_bin, jcfg)
    model, _ = load_model(segclip_bin, port_cfg(jcfg), torch.device("cpu"))
    rng = np.random.default_rng(11)
    img = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = np.zeros((2, 16), np.int64)
    ids[:, 0], ids[:, 1:5], ids[:, 5] = 509, rng.integers(1, 500, (2, 4)), 511

    def logits(v, t, scale):
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        return min(np.exp(scale), 100.0) * v @ t.T

    jv = jmodel.apply({"params": jparams}, jnp.asarray(img),
                      method=lambda m, im: m.encode_image(im, training=False)).pooled
    jt = jmodel.apply({"params": jparams}, jnp.asarray(ids, jnp.int32),
                      method=lambda m, t: m.encode_text(t)).pooled
    with torch.no_grad():
        tv = model.encode_image(torch.from_numpy(img)).pooled.numpy()
        tt = model.encode_text(torch.from_numpy(ids)).pooled.numpy()
    scale = float(np.asarray(jparams["clip"]["logit_scale"]))
    assert scale == float(model.clip.logit_scale.detach())
    np.testing.assert_allclose(logits(tv, tt, scale),
                               logits(np.asarray(jv), np.asarray(jt), scale),
                               atol=LOGIT_TOL, rtol=0)


def test_load_torch_state_dict_casts_fp16_and_reads_both_formats(openai_pt, segclip_bin):
    raw = tconvert.load_torch_state_dict(openai_pt)
    ref = jconvert.load_torch_state_dict(openai_pt)
    assert sorted(raw) == sorted(ref) and set(METADATA) <= set(raw)
    assert all(v.dtype == torch.float32 and np.array_equal(v.numpy(), ref[k])
               for k, v in raw.items())
    full = tconvert.load_torch_state_dict(segclip_bin)
    assert sorted(full) == sorted(jconvert.load_torch_state_dict(segclip_bin))


def test_merge_raises_on_a_shape_mismatch_and_load_model_refuses_directories(
        segclip_bin, tmp_path):
    model = init_segclip(port_cfg(TINY))
    sd = dict(model.state_dict())
    sd["clip.visual.proj"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch for clip.visual.proj"):
        tconvert.merge_state_dict(model, sd)
    with pytest.raises(ValueError, match="Orbax"):
        load_model(str(tmp_path), port_cfg(TINY), torch.device("cpu"))
    model, cfg = load_model(None, port_cfg(TINY), torch.device("cpu"))
    assert cfg == port_cfg(TINY) and not model.training
