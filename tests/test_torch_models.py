"""The PyTorch port's models against the JAX package on the CPU, on the same
weights (JAX params exported through `state_dict_from_jax`) and the same
numpy-seeded inputs, and against the committed golden pack recorded from
the torch reference.

Tolerances: 2e-5 at float32 against JAX (only the order of fp32 sums
differs); the golden pack at the docs/PARITY.md bounds (2e-4; soft
attention 1e-4; CLIP logits 2e-3). Hard assignments are bit-equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.config import ModelConfig
from segclip_tpu.models.layers import ResidualAttentionBlock as JBlock
from segclip_tpu.models.seg_vit import SemanticLearner as JSemantic
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch.config import ModelConfig as TModelConfig
from segclip_tpu_torch.checkpoint.convert import (load_into,
                                                  load_reference_state_dict,
                                                  state_dict_from_jax)
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip

torch.set_num_threads(1)
TOL = 2e-5
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_reference.npz")

# Two 64-dim heads in every tower, so every attention call takes the
# kernel's path (its plain version on the CPU).
CFG = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=128,
                  vision_layers=4, first_stage_layer=3, group_num=4,
                  cross_layer=2, context_length=16, vocab_size=512,
                  transformer_width=128, transformer_layers=2, embed_dim=32,
                  max_words=16, mae_decoder_depth=1, mae_decoder_num_heads=2,
                  compute_dtype="float32", grouping_impl="jnp")
# The port takes its own dataclass, built from the same fields.
TCFG = TModelConfig(**dataclasses.asdict(CFG))


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def pair():
    jmodel, jparams = jax_init_segclip(CFG, seed=0)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    model = SegCLIP(TCFG)
    dropped = load_into(model, state_dict_from_jax(jparams, TCFG.vision_patch_size))
    assert dropped == []
    return jmodel, jparams, model.eval()


def _jax_image(jmodel, jparams, img):
    return jmodel.apply({"params": jparams}, jnp.asarray(img),
                        method=lambda m, im: m.encode_image(im, training=False))


def test_residual_block_matches_jax(pair):
    _, jparams, model = pair
    x = np.random.default_rng(0).normal(size=(2, 16, 128)).astype(np.float32)
    jp = jparams["clip"]["visual"]["transformer"]["layers0_1"]
    ref = JBlock(128, 2, compute_dtype=jnp.float32).apply({"params": jp},
                                                          jnp.asarray(x))
    with torch.no_grad():
        out = model.clip.visual.transformer.layers0[1](torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=TOL)


def test_semantic_learner_matches_jax(pair):
    _, jparams, model = pair
    x = np.random.default_rng(1).normal(size=(2, 16, 128)).astype(np.float32)
    jp = jparams["clip"]["visual"]["transformer"]["semantic_layer2"]
    ref = JSemantic(128, 4, 2, cross_layer=2, tau=0.9, compute_dtype=jnp.float32,
                    grouping_impl="jnp").apply({"params": jp}, jnp.asarray(x))
    with torch.no_grad():
        out = model.clip.visual.transformer.semantic_layer2(torch.from_numpy(x))
    for name, a, r in zip(("groups", "hard", "soft", "centres"), out, ref):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=TOL, err_msg=name)
    np.testing.assert_array_equal(_np(out[1]), np.asarray(ref[1]).round())


@pytest.mark.parametrize("hw", [(32, 32), (40, 56), (48, 24)],
                         ids=["square", "whole_5x7", "whole_6x3"])
def test_encode_image_matches_jax(pair, hw):
    jmodel, jparams, model = pair
    img = np.random.default_rng(sum(hw)).normal(size=(2,) + hw + (3,)
                                                ).astype(np.float32)
    ref = _jax_image(jmodel, jparams, img)
    with torch.no_grad():
        out = model.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(_np(out.pooled), np.asarray(ref.pooled), atol=TOL)
    np.testing.assert_allclose(_np(out.hidden), np.asarray(ref.hidden), atol=TOL)
    np.testing.assert_allclose(_np(out.mid["soft_attn"]),
                               np.asarray(ref.mid["soft_attn"]), atol=TOL)
    np.testing.assert_array_equal(_np(out.mid["hard_attn"]),
                                  np.asarray(ref.mid["hard_attn"]).round())


def test_encode_text_matches_jax(pair):
    jmodel, jparams, model = pair
    rng = np.random.default_rng(2)
    ids = np.zeros((3, 16), np.int32)
    for i, n in enumerate((3, 9, 14)):              # EOT (the max id) at n
        ids[i, 0] = 509
        ids[i, 1:n] = rng.integers(1, 500, n - 1)
        ids[i, n] = 511
    ref = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                       method=lambda m, t: m.encode_text(t, training=False))
    with torch.no_grad():
        out = model.encode_text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(out.pooled), np.asarray(ref.pooled), atol=TOL)
    np.testing.assert_allclose(_np(out.hidden), np.asarray(ref.hidden), atol=TOL)


def test_bf16_encode_image_close_to_f32(pair):
    """The bfloat16 chain runs end to end and stays near float32 (a loose
    bound: bf16 keeps ~3 significant digits through 4+2 blocks)."""
    _, _, model = pair
    m16 = SegCLIP(dataclasses.replace(TCFG, compute_dtype="bfloat16"))
    m16.load_state_dict(model.state_dict())
    img = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a = model.encode_image(img).pooled
        b = m16.eval().encode_image(img).pooled
    assert b.dtype == torch.bfloat16
    assert torch.isfinite(b.float()).all()
    assert (a - b.float()).abs().max() < 0.1 * a.abs().max()


def test_init_is_seeded_and_loads_strictly(tmp_path):
    a, b, c = (init_segclip(TCFG, seed=s) for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["clip.visual.proj"], sc["clip.visual.proj"])
    path = tmp_path / "model.bin"
    torch.save(sa, path)
    sd = load_reference_state_dict(str(path))
    assert load_into(c, sd) == []
    assert all(torch.equal(c.state_dict()[k], sa[k]) for k in sa)
    with pytest.raises(KeyError):
        load_into(c, {**sd, "head.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError):                 # strict over clip.*
        load_into(c, {k: v for k, v in sd.items() if "ln_post" not in k})


@pytest.fixture(scope="module")
def golden():
    pack = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(pack[k]) for k in pack.files
          if k.startswith("sd/")}
    inp = {k[3:]: pack[k] for k in pack.files if k.startswith("in/")}
    out = {k[4:]: pack[k] for k in pack.files if k.startswith("out/")}
    cfg = TModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64,
                       vision_layers=12, first_stage_layer=3, group_num=8,
                       cross_layer=2, context_length=16, vocab_size=512,
                       transformer_width=64, transformer_layers=2, embed_dim=32,
                       max_words=16, compute_dtype="float32")
    model = SegCLIP(cfg)
    dropped = load_into(model, sd)
    assert dropped == ["seq_mae_decoder.", "vis_mae_decoder.decoder_pos_embed"]
    return model.eval(), inp, out


def test_golden_encoders(golden):
    model, inp, out = golden
    with torch.no_grad():
        vis = model.encode_image(torch.from_numpy(inp["img"]))
        txt = model.encode_text(torch.from_numpy(inp["ids"]))
    np.testing.assert_allclose(_np(vis.pooled), out["vis_pooled"], atol=2e-4)
    np.testing.assert_allclose(_np(vis.hidden), out["vis_hidden"], atol=2e-4)
    np.testing.assert_allclose(_np(vis.mid["soft_attn"]), out["soft_attn"],
                               atol=1e-4)
    np.testing.assert_allclose(_np(txt.pooled), out["text_pooled"], atol=2e-4)


def test_golden_clip_logits(golden):
    model, inp, out = golden
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(inp["img"])).pooled
        txt = model.encode_text(torch.from_numpy(inp["ids"])).pooled
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    scale = model.clip.logit_scale.exp().clamp(max=100.0)
    np.testing.assert_allclose(_np(scale * txt @ img.T), out["clip_logits"],
                               atol=2e-3)
