"""The PyTorch port's ops (segclip_tpu_torch/ops) against the JAX package on
the CPU, on the same numpy-seeded inputs.

The kernel wrappers take their plain PyTorch versions on the CPU, so these
tests hold the plain versions — the oracles the CUDA kernels are compared
with on the card — to the JAX functions, including the Pallas kernels in
interpret mode. Tolerances: 1e-5 at float32 unless stated (only the order of
fp32 sums differs); the hard assignment is bit-equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.ops import attention as jattn
from segclip_tpu.ops import grouping as jgroup
from segclip_tpu.ops import layers as jlayers
from segclip_tpu.ops import pos_embed as jpos
from segclip_tpu.ops.pallas.attention import attention_vmem
from segclip_tpu.ops.pallas.grouping import fused_group_assign

from segclip_tpu_torch.ops import attention as tattn
from segclip_tpu_torch.ops import grouping as tgroup
from segclip_tpu_torch.ops import layers as tlayers
from segclip_tpu_torch.ops import pos_embed as tpos
from segclip_tpu_torch.ops.kernels.attention import attention, attention_plain
from segclip_tpu_torch.ops.kernels.checks import (ATTN_BF16_SHARE, bf16_ulps,
                                                  rounded_p_case)
from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_plain

torch.set_num_threads(1)
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_quick_gelu_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(3, 5, 48)).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    ln_j = jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    ln_t = tlayers.layer_norm(tx, _t(w), _t(b))
    assert ln_t.dtype == tx.dtype
    # bf16: both round the same fp32 normalisation → at most one bf16 ulp
    tol = TOL if dtype == "float32" else 2 ** -7 * np.abs(_np(ln_t.float())).max()
    np.testing.assert_allclose(_np(ln_t.float()),
                               np.asarray(ln_j.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(_np(tlayers.quick_gelu(_t(x))),
                               np.asarray(jlayers.quick_gelu(jnp.asarray(x))),
                               atol=TOL)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("sizes", [(14, 21), (14, 7), (4, 4), (5, 32), (28, 14)])
def test_interp_matrix_equals_jax_copy(method, sizes):
    np.testing.assert_array_equal(tpos.interp_matrix(*sizes, method),
                                  jpos.interp_matrix(*sizes, method))
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(tpos._cubic_kernel(x), jpos._cubic_kernel(x))


@pytest.mark.parametrize("grid", [(14, 21), (4, 4), (5, 7), (3, 2)])
def test_interpolate_pos_embed_matches_jax(grid):
    pos = np.random.default_rng(1).normal(size=(1 + 16, 24)).astype(np.float32)
    ref = jpos.interpolate_pos_embed(jnp.asarray(pos), *grid)
    out = tpos.interpolate_pos_embed(_t(pos), *grid)
    assert tuple(out.shape) == (1 + grid[0] * grid[1], 24)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=TOL)


def _qkv(rng, b, lq, lk, h, d=64):
    return (rng.normal(size=(b, lq, h * d)).astype(np.float32),
            rng.normal(size=(b, lk, h * d)).astype(np.float32),
            rng.normal(size=(b, lk, h * d)).astype(np.float32))


# (name, B, Lq, Lk, heads, bias)
ATTN_CASES = [
    ("no_bias", 2, 13, 13, 2, None),
    ("causal", 2, 21, 21, 2, "causal"),
    ("padding", 3, 17, 17, 2, "padding"),
    ("cross_8x204", 2, 8, 204, 2, None),
    ("odd_heads_1", 2, 9, 9, 1, None),
    ("odd_heads_3", 1, 11, 11, 3, "causal"),
]


def _biases(rng, name, b, lq, lk):
    if name == "causal":
        return np.asarray(jattn.causal_mask(lq)), None
    if name == "padding":
        m = (np.arange(lk)[None] < rng.integers(2, lk + 1, size=(b, 1))
             ).astype(np.float32)
        return None, (1.0 - m) * -1e6
    return None, None


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_plain_attention_matches_jax(case):
    name, b, lq, lk, h, bias = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = _qkv(rng, b, lq, lk, h)
    bias2d, biasb = _biases(rng, bias, b, lq, lk)
    jbias = (jnp.asarray(bias2d) if bias2d is not None else
             jnp.asarray(biasb)[:, None, None, :] if biasb is not None else None)
    ref = jattn._merge_heads(jattn.sdpa(
        jattn._split_heads(jnp.asarray(q), h), jattn._split_heads(jnp.asarray(k), h),
        jattn._split_heads(jnp.asarray(v), h), bias=jbias))
    tb2 = None if bias2d is None else _t(bias2d)
    tbb = None if biasb is None else _t(biasb)
    out = attention_plain(_t(q), _t(k), _t(v), tb2, tbb)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=TOL)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(_np(attention(_t(q), _t(k), _t(v), tb2, tbb)),
                                  _np(out))
    if h % 2 == 0:              # the TPU kernel takes pairs of 64-dim heads
        vmem = attention_vmem(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if bias2d is None else jnp.asarray(bias2d),
                              None if biasb is None else jnp.asarray(biasb),
                              64 ** -0.5, True)
        np.testing.assert_allclose(_np(out), np.asarray(vmem), atol=TOL)


def _jax_attention(q, k, v, h, bias=None):
    """JAX `sdpa` on (B, L, H·64) arrays (any dtype), as a numpy array."""
    return np.asarray(jattn._merge_heads(jattn.sdpa(
        jattn._split_heads(q, h), jattn._split_heads(k, h),
        jattn._split_heads(v, h), bias=bias)))


def _to_jax_bf16(x: torch.Tensor):
    return jnp.asarray(_np(x.float())).astype(jnp.bfloat16)


def test_rounded_p_case_matches_jax_bit_for_bit():
    """On the rounded-P case the port's bf16 chain (P rounded to bf16 before
    P·V) reproduces JAX's bit for bit, and skipping that rounding would move
    the output by several ulps."""
    q, k, v, bias2d = rounded_p_case("cpu")
    out = attention(q, k, v, bias2d)
    ref = _jax_attention(_to_jax_bf16(q), _to_jax_bf16(k), _to_jax_bf16(v), 1,
                         jnp.asarray(_np(bias2d)))
    np.testing.assert_array_equal(_np(out.float()), ref.astype(np.float32))
    unrounded = (torch.softmax(bias2d, -1) @ v[0].float()).to(torch.bfloat16)
    assert bf16_ulps(unrounded[None], out).max().item() >= 2


def test_bf16_share_bound_tells_rounded_from_unrounded_p():
    """The bf16 attention bound of the kernel checks: the port's plain
    version against JAX's `sdpa` (the same chain, another order of fp32
    operations) stays inside ATTN_BF16_SHARE; the same arithmetic with P
    left in fp32 before P·V does not."""
    rng = np.random.default_rng(11)
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, 2, 196, 196, 2))
    out = attention_plain(q, k, v)
    ref = _jax_attention(_to_jax_bf16(q), _to_jax_bf16(k), _to_jax_bf16(v), 2)
    ulps = bf16_ulps(out, torch.from_numpy(ref.astype(np.float32)))
    assert (ulps > 1).float().mean().item() <= ATTN_BF16_SHARE
    heads = [x.reshape(2, 196, 2, 64).transpose(1, 2).float() for x in (q, k, v)]
    p = torch.softmax(heads[0] @ heads[1].mT * 64 ** -0.5, dim=-1)
    unrounded = (p @ heads[2]).transpose(1, 2).reshape(2, 196, 128)
    share = (bf16_ulps(unrounded.to(torch.bfloat16), out) > 1).float().mean()
    assert share.item() > 10 * ATTN_BF16_SHARE


def test_multi_head_attention_rejects_heads_that_are_not_64_wide():
    x = torch.zeros(1, 3, 128)
    w, b = torch.zeros(384, 128), torch.zeros(384)
    with pytest.raises(ValueError, match="64-dim heads"):
        tattn.multi_head_attention(x, None, w, b, w[:128], b[:128], 1,
                                   compute_dtype=torch.float32)


def test_attention_takes_strided_column_views():
    """The packed projection's q|k|v views go to the kernel without copies;
    the plain path gives the same answer on views and on copies."""
    rng = np.random.default_rng(3)
    qkv = _t(rng.normal(size=(2, 10, 3 * 128)).astype(np.float32))
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    assert q.stride(1) == 3 * 128 and not q.is_contiguous()
    np.testing.assert_array_equal(
        _np(attention(q, k, v)),
        _np(attention(q.contiguous(), k.contiguous(), v.contiguous())))


@pytest.mark.parametrize("cross, bias", [(False, None), (False, "causal"),
                                         (False, "padding"), (True, None)])
def test_multi_head_attention_matches_jax(cross, bias):
    rng = np.random.default_rng(4)
    d, h, b, lq = 128, 2, 2, 9
    lk = 14 if cross else lq
    xq = rng.normal(size=(b, lq, d)).astype(np.float32)
    xkv = rng.normal(size=(b, lk, d)).astype(np.float32)
    wqkv = rng.normal(0, 0.1, size=(d, 3 * d)).astype(np.float32)   # JAX (in, out)
    bqkv = rng.normal(0, 0.1, size=3 * d).astype(np.float32)
    wout = rng.normal(0, 0.1, size=(d, d)).astype(np.float32)
    bout = rng.normal(0, 0.1, size=d).astype(np.float32)
    bias2d, biasb = _biases(rng, bias, b, lq, lk)
    jb = (jnp.asarray(bias2d) if bias2d is not None else
          jnp.asarray(biasb)[:, None, None, :] if biasb is not None else None)
    params = {"qkv": {"kernel": jnp.asarray(wqkv), "bias": jnp.asarray(bqkv)},
              "out": {"kernel": jnp.asarray(wout), "bias": jnp.asarray(bout)}}
    jq = jnp.asarray(xq)
    ref = jattn.multi_head_attention(params, jq, jnp.asarray(xkv) if cross else jq,
                                     h, bias=jb, compute_dtype=jnp.float32)
    tb = (_t(bias2d) if bias2d is not None else
          _t(biasb)[:, None, None, :] if biasb is not None else None)
    out = tattn.multi_head_attention(
        _t(xq), _t(xkv) if cross else None, _t(wqkv.T.copy()), _t(bqkv),
        _t(wout.T.copy()), _t(bout), h, bias=tb, compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5)


def test_causal_mask_and_padding_bias_match_jax():
    np.testing.assert_array_equal(_np(tattn.causal_mask(7)),
                                  np.asarray(jattn.causal_mask(7)))
    m = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(_np(tattn.padding_bias(_t(m))),
                                  np.asarray(jattn.padding_bias(jnp.asarray(m))))


def _grouping_inputs(seed, b=2, g=4, l=19, d=16, empty_group=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, g, d)).astype(np.float32)
    k = rng.normal(size=(b, l, d)).astype(np.float32)
    v = rng.normal(size=(b, l, d)).astype(np.float32)
    if empty_group:           # group 1 loses every patch: its count is 0
        k[..., 0] = 10.0
        q[:, 0, 0], q[:, 1, 0] = 10.0, -10.0
    return q, k, v


@pytest.mark.parametrize("empty_group", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 19, 16), (1, 8, 49, 64), (3, 1, 7, 8)])
def test_plain_grouping_matches_jax(shape, empty_group):
    b, g, l, d = shape
    q, k, v = _grouping_inputs(sum(shape), b, g, l, d, empty_group and g > 1)
    fused = fused_group_assign(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               tau=0.9, training=False, interpret=True)
    logits = jnp.einsum("bgd,bld->bgl", jnp.asarray(q), jnp.asarray(k))
    jnp_path = jgroup.group_assign_aggregate(logits, jnp.asarray(v), tau=0.9,
                                             training=False)
    out, hard, soft = group_assign_plain(_t(q), _t(k), _t(v))
    if empty_group and g > 1:
        assert (_np(hard).sum(axis=-1) == 0).any()
    np.testing.assert_array_equal(_np(hard), np.asarray(fused[1]))
    for ref in (fused, jnp_path):
        np.testing.assert_allclose(_np(hard), np.asarray(ref[1]), atol=1e-6)
        np.testing.assert_allclose(_np(soft), np.asarray(ref[2]), atol=TOL)
        np.testing.assert_allclose(_np(out), np.asarray(ref[0]), atol=TOL)
    wrapped = group_assign(_t(q), _t(k), _t(v))
    for a, b_ in zip(wrapped, (out, hard, soft)):
        np.testing.assert_array_equal(_np(a), _np(b_))


def test_grouping_ties_go_to_the_lowest_group():
    q = np.zeros((1, 3, 4), np.float32)
    q[0, 1] = q[0, 2] = 1.0                       # groups 1 and 2 tie everywhere
    k = np.ones((1, 5, 4), np.float32)
    v = np.arange(20, dtype=np.float32).reshape(1, 5, 4)
    out, hard, _ = group_assign_plain(_t(q), _t(k), _t(v))
    _, jhard, _ = fused_group_assign(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), interpret=True)
    np.testing.assert_array_equal(_np(hard), np.asarray(jhard))
    assert _np(hard)[0, 1].all() and not _np(hard)[0, 2].any()
    np.testing.assert_array_equal(_np(out)[0, 2], 0.0)    # empty group → 0


@pytest.mark.parametrize("training", [False, True])
def test_group_assign_aggregate_matches_jax(training):
    q, k, v = _grouping_inputs(7)
    noise = np.random.default_rng(8).gumbel(size=(2, 4, 19)).astype(np.float32)
    logits = np.einsum("bgd,bld->bgl", q, k)
    ref = jgroup.group_assign_aggregate(
        jnp.asarray(logits), jnp.asarray(v), tau=0.9, training=training,
        gumbel_noise=jnp.asarray(noise) if training else None)
    out = tgroup.group_assign_aggregate(
        _t(logits), _t(v), tau=0.9, training=training,
        gumbel_noise=_t(noise) if training else None)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=TOL)


def test_gumbel_softmax_draws_from_the_generator():
    logits = torch.zeros(2, 4, 6)

    def draw(seed):
        return tgroup.gumbel_softmax(logits, tau=0.9, hard=True, dim=1,
                                     generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    np.testing.assert_array_equal(_np(a), _np(b))
    assert not np.array_equal(_np(a), _np(c))
    np.testing.assert_allclose(_np(a).sum(axis=1), 1.0, atol=1e-6)
