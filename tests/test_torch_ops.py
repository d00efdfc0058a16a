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
from segclip_tpu_torch.ops.kernels import grouping as tgroup_kernels
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
    # rows past the one-pass limit (256): the cluster kernels' route on the card
    ("cross_8x264", 2, 8, 264, 2, None),
    ("self_300", 1, 300, 300, 2, None),
    # rows past CLUSTER_LIMIT (1024): the long kernel's route (bf16) and the
    # TF32x3 kernel's (float32) on the card
    ("self_1100", 1, 1100, 1100, 2, None),
    ("cross_8x1108_padding", 2, 8, 1108, 2, "padding"),
]
LONG_CASES = [c for c in ATTN_CASES if c[3] > 1024]


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


@pytest.mark.parametrize("case", LONG_CASES, ids=[c[0] for c in LONG_CASES])
def test_plain_attention_matches_jax_in_bf16_past_1024_keys(case):
    """The bf16 chain on rows past 1024 keys (the long kernel's oracle):
    the plain version against JAX's `sdpa` and the TPU kernel
    (`attention_vmem`, interpret mode) on the same bf16 inputs, within the
    bf16 share rule (ATTN_BF16_SHARE of outputs more than one ulp apart)."""
    name, b, lq, lk, h, bias = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(rng, b, lq, lk, h))
    bias2d, biasb = _biases(rng, bias, b, lq, lk)
    tbb = None if biasb is None else _t(biasb)
    out = attention_plain(q, k, v, None, tbb)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (_to_jax_bf16(x) for x in (q, k, v))
    ref = _jax_attention(jq, jk, jv, h, None if biasb is None
                         else jnp.asarray(biasb)[:, None, None, :])
    vmem = attention_vmem(jq, jk, jv, None, None if biasb is None else jnp.asarray(biasb),
                          64 ** -0.5, True)
    for want in (ref, np.asarray(vmem)):
        ulps = bf16_ulps(out, torch.from_numpy(want.astype(np.float32)))
        assert (ulps > 1).float().mean().item() <= ATTN_BF16_SHARE, name


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


# --- the training slice: gradients, masking, position tables, routes -----

ATTN_GRAD_CASES = [("no_bias", 2, 13, 13, 2, None), ("causal", 2, 21, 21, 2, "causal"),
                   ("padding", 3, 17, 17, 2, "padding"), ("cross", 2, 8, 30, 2, None),
                   ("cross_264", 2, 8, 264, 2, None), ("self_300", 1, 300, 300, 2, None)]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES, ids=[c[0] for c in ATTN_GRAD_CASES])
def test_attention_gradients_match_jax(case):
    """`attention` through autograd (the saved-P backward, its plain version
    on the CPU) against jax.grad of the JAX `sdpa` path at 1e-5, and
    against the TPU kernel's VJP (interpret mode) within that kernel's own
    2e-2: it saves P in bf16 (tests/test_pallas_attention.py)."""
    name, b, lq, lk, h, bias = case
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    q, k, v = _qkv(rng, b, lq, lk, h)
    w = rng.normal(size=(b, lq, h * 64)).astype(np.float32)
    bias2d, biasb = _biases(rng, bias, b, lq, lk)
    jbias = (jnp.asarray(bias2d) if bias2d is not None else
             jnp.asarray(biasb)[:, None, None, :] if biasb is not None else None)

    def loss_sdpa(q_, k_, v_):
        return jnp.sum(jattn._merge_heads(jattn.sdpa(
            jattn._split_heads(q_, h), jattn._split_heads(k_, h),
            jattn._split_heads(v_, h), bias=jbias)) * w)

    def loss_vmem(q_, k_, v_):
        o = attention_vmem(q_, k_, v_, None if bias2d is None else jnp.asarray(bias2d),
                           None if biasb is None else jnp.asarray(biasb), 64 ** -0.5, True)
        return jnp.sum(o * w)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    ref = jax.grad(loss_sdpa, argnums=(0, 1, 2))(*args)
    vmem = jax.grad(loss_vmem, argnums=(0, 1, 2))(*args)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = attention(tq, tk, tv, None if bias2d is None else _t(bias2d),
                    None if biasb is None else _t(biasb))
    (out * _t(w)).sum().backward()
    for name_, got, r, vm in zip("qkv", (tq.grad, tk.grad, tv.grad), ref, vmem):
        np.testing.assert_allclose(_np(got), np.asarray(r), atol=TOL, err_msg=name_)
        np.testing.assert_allclose(_np(got), np.asarray(vm), rtol=2e-2, atol=2e-2,
                                   err_msg=name_)


# Rows past the backward kernels' old limits (the "tf32x3_long" route at
# float32 past 256 keys, the "long" route at bf16 past 1024) on the card:
# (name, dtype, B, Lq, Lk, heads).
LONG_BWD_CASES = [("f32_self_300", torch.float32, 1, 300, 300, 2),
                  ("bf16_self_1100", torch.bfloat16, 1, 1100, 1100, 2)]


@pytest.mark.parametrize("case", LONG_BWD_CASES, ids=[c[0] for c in LONG_BWD_CASES])
def test_attention_backward_past_the_old_limits_matches_jax(case):
    """The port's `attention` backward on the CPU (the saved-P backward's
    plain version, the long routes' oracle) against `jax.vjp` of JAX's
    `sdpa` and of the TPU kernel (`attention_vmem`, interpret mode), on the
    same numpy inputs and cotangent in the case's dtype. float32: within
    1e-5 of `sdpa`'s VJP (fp32 sums in another order) and within the TPU
    kernel's own 2e-2 of its VJP (it saves P in bf16). bf16, per gradient:
    against the TPU kernel's VJP, whose dtype chain the port's follows (P
    saved in bf16, the backward from it in fp32), max |err| ≤ 2e-3·(1 +
    max|ref|) and the share rule (at most ATTN_BF16_SHARE of the elements
    more than one bf16 ulp apart; measured 1.4e-5); against `sdpa`'s VJP,
    which rounds inside its own autodiff, max |err| ≤ 5e-3·(1 + max|ref|)
    and at most 1 % of the elements more than 4 ulps apart (measured 1.5e-3
    and 0.6 %)."""
    name, dtype, b, lq, lk, h = case
    rng = np.random.default_rng(sum(map(ord, name)) + 2)
    q, k, v = (_t(x).to(dtype) for x in _qkv(rng, b, lq, lk, h))
    w = _t(rng.normal(size=(b, lq, h * 64)).astype(np.float32)).to(dtype)
    to_jax = _to_jax_bf16 if dtype == torch.bfloat16 else (lambda x: jnp.asarray(_np(x)))
    jq, jk, jv, jw = (to_jax(x) for x in (q, k, v, w))

    def sdpa_fn(q_, k_, v_):
        return jattn._merge_heads(jattn.sdpa(jattn._split_heads(q_, h),
                                             jattn._split_heads(k_, h),
                                             jattn._split_heads(v_, h)))

    def vmem_fn(q_, k_, v_):
        return attention_vmem(q_, k_, v_, None, None, 64 ** -0.5, True)

    refs = []
    for fn in (sdpa_fn, vmem_fn):
        _, vjp = jax.vjp(fn, jq, jk, jv)
        refs.append([np.asarray(g.astype(jnp.float32)) for g in vjp(jw)])
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    attention(tq, tk, tv).backward(w)
    got = [_np(g.float()) for g in (tq.grad, tk.grad, tv.grad)]
    assert all(g.dtype == dtype for g in (tq.grad, tk.grad, tv.grad))
    for which, ref in zip(("sdpa", "attention_vmem"), refs):
        for name_, g, r in zip("qkv", got, ref):
            if dtype == torch.float32:
                tol = TOL if which == "sdpa" else 2e-2
                np.testing.assert_allclose(g, r, atol=tol, rtol=0 if which == "sdpa" else tol,
                                           err_msg=f"{which} d{name_}")
            else:
                err = np.abs(g - r).max() / (1 + np.abs(r).max())
                ulps = bf16_ulps(_t(g), _t(r))
                if which == "sdpa":
                    assert err <= 5e-3, (which, name_, err)
                    assert (ulps > 4).float().mean().item() <= 1e-2, (which, name_)
                else:
                    assert err <= 2e-3, (which, name_, err)
                    assert (ulps > 1).float().mean().item() <= ATTN_BF16_SHARE, (which, name_)


def test_attention_bwd_plain_matches_autodiff_of_the_plain_forward():
    """The backward's plain version from a saved P equals torch autograd
    through the plain forward (float32)."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(x).requires_grad_(True) for x in _qkv(rng, 2, 11, 15, 2))
    do = _t(rng.normal(size=(2, 11, 128)).astype(np.float32))
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_plain,
                                                         attention_fwd_plain)
    out, p = attention_fwd_plain(q, k, v)
    (out * do).sum().backward()
    grads = attention_bwd_plain(p.detach(), do, q.detach(), k.detach(), v.detach())
    for got, r in zip(grads, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(_np(got), _np(r), atol=TOL)


def _st_inputs(single_patch_group: bool, seed: int):
    """Gumbel-noised inputs as tests/test_pallas.py builds them. With
    single_patch_group the noise picks the winners instead: group 0 wins
    exactly patch 0, group 1 nothing, groups 2 and 3 the rest (the
    1 / 0.5 / 0 branches of the max(count, 1) subgradient)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 19, 16)).astype(np.float32)
    v = rng.normal(size=(2, 19, 16)).astype(np.float32)
    noise = rng.gumbel(size=(2, 4, 19)).astype(np.float32)
    if single_patch_group:
        q *= 0.1                                   # logits well inside ±5
        winner = np.where(np.arange(19) == 0, 0, 2 + np.arange(19) % 2)
        noise = 5.0 * (np.arange(4)[:, None] == winner[None, :])
        noise = np.broadcast_to(noise, (2, 4, 19)).astype(np.float32)
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((2, 4, 16), (2, 4, 19), (2, 4, 19))]
    return q, k, v, noise, weights


@pytest.mark.parametrize("single_patch_group", [False, True])
def test_group_assign_st_matches_jax(single_patch_group):
    """Values and gradients of `group_assign_st` against the TPU kernel's
    straight-through VJP (interpret mode) and against autodiff through the
    jnp path with the same noise: hard equal, gradients within 1e-5."""
    from segclip_tpu.ops.pallas.grouping import fused_group_assign_st
    q, k, v, noise, (w_out, w_hard, w_soft) = _st_inputs(single_patch_group, 23)
    jw = [jnp.asarray(x) for x in (w_out, w_hard, w_soft)]

    def weighted(outs):
        return sum(jnp.sum(o * wt) for o, wt in zip(outs, jw))

    def loss_fused(q_, k_, v_):
        return weighted(fused_group_assign_st(q_, k_, v_, jnp.asarray(noise), 0.9, True))

    def loss_jnp(q_, k_, v_):
        logits = jnp.einsum("bgd,bld->bgl", q_, k_, preferred_element_type=jnp.float32)
        return weighted(jgroup.group_assign_aggregate(logits, v_, tau=0.9, training=True,
                                                      gumbel_noise=jnp.asarray(noise)))

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    outs = tgroup_kernels.group_assign_st(tq, tk, tv, _t(noise), 0.9)
    if single_patch_group:
        counts = _np(outs[1]).sum(-1)
        assert (counts[:, 0] == 1).all() and (counts[:, 1] == 0).all()
    fused = fused_group_assign_st(*args, jnp.asarray(noise), 0.9, True)
    np.testing.assert_array_equal(_np(outs[1]), np.asarray(fused[1]))
    for got, r in zip(outs, fused):
        np.testing.assert_allclose(_np(got), np.asarray(r), atol=TOL)
    sum((o * _t(wt)).sum() for o, wt in zip(outs, (w_out, w_hard, w_soft))).backward()
    for loss in (loss_fused, loss_jnp):
        ref = jax.grad(loss, argnums=(0, 1, 2))(*args)
        for name, got, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
            np.testing.assert_allclose(_np(got), np.asarray(r), atol=TOL,
                                       err_msg=f"{loss.__name__} d{name}")


def test_eval_group_assign_is_differentiable_like_jax():
    """The eval grouping carries gradients (a plain softmax through the
    straight-through estimator), as JAX's eval path does."""
    q, k, v, _, (w_out, w_hard, w_soft) = _st_inputs(False, 31)

    def loss_jnp(q_, k_, v_):
        logits = jnp.einsum("bgd,bld->bgl", q_, k_, preferred_element_type=jnp.float32)
        outs = jgroup.group_assign_aggregate(logits, v_, tau=0.9, training=False)
        return sum(jnp.sum(o * jnp.asarray(wt))
                   for o, wt in zip(outs, (w_out, w_hard, w_soft)))

    ref = jax.grad(loss_jnp, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    outs = group_assign(tq, tk, tv)
    assert all(o.requires_grad for o in outs)
    sum((o * _t(wt)).sum() for o, wt in zip(outs, (w_out, w_hard, w_soft))).backward()
    for name, got, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(_np(got), np.asarray(r), atol=TOL, err_msg=name)


@pytest.mark.parametrize("keep_sep", [False, True])
def test_random_masking_matches_jax(keep_sep):
    """With CLS and each row's EOT pinned to −1 the two tie; the stable sort
    keeps them in position order, so ids_restore equals JAX's exactly
    (rows 1 and 3 put EOT at 0 or beside CLS on purpose)."""
    from segclip_tpu.ops import masking as jmasking
    from segclip_tpu_torch.ops.masking import random_masking
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 12, 6)).astype(np.float32)
    noise = rng.random((4, 12)).astype(np.float32)
    noise[2, 5] = noise[2, 7]                     # a tie between unpinned entries too
    sep = np.array([5, 0, 11, 1])
    kw = dict(keep_cls=True, keep_sep=keep_sep, sep_pos=sep if keep_sep else None)
    ref = jmasking.random_masking(jnp.asarray(x), 0.25, noise=jnp.asarray(noise),
                                  **{**kw, "sep_pos": jnp.asarray(sep) if keep_sep else None})
    out = random_masking(_t(x), 0.25, noise=_t(noise),
                         **{**kw, "sep_pos": _t(sep) if keep_sep else None})
    for got, r in zip(out, ref):
        np.testing.assert_array_equal(_np(got), np.asarray(r))
    gen = torch.Generator().manual_seed(0)
    drawn = random_masking(_t(x), 0.25, generator=gen, keep_cls=True)
    assert drawn[0].shape == (4, 9, 6) and (_np(drawn[3])[:, 0] == 0).all()


def test_position_tables_equal_jax_copies():
    for dim, grid in ((32, 4), (384, 14)):
        np.testing.assert_array_equal(tpos.sincos_2d(dim, grid, cls_token=True),
                                      jpos.sincos_2d(dim, grid, cls_token=True))
    for n, dim in ((12, 16), (32, 256)):
        np.testing.assert_array_equal(tpos.sinusoid_table(n, dim),
                                      jpos.sinusoid_table(n, dim))


@pytest.mark.parametrize("bias", [None, "padding"])
def test_plain_route_takes_48_dim_heads_and_matches_jax(bias):
    """The MAE decoders' route: 8 heads of 48 over width 384, as JAX's XLA
    path computes them; the kernel route refuses the same call."""
    rng = np.random.default_rng(12)
    d, h, b, l = 384, 8, 2, 10
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    wqkv = rng.normal(0, 0.05, size=(d, 3 * d)).astype(np.float32)
    bqkv = rng.normal(0, 0.05, size=3 * d).astype(np.float32)
    wout = rng.normal(0, 0.05, size=(d, d)).astype(np.float32)
    bout = rng.normal(0, 0.05, size=d).astype(np.float32)
    _, biasb = _biases(rng, bias, b, l, l)
    jb = None if biasb is None else jnp.asarray(biasb)[:, None, None, :]
    params = {"qkv": {"kernel": jnp.asarray(wqkv), "bias": jnp.asarray(bqkv)},
              "out": {"kernel": jnp.asarray(wout), "bias": jnp.asarray(bout)}}
    jx = jnp.asarray(x)
    ref = jattn.multi_head_attention(params, jx, jx, h, bias=jb, compute_dtype=jnp.float32)
    args = (_t(x), None, _t(wqkv.T.copy()), _t(bqkv), _t(wout.T.copy()), _t(bout), h)
    tb = None if biasb is None else _t(biasb)[:, None, None, :]
    calls = tattn.plain_route.calls
    out = tattn.multi_head_attention(*args, bias=tb, compute_dtype=torch.float32,
                                     route="plain")
    assert tattn.plain_route.calls == calls + 1
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5)
    with pytest.raises(ValueError, match="64-dim heads"):
        tattn.multi_head_attention(*args, bias=tb, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="route"):
        tattn.multi_head_attention(*args, compute_dtype=torch.float32, route="xla")


def test_kernel_bounds_at_the_training_shape():
    """bounds.py reproduces the byte and FLOP counts of the 96×196, H = 12
    bf16 attention: forward with P 204.1 MB / 11.3 GFLOP (0.0609 ms at
    3.35 TB/s), backward 290.8 MB / 22.7 GFLOP (0.0868 ms), both bound by
    bytes; fp32 work at 495 / 3 TFLOP/s (three TF32 products per
    fp32-accurate product), so the float32 forward with P, 408.2 MB / 11.3
    GFLOP, is bound by bytes at 0.1219 ms."""
    from segclip_tpu_torch.ops.kernels import bounds
    nbytes, flops = bounds.attention_fwd_work(96, 196, 196, 12, torch.bfloat16, save_p=True)
    assert round(nbytes / 1e6, 1) == 204.1 and round(flops / 1e9, 1) == 11.3
    ms, by = bounds.bound_ms(nbytes, flops, torch.bfloat16)
    assert by == "bytes" and round(ms, 4) == 0.0609
    nbytes, flops = bounds.attention_bwd_work(96, 196, 196, 12, torch.bfloat16)
    assert round(nbytes / 1e6, 1) == 290.8 and round(flops / 1e9, 1) == 22.7
    ms, by = bounds.bound_ms(nbytes, flops, torch.bfloat16)
    assert by == "bytes" and round(ms, 4) == 0.0868
    eval_bytes, _ = bounds.attention_fwd_work(2, 196, 196, 12, torch.bfloat16, save_p=False)
    assert eval_bytes == 2 * 768 * 4 * 2 * 196
    gb, gf = bounds.group_assign_work(96, 8, 196, 768, torch.bfloat16, training=True)
    assert gb == 2 * (2 * 96 * 8 * 768 + 2 * 96 * 196 * 768) + 4 * 4 * 96 * 8 * 196
    assert bounds.bound_ms(0, 165e9, torch.float32) == (1.0, "operations")
    nbytes, flops = bounds.attention_fwd_work(96, 196, 196, 12, torch.float32, save_p=True)
    assert round(nbytes / 1e6, 1) == 408.2 and round(flops / 1e9, 1) == 11.3
    ms, by = bounds.bound_ms(nbytes, flops, torch.float32)
    assert by == "bytes" and round(ms, 4) == 0.1219


# Kernel names as torch.profiler reports them on the card: PyTorch's own
# kernels, several in anonymous namespaces, and the port's, which live in
# `segclip_kernels` (the name it prints, or None for a kernel not its own).
PROFILER_NAMES = [
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>"
     "(int, float, float const*, float const*, float const*, float*, float*, float*)", None),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 8, false, false>"
     "(float*, float const*, int, int, int, bool const*, int, bool)", None),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::(anonymous namespace)::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
     "::{lambda()#3}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::native::(anonymous namespace)::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
     "::{lambda()#3}::operator()() const::{lambda(float)#1} const&)::{lambda(int)#1}>"
     "(int, at::native::gpu_kernel_impl_nocast<...>)", None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", None),
    ("void segclip_kernels::(anonymous namespace)::attention_fwd_bf16_kernel("
     "segclip_kernels::(anonymous namespace)::Args)", "attention_fwd_bf16_kernel"),
    ("void segclip_kernels::(anonymous namespace)::attention_bwd_dkv_bf16_kernel("
     "segclip_kernels::(anonymous namespace)::Args)", "attention_bwd_dkv_bf16_kernel"),
    ("void segclip_kernels::(anonymous namespace)::group_assign_kernel<__nv_bfloat16, true>("
     "segclip_kernels::(anonymous namespace)::Args)", "group_assign_kernel<__nv_bfloat16, true>"),
    ("void segclip_kernels::(anonymous namespace)::group_assign_kernel<float, false>("
     "segclip_kernels::(anonymous namespace)::Args)", "group_assign_kernel<float, false>"),
]


@pytest.mark.parametrize("name, expected", PROFILER_NAMES)
def test_profile_counts_only_the_ports_kernels(name, expected):
    """chip_smoke.py sums "the port's kernels" in a profile with this
    filter: PyTorch's anonymous-namespace kernels are not counted."""
    from segclip_tpu_torch.kernels.build import port_kernel_name
    assert port_kernel_name(name) == expected


def test_every_kernel_source_declares_the_ports_namespace():
    """The filter above finds a kernel only by its namespace, so every CUDA
    source with a kernel declares `segclip_kernels` before its first one."""
    from segclip_tpu_torch.kernels import build
    sources = build.sources()
    assert {s.name for s in sources} >= {"attention_fwd.cu", "attention_bwd.cu",
                                         "group_assign.cu"}
    for src in sources:
        text = src.read_text()
        if "__global__" in text:
            opened = text.find(f"namespace {build.KERNEL_NAMESPACE} {{")
            assert 0 <= opened < text.find("__global__"), src.name


def _chip_smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forward_route_sends_the_main_paths_rows_to_the_one_pass_kernel():
    """`fwd_route` by shape alone: every bf16 forward of the B = 96 step
    (chip_smoke.step_shapes of the default ModelConfig: Lk 196, 204, 8, 48,
    56, 32) and of the 224×224 request (196, 204, 8, and the text bank's 77)
    goes to the one-pass kernel, as do ViT-L/14's 256 and ViT-B/32's 49 and
    57; the longer rows up to CLUSTER_LIMIT (ViT-L/14's cross 264, a 224×336
    image's 294, 448 px's 784 and 792, 257) to the cluster kernel; bf16 rows
    past CLUSTER_LIMIT (a 448×672 image's 1176 and 1184, a 224×2048 image's
    1792 and 1800) to the long kernel; every float32 row, of any length, to
    the TF32x3 kernel. No route reaches the two-pass kernels."""
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.ops.kernels.attention import (CLUSTER_LIMIT, ONE_PASS_LIMIT,
                                                         fwd_route)
    smoke = _chip_smoke()
    step = smoke.step_shapes("train", ModelConfig(), 96)[0]
    assert sorted({c[3] for c in step}) == [8, 32, 48, 56, 196, 204]
    request = {c[3] for c in smoke.ATTN_CASES if c[1] <= 2 and "294" not in c[0]
               and "1176" not in c[0] and "2048" not in c[0] and "b32" not in c[0]}
    request |= {ModelConfig().context_length}
    assert request == {8, 77, 196, 204}
    b32 = {c[3] for c in smoke.step_shapes("b32", smoke.b32_config(), 96)[0]}
    l14 = {c[3] for c in smoke.step_shapes("l14", smoke.large_config("l14", False), 32)[0]}
    px448 = {c[3] for c in smoke.step_shapes("448", smoke.large_config("448", False), 24)[0]}
    assert {49, 57} <= b32 and {256, 264} <= l14 and {784, 792} <= px448
    for lk in {c[3] for c in step} | request | b32 | {256, ONE_PASS_LIMIT}:
        assert fwd_route(torch.bfloat16, lk) == "one_pass", lk
    for lk in (264, 294, 784, 792, 257, ONE_PASS_LIMIT + 1, CLUSTER_LIMIT):
        assert fwd_route(torch.bfloat16, lk) == "cluster", lk
    long = {c[3] for c in smoke.ATTN_CASES if c[3] > CLUSTER_LIMIT}
    assert long == {1176, 1184, 1792, 1800}
    for lk in long | {CLUSTER_LIMIT + 1, 2 * CLUSTER_LIMIT, 100_000}:
        assert fwd_route(torch.bfloat16, lk) == "long", lk
    for lk in {8, 196, 256, 264, 784, CLUSTER_LIMIT, CLUSTER_LIMIT + 1, 100_000} | long:
        assert fwd_route(torch.float32, lk) == "tf32x3", lk


def test_one_pass_limit_mirrors_the_cuda_constant():
    """ONE_PASS_LIMIT in the wrapper is csrc/attention_fwd.cu's constant
    (read from the source, as the namespace test reads it), which covers
    every row of the B = 96 step and of ViT-L/14 (256)."""
    import re
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.ops.kernels.attention import ONE_PASS_LIMIT
    text = (build.CSRC / "attention_fwd.cu").read_text()
    assert re.findall(r"constexpr int ONE_PASS_LIMIT = (\d+);", text) == [str(ONE_PASS_LIMIT)]
    assert ONE_PASS_LIMIT >= 256
    assert "int segclip_attention_fwd_one_pass_limit() { return ONE_PASS_LIMIT; }" in text


def test_long_min_lk_mirrors_the_cuda_constant():
    """LONG_MIN_LK in the wrapper is csrc/attention_fwd_long.cu's constant
    (read from the source), which the library reports and the kernel's
    entry point enforces: one past CLUSTER_LIMIT, so that every bf16 row
    has a kernel. The source's header says which TPU kernel it replaces,
    what bounds it and what its design does."""
    import re
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.ops.kernels.attention import CLUSTER_LIMIT, LONG_MIN_LK
    text = (build.CSRC / "attention_fwd_long.cu").read_text()
    assert re.findall(r"constexpr int LONG_MIN_LK = (\d+);", text) == [str(LONG_MIN_LK)]
    assert LONG_MIN_LK == CLUSTER_LIMIT + 1
    assert "int segclip_attention_fwd_long_min_lk() { return LONG_MIN_LK; }" in text
    assert "lk < LONG_MIN_LK" in text
    header = text[:text.index("#include")]
    for needle in ("segclip_tpu/ops/pallas/attention.py", "_fwd_kernel", "operations",
                   "0.0043 ms", "TMA", "mbarrier", "wgmma", "transpose bit",
                   "attention_fwd_long_kernel", "div_normal", "IEEE", "bits"):
        assert needle in header, needle


def test_one_pass_source_header_names_its_tpu_kernel_bound_and_design():
    """The forward source's header says which TPU kernel it replaces, what
    bounds the one-pass kernel on the card and what its design does (one
    pass over whole score rows, TMA copies with an mbarrier, wgmma for both
    products); the Hopper header says what its building blocks are."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_fwd.cu").read_text()
    header = text[:text.index("#include")]
    for needle in ("segclip_tpu/ops/pallas/attention.py", "_fwd_kernel", "one pass",
                   "bound", "bytes", "TMA", "mbarrier", "wgmma", "ONE_PASS_LIMIT",
                   "attention_fwd_one_pass_kernel", "attention_fwd_bf16_kernel"):
        assert needle in header, needle
    hopper = (build.CSRC / "hopper.cuh").read_text()
    hopper_header = hopper[:hopper.index("#pragma once")]
    for needle in ("TMA", "mbarrier", "wgmma", "swizzle", "descriptor"):
        assert needle in hopper_header, needle
    assert '#include "hopper.cuh"' in text


@pytest.mark.parametrize("route", ["one_pass", "cluster", "long", "tf32x3", "two_pass"])
def test_forward_routes_take_the_plain_version_on_the_cpu(route):
    """Each route's function, given CPU tensors, returns the plain version's
    output and P and launches nothing (no counter moves); the cluster and
    the long functions at rows past their lower limits, where they run on
    the card, and the TF32x3 function at float32."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    rng = np.random.default_rng(5)
    lk = {"cluster": 300, "long": 1100}.get(route, 9)
    qkv = _t(rng.normal(size=(2, lk, 3 * 128)).astype(np.float32))
    qkv = qkv if route == "tf32x3" else qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :9, :128], qkv[..., 128:256], qkv[..., 256:]
    fn = {"one_pass": kattn.attention_fwd_one_pass, "cluster": kattn.attention_fwd_cluster,
          "long": kattn.attention_fwd_long, "tf32x3": kattn.attention_fwd_tf32x3,
          "two_pass": kattn.attention_fwd_two_pass}[route]

    def counts():
        return (kattn.attention.launches, kattn.attention_fwd_one_pass.launches,
                kattn.attention_fwd_cluster.launches, kattn.attention_fwd_long.launches,
                kattn.attention_fwd_tf32x3.launches, kattn.attention_fwd_two_pass.launches)
    before = counts()
    out, p = fn(q, k, v, save_p=True)
    ref, p_ref = kattn.attention_fwd_plain(q, k, v)
    assert torch.equal(out, ref) and torch.equal(p, p_ref)
    assert fn(q, k, v)[1] is None
    assert counts() == before


def test_backward_route_sends_the_main_paths_rows_to_the_one_pass_kernel():
    """`bwd_route` by shape alone: every bf16 backward of the B = 96 step
    (Lk 196, 204, 8, 48, 56, 32), of the B = 512 step and of ViT-B/32 (49,
    57) goes to the one-pass kernel, as does ViT-L/14's 256; the longer rows
    up to BWD_CLUSTER_LIMIT (ViT-L/14's cross 264, 448 px's 784 and 792,
    294, 257) to the cluster kernel; rows past BWD_CLUSTER_LIMIT (the 672
    px step's 1764 and 1772) to the long kernels; float32 rows of at most
    BWD_TF32X3_LIMIT (256) keys, every float32 backward of the step, of
    ViT-B/32 and of the drift replay (L = 3), to the TF32x3 kernel and
    longer float32 rows (ViT-L/14's cross 264, the float32 448 px step's 784
    and 792) to the TF32x3 long kernels. No row goes to the two-pass pairs."""
    from segclip_tpu_torch.config import ModelConfig
    from segclip_tpu_torch.ops.kernels.attention import (BWD_CLUSTER_LIMIT,
                                                         BWD_ONE_PASS_LIMIT, bwd_route)
    smoke = _chip_smoke()
    step = {c[3] for c in smoke.step_shapes("train", ModelConfig(), 96)[0]}
    b512 = {c[3] for c in smoke.step_shapes("b512", smoke.large_config("b512", True), 512)[0]}
    b32 = {c[3] for c in smoke.step_shapes("b32", smoke.b32_config(), 96)[0]}
    l14 = {c[3] for c in smoke.step_shapes("l14", smoke.large_config("l14", False), 32)[0]}
    px448 = {c[3] for c in smoke.step_shapes("448", smoke.large_config("448", False), 24)[0]}
    assert step == b512 == {8, 32, 48, 56, 196, 204}
    assert {49, 57} <= b32 and {256, 264} <= l14 and {784, 792} <= px448
    assert BWD_ONE_PASS_LIMIT >= 204
    for lk in step | b512 | b32 | {256, BWD_ONE_PASS_LIMIT}:
        assert bwd_route(torch.bfloat16, lk) == "one_pass", lk
    for lk in (264, 784, 792, 294, 257, BWD_ONE_PASS_LIMIT + 1, BWD_CLUSTER_LIMIT):
        assert bwd_route(torch.bfloat16, lk) == "cluster", lk
    px672 = {c[3] for c in smoke.step_shapes("672", smoke.large_config("672", False), 4)[0]}
    assert {1764, 1772} <= px672
    for lk in (BWD_CLUSTER_LIMIT + 1, 1764, 1772, 2 * BWD_CLUSTER_LIMIT):
        assert bwd_route(torch.bfloat16, lk) == "long", lk
    for lk in step | b32 | {1, 3, 256}:
        assert bwd_route(torch.float32, lk) == "tf32x3", lk
    for lk in (257, 264, 784, 792, BWD_CLUSTER_LIMIT, BWD_CLUSTER_LIMIT + 1):
        assert bwd_route(torch.float32, lk) == "tf32x3_long", lk
    for lk in range(1, 2049):
        assert "two_pass" not in (bwd_route(torch.bfloat16, lk), bwd_route(torch.float32, lk))


def test_bwd_one_pass_limit_mirrors_the_cuda_constant():
    """BWD_ONE_PASS_LIMIT in the wrapper is csrc/attention_bwd.cu's constant,
    which the library reports through its own entry point."""
    import re
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.ops.kernels.attention import BWD_ONE_PASS_LIMIT
    text = (build.CSRC / "attention_bwd.cu").read_text()
    assert re.findall(r"constexpr int BWD_ONE_PASS_LIMIT = (\d+);", text) == [
        str(BWD_ONE_PASS_LIMIT)]
    assert BWD_ONE_PASS_LIMIT == 256
    assert ("int segclip_attention_bwd_one_pass_limit() { return BWD_ONE_PASS_LIMIT; }"
            in text)


def test_bwd_one_pass_source_header_names_its_tpu_kernel_bound_and_design():
    """The backward source's header says which TPU kernel it replaces (file
    and line), what bounds it on the card, and what the one-pass design does
    (one block per (batch, head), dK and dV summed on chip, TMA copies,
    wgmma with transposed operands, no atomics); the Hopper header has the
    transposed shared-memory product and the named barriers it uses."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_bwd.cu").read_text()
    header = text[:text.index("#include")]
    for needle in ("segclip_tpu/ops/pallas/attention.py:96", "_bwd_kernel", "bound", "bytes",
                   "0.087 ms", "one block", "(batch, head)", "on chip", "TMA", "mbarrier",
                   "wgmma", "transpose bit", "atomics", "BWD_ONE_PASS_LIMIT",
                   "attention_bwd_one_pass_kernel", "attention_bwd_{dq,dkv}_bf16_kernel",
                   "hi + lo"):
        assert needle in header, needle
    assert '#include "hopper.cuh"' in text
    hopper = (build.CSRC / "hopper.cuh").read_text()
    assert "template <int TRANS_A = 0, int TRANS_B = 0>" in hopper
    assert "named_sync" in hopper and "named_arrive" in hopper


@pytest.mark.parametrize("source, constant, entry", [
    ("attention_fwd.cu", "CLUSTER_LIMIT", "segclip_attention_fwd_cluster_limit"),
    ("attention_bwd.cu", "BWD_CLUSTER_LIMIT", "segclip_attention_bwd_cluster_limit")])
def test_cluster_limits_mirror_the_cuda_constants(source, constant, entry):
    """CLUSTER_LIMIT and BWD_CLUSTER_LIMIT in the wrapper are the constants
    of csrc/attention_fwd.cu and csrc/attention_bwd.cu (read from the
    source), which the library reports through its own entry points; each
    covers 448 px's rows (784, 792) with at most 8 blocks a cluster (the
    portable maximum), and takes over where the one-pass limit ends."""
    import re
    from segclip_tpu_torch.kernels import build
    from segclip_tpu_torch.ops.kernels import attention as kattn
    text = (build.CSRC / source).read_text()
    limit = getattr(kattn, constant)
    assert re.findall(rf"constexpr int {constant} = (\d+);", text) == [str(limit)]
    assert f"int {entry}() {{ return {constant}; }}" in text
    assert limit >= 1024 and kattn.ONE_PASS_LIMIT == kattn.BWD_ONE_PASS_LIMIT == 256
    blocks, slab = re.findall(r"constexpr int (?:BWD_)?CLUSTER_MAX = (\d+);", text), re.findall(
        r"constexpr int (?:SLAB_MAX|BWD_SLAB) = (\d+);", text)
    assert len(blocks) == len(slab) == 1 and int(blocks[0]) <= 8
    assert int(blocks[0]) * int(slab[0]) * 64 >= limit


@pytest.mark.parametrize("source, needles", [
    ("attention_fwd.cu", ("attention_fwd_cluster_kernel", "CLUSTER_LIMIT", "_fwd_kernel",
                          "thread-block cluster", "slab", "DSMEM", "multicast", "bytes",
                          "0.140 ms", "row max", "row sum", "rank order", "TMA", "wgmma")),
    ("attention_bwd.cu", ("attention_bwd_cluster_kernel", "BWD_CLUSTER_LIMIT", "_bwd_kernel",
                          "thread-block cluster", "slab", "DSMEM", "multicast", "bytes",
                          "0.166 ms", "P is read once", "rank order", "atomics", "TMA",
                          "wgmma"))])
def test_cluster_source_headers_name_their_tpu_kernel_bound_and_design(source, needles):
    """Each source's header says what the cluster kernel replaces, what
    bounds it on the card at 448 px's 24×784 (bytes, the time at 3.35
    TB/s) and what its design does (one cluster per (batch, head), a key
    slab per block, statistics and sums through distributed shared memory
    in rank order, Q (and dO) multicast by TMA, wgmma); the Hopper header
    has the cluster building blocks."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / source).read_text()
    header = text[:text.index("#include")]
    for needle in needles:
        assert needle in header, needle
    hopper = (build.CSRC / "hopper.cuh").read_text()
    for needle in ("multicast::cluster", "barrier.cluster.arrive.relaxed",
                   "barrier.cluster.wait.acquire", "mapa.shared::cluster", "st.async",
                   "cp.async.bulk.shared::cluster.shared::cta",
                   "cudaOccupancyMaxActiveClusters", "cudaLaunchAttributeClusterDimension"):
        assert needle in hopper, needle


@pytest.mark.parametrize("route", ["routed", "one_pass", "cluster", "long", "tf32x3",
                                   "tf32x3_long", "two_pass"])
def test_backward_routes_take_the_plain_version_on_the_cpu(route):
    """The routed backward and each route's function, given CPU tensors,
    return the plain version's gradients and launch nothing (no counter
    moves); each function at rows it takes on the card: the cluster one
    past the one-pass limit, the long one past the cluster limit, the
    TF32x3 ones at float32, the TF32x3 long one past 256 keys."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    rng = np.random.default_rng(6)
    lk = {"cluster": 300, "long": 1100, "tf32x3_long": 300}.get(route, 9)
    dtype = torch.float32 if route.startswith("tf32x3") else torch.bfloat16
    qkv = _t(rng.normal(size=(2, lk, 3 * 128)).astype(np.float32)).to(dtype)
    q, k, v = qkv[:, :9, :128], qkv[..., 128:256], qkv[..., 256:]
    _, p = kattn.attention_fwd(q, k, v, save_p=True)
    do = _t(rng.normal(size=(2, 9, 128)).astype(np.float32)).to(dtype)
    fn = {"routed": kattn.attention_bwd, "one_pass": kattn.attention_bwd_one_pass,
          "cluster": kattn.attention_bwd_cluster, "long": kattn.attention_bwd_long,
          "tf32x3": kattn.attention_bwd_tf32x3, "tf32x3_long": kattn.attention_bwd_tf32x3_long,
          "two_pass": kattn.attention_bwd_two_pass}[route]

    def counts():
        return (kattn.attention_bwd.launches, kattn.attention_bwd_one_pass.launches,
                kattn.attention_bwd_cluster.launches, kattn.attention_bwd_long.launches,
                kattn.attention_bwd_tf32x3.launches, kattn.attention_bwd_tf32x3_long.launches,
                kattn.attention_bwd_two_pass.launches)
    before = counts()
    grads = fn(p, do, q, k, v)
    for g, r in zip(grads, kattn.attention_bwd_plain(p, do, q, k, v)):
        assert torch.equal(g, r)
    assert counts() == before


def test_kernel_p_hands_the_backward_one_batch_head_dim():
    """P as the backward kernels read it: the forward's padded layout goes
    in as it is; a P whose batch and head dims cannot be read as one (B·H)
    dim, or whose rows are not 16-byte aligned, is copied into rows padded
    to 8 elements, with the same values."""
    from segclip_tpu_torch.ops.kernels.attention import _kernel_p
    rng = np.random.default_rng(7)
    full = _t(rng.random((2, 3, 5, 16)).astype(np.float32)).to(torch.bfloat16)
    padded = full[..., :13]                         # the forward's (B, H, Lq, Lk8) view
    assert _kernel_p(padded) is padded
    swapped = full.transpose(0, 1).contiguous().transpose(0, 1)[..., :13]
    for p in (swapped, padded.contiguous()):
        got = _kernel_p(p)
        assert got is not p and torch.equal(got, p)
        assert got.stride() == (3 * 5 * 16, 5 * 16, 16, 1)
