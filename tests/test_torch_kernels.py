"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker `gpu`) and skips without one; on
the card (H100, sm_90a) run them with

    python -m pytest tests/test_torch_kernels.py -q -m gpu

The first test builds the kernels with nvcc. Tolerances, kernel against
plain on the same inputs, with bf16 distances in ulps of the plain value
(segclip_tpu_torch/ops/kernels/checks.py): attention max |err| 2e-5 at
float32; at bfloat16 at most a share ATTN_BF16_SHARE of outputs more than one
ulp apart and max |err| 2e-2, and the rounded-P case equal bit for bit;
the attention backward, per output, max |err| ≤ 1e-5·(1 + max|ref|) at
float32 and the same share rule at bfloat16; grouping soft 1e-4, y_soft
1e-4, out 1e-5 at float32 and within one ulp at bfloat16, hard equal away
from near-tie patches (top-2 logit margin < 1e-3).
"""
import pytest
import torch

from segclip_tpu_torch.ops import attention as tattn
from segclip_tpu_torch.ops.kernels.attention import (attention, attention_bwd,
                                                     attention_bwd_plain,
                                                     attention_fwd,
                                                     attention_fwd_plain,
                                                     attention_plain)
from segclip_tpu_torch.ops.kernels.checks import (ATTN_BF16_SHARE, bf16_ulps,
                                                  rounded_p_case)
from segclip_tpu_torch.ops.kernels.grouping import (group_assign, group_assign_fwd,
                                                    group_assign_plain,
                                                    group_assign_st,
                                                    group_assign_st_plain)

pytestmark = pytest.mark.gpu

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, lq, lk, h, bias", [
    (2, 196, 196, 12, None), (1, 1, 1, 1, None), (3, 65, 130, 3, None),
    (2, 8, 204, 12, None), (20, 77, 77, 8, "causal"), (2, 33, 33, 2, "padding"),
    (1, 300, 700, 1, "both")])
def test_attention_kernel_matches_plain(cuda, dtype, b, lq, lk, h, bias):
    gen = torch.Generator(device=cuda).manual_seed(lq * lk + h)
    d = h * 64
    qkv = torch.randn(b, max(lq, lk), 3 * d, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv[:, :lq, :d], qkv[:, :lk, d:2 * d], qkv[:, :lk, 2 * d:]
    bias2d = None
    if bias in ("causal", "both"):
        bias2d = torch.full((lq, lk), float("-inf"), device=cuda).triu(1)
    biasb = None
    if bias in ("padding", "both"):
        lens = torch.randint(1, lk + 1, (b, 1), generator=gen, device=cuda)
        biasb = (torch.arange(lk, device=cuda)[None] >= lens).float() * -1e6
    before = attention.launches
    out = attention(q, k, v, bias2d, biasb)
    ref = attention_plain(q, k, v, bias2d, biasb)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, lq, d) and out.is_contiguous()
    assert (out.float() - ref.float()).abs().max().item() <= ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        assert (bf16_ulps(out, ref) > 1).float().mean().item() <= ATTN_BF16_SHARE


def test_attention_rounds_p_to_bf16_before_pv(cuda):
    q, k, v, bias2d = rounded_p_case(cuda)
    out = attention(q, k, v, bias2d)
    assert torch.equal(out, attention_plain(q, k, v, bias2d))


def test_attention_fully_masked_row_is_nan_like_softmax(cuda):
    q = torch.randn(1, 2, 64, device=cuda)
    k = torch.randn(1, 3, 64, device=cuda)
    bias2d = torch.zeros(2, 3, device=cuda)
    bias2d[1] = float("-inf")
    out = attention(q, k, k, bias2d)
    ref = attention_plain(q, k, k, bias2d)
    assert torch.isnan(out[0, 1]).all() and torch.isnan(ref[0, 1]).all()
    assert torch.allclose(out[0, 0], ref[0, 0], atol=2e-5)


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        attention(x[..., :48], x[..., :48], x[..., :48])
    with pytest.raises(ValueError):
        attention(x, x, x, bias2d=torch.zeros(4, 5, device=cuda))
    with pytest.raises(ValueError):                   # last dim not unit-stride
        wide = torch.randn(1, 4, 128, device=cuda)[..., ::2]
        attention(wide, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, g, l, d", [(2, 8, 196, 768), (1, 8, 294, 768),
                                        (3, 1, 5, 7), (2, 32, 1000, 96),
                                        (1, 8, 4000, 768), (2, 32, 50, 768)])
def test_group_assign_kernel_matches_plain(cuda, dtype, n, g, l, d):
    gen = torch.Generator(device=cuda).manual_seed(n * g * l * d)
    q = torch.randn(n, g, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(n, l, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(n, l, d, generator=gen, device=cuda).to(dtype)
    before = group_assign.launches
    out, hard, soft = group_assign(q, k, v)
    _, hard_ref, soft_ref = group_assign_plain(q, k, v)
    torch.cuda.synchronize()
    assert group_assign.launches == before + 1
    logits = torch.matmul(q.double(), k.double().transpose(1, 2))
    if g > 1:
        top2 = logits.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-3
        assert torch.equal(hard.argmax(1)[clear], hard_ref.argmax(1)[clear])
    assert torch.equal(hard.sum(1), torch.ones(n, l, device=cuda))
    assert (soft - soft_ref).abs().max().item() <= 1e-4
    counts = hard.sum(-1, keepdim=True).clamp(min=1.0)
    out_ref = (torch.matmul(hard, v.float()) / counts).to(dtype)
    if dtype == torch.float32:
        assert (out - out_ref).abs().max().item() <= 1e-5
    else:
        assert bf16_ulps(out, out_ref).max().item() <= 1


def test_group_assign_empty_group_and_ties(cuda):
    q = torch.zeros(1, 3, 4, device=cuda)
    q[0, 1] = q[0, 2] = 1.0                      # groups 1 and 2 tie everywhere
    k = torch.ones(1, 5, 4, device=cuda)
    v = torch.arange(20, dtype=torch.float32, device=cuda).reshape(1, 5, 4)
    out, hard, _ = group_assign(q, k, v)
    assert hard[0, 1].all() and not hard[0, 0].any() and not hard[0, 2].any()
    assert torch.equal(out[0, 1], v[0].mean(0))
    assert torch.equal(out[0, 0], torch.zeros(4, device=cuda))


def test_group_assign_rejects_what_it_does_not_take(cuda):
    """G ≤ 32, contiguous operands, N ≤ 65535 (one grid dimension), and
    the shared memory of one block of the cluster: at float32 q (G·D·4
    bytes) is staged whole, so G = 8, D = 8192 needs 256 KiB > 227 KiB; at
    bf16 q and two k tiles are staged, so G = 32, D = 4096 needs more."""
    x = torch.randn(1, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        group_assign(torch.randn(1, 33, 64, device=cuda), x, x)
    with pytest.raises(ValueError):
        group_assign(x[:, :2], x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="shared"):
        group_assign(torch.randn(1, 8, 8192, device=cuda),
                     torch.randn(1, 4, 8192, device=cuda),
                     torch.randn(1, 4, 8192, device=cuda))
    big = torch.randn(1, 32, 4096, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="shared"):
        group_assign(big, big[:, :4], big[:, :4])
    y = torch.randn(65536, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        group_assign(y, y, y)
    before = group_assign.launches
    half = big[:, :8, :2048].contiguous()
    out, _, _ = group_assign(half, half[:, :4].contiguous(), half[:, :4].contiguous())
    assert group_assign.launches == before + 1 and out.shape == (1, 8, 2048)


# The training step's attention shapes at B = 96: (B, Lq, Lk, heads, bias,
# cross). Vision blocks, cross blocks, group stage; the MAE path's 48 kept
# patches and its cross blocks; the text tower.
TRAIN_SHAPES = [(96, 196, 196, 12, None, False), (96, 8, 204, 12, None, True),
                (96, 8, 8, 12, None, False), (96, 48, 48, 12, None, False),
                (96, 8, 56, 12, None, True), (96, 32, 32, 8, "causal", False),
                (2, 33, 70, 2, "padding", True), (1, 1, 1, 1, None, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, lq, lk, h, bias, cross", TRAIN_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda, dtype, b, lq, lk, h, bias, cross):
    gen = torch.Generator(device=cuda).manual_seed(b * lq + lk)
    d = h * 64
    if cross:
        q = torch.randn(b, lq, d, generator=gen, device=cuda).to(dtype)
        kv = torch.randn(b, lk, 2 * d, generator=gen, device=cuda).to(dtype)
        k, v = kv[..., :d], kv[..., d:]
    else:
        qkv = torch.randn(b, lq, 3 * d, generator=gen, device=cuda).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    bias2d = (torch.full((lq, lk), float("-inf"), device=cuda).triu(1)
              if bias == "causal" else None)
    biasb = None
    if bias == "padding":
        lens = torch.randint(1, lk + 1, (b, 1), generator=gen, device=cuda)
        biasb = (torch.arange(lk, device=cuda)[None] >= lens).float() * -1e6
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    do = torch.randn(b, lq, d, generator=gen, device=cuda).to(dtype)
    before = attention_bwd.launches
    grads = attention_bwd(p, do, q, k, v)
    grads_ref = attention_bwd_plain(p, do, q, k, v)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    for g, r, x in zip(grads, grads_ref, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.is_contiguous()
        if dtype == torch.float32:
            err = (g - r).abs().max().item()
            assert err <= 1e-5 * (1 + r.abs().max().item())
        else:
            assert (bf16_ulps(g, r) > 1).float().mean().item() <= ATTN_BF16_SHARE
    if dtype == torch.float32:
        assert (p - p_ref).abs().max().item() <= 1e-5
    else:
        assert (bf16_ulps(p, p_ref) > 1).float().mean().item() <= ATTN_BF16_SHARE


@pytest.mark.parametrize("reduce", ["sum", "weighted"])
def test_attention_autograd_on_cuda_matches_cpu(cuda, reduce):
    """The repaired fault: on CUDA `attention` carries gradients, equal to
    the CPU's plain backward (an expanded dO from a sum included)."""
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(3, 21, 3 * 128, generator=gen)
    w = torch.randn(3, 21, 128, generator=gen)
    grads = {}
    for device in (cuda, torch.device("cpu")):
        x = qkv.to(device).clone().requires_grad_(True)
        out = attention(x[..., :128], x[..., 128:256], x[..., 256:])
        assert out.requires_grad
        loss = out.sum() if reduce == "sum" else (out * w.to(device)).sum()
        loss.backward()
        grads[device.type] = x.grad.cpu()
    assert (grads["cuda"] - grads["cpu"]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, g, l, d", [(96, 8, 196, 768), (96, 8, 48, 768),
                                        (3, 1, 5, 7), (2, 32, 300, 96)])
def test_group_assign_st_kernel_matches_plain(cuda, dtype, n, g, l, d):
    gen = torch.Generator(device=cuda).manual_seed(n * g + l)
    q = torch.randn(n, g, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(n, l, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(n, l, d, generator=gen, device=cuda).to(dtype)
    u = torch.rand(n, g, l, generator=gen, device=cuda)
    noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    before = group_assign_st.launches
    out, hard, soft, y_soft = group_assign_fwd(q, k, v, noise, 0.9)
    _, hard_ref, soft_ref, y_ref = group_assign_st_plain(q, k, v, noise, 0.9)
    torch.cuda.synchronize()
    assert group_assign_st.launches == before + 1
    y = (torch.matmul(q.double(), k.double().transpose(1, 2)) + noise.double()) / 0.9
    if g > 1:
        top2 = y.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-3
        assert torch.equal(hard.argmax(1)[clear], hard_ref.argmax(1)[clear])
    assert torch.equal(hard.sum(1), torch.ones(n, l, device=cuda))
    assert (soft - soft_ref).abs().max().item() <= 1e-4
    assert (y_soft - y_ref).abs().max().item() <= 1e-4
    counts = hard.sum(-1, keepdim=True).clamp(min=1.0)
    out_ref = (torch.matmul(hard, v.float()) / counts).to(dtype)
    if dtype == torch.float32:
        assert (out - out_ref).abs().max().item() <= 1e-5
    else:
        assert bf16_ulps(out, out_ref).max().item() <= 1


def test_group_assign_st_empty_group_and_exact_tie(cuda):
    """Noise that ties groups 1 and 2 exactly on every patch (the lowest
    index wins) and leaves group 0 empty (its output is 0)."""
    q = torch.zeros(1, 3, 4, device=cuda)
    k = torch.ones(1, 5, 4, device=cuda)
    v = torch.arange(20, dtype=torch.float32, device=cuda).reshape(1, 5, 4)
    noise = torch.zeros(1, 3, 5, device=cuda)
    noise[0, 1] = noise[0, 2] = 2.0
    out, hard, soft = group_assign_st(q, k, v, noise, 0.9)
    assert hard[0, 1].all() and not hard[0, 0].any() and not hard[0, 2].any()
    assert torch.equal(out[0, 1], v[0].mean(0))
    assert torch.equal(out[0, 0], torch.zeros(4, device=cuda))
    assert torch.allclose(soft, torch.full_like(soft, 1 / 3))


def test_group_assign_outputs_carry_gradients_on_cuda(cuda):
    """The repaired fault: eval and Gumbel grouping on CUDA are
    differentiable, with the CPU's straight-through gradients."""
    gen = torch.Generator().manual_seed(3)
    q0, k0, v0 = (torch.randn(2, n, 16, generator=gen) for n in (4, 19, 19))
    noise = -torch.log(-torch.log(torch.rand(2, 4, 19, generator=gen)))
    w = [torch.randn(s, generator=gen) for s in ((2, 4, 16), (2, 4, 19), (2, 4, 19))]
    for call in (lambda q, k, v, nz: group_assign(q, k, v),
                 lambda q, k, v, nz: group_assign_st(q, k, v, nz, 0.9)):
        grads = {}
        for device in (cuda, torch.device("cpu")):
            q, k, v = (t.to(device).clone().requires_grad_(True) for t in (q0, k0, v0))
            outs = call(q, k, v, noise.to(device))
            assert all(o.requires_grad for o in outs)
            sum((o * wt.to(device)).sum() for o, wt in zip(outs, w)).backward()
            grads[device.type] = [t.grad.cpu() for t in (q, k, v)]
        for a, b in zip(grads["cuda"], grads["cpu"]):
            assert (a - b).abs().max().item() <= 1e-4 * (1 + b.abs().max().item())


def test_kernel_route_refuses_48_dim_heads_plain_route_takes_them(cuda):
    x = torch.randn(2, 10, 384, device=cuda)
    w, b = torch.randn(3 * 384, 384, device=cuda) * 0.05, torch.zeros(3 * 384, device=cuda)
    args = (x, None, w, b, w[:384], b[:384], 8)
    with pytest.raises(ValueError, match="64-dim heads"):
        tattn.multi_head_attention(*args, compute_dtype=torch.float32)
    calls = tattn.plain_route.calls
    out = tattn.multi_head_attention(*args, compute_dtype=torch.float32, route="plain")
    ref = tattn.multi_head_attention(*(a.cpu() if a is not None and not isinstance(a, int)
                                       else a for a in args),
                                     compute_dtype=torch.float32, route="plain")
    assert tattn.plain_route.calls == calls + 2
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


# The bf16 tensor-core kernels (csrc/attention_fwd.cu, csrc/attention_bwd.cu
# with tc_bf16.cuh) at ragged lengths: 64-row blocks, 64-row K/V/P tiles and
# 8-wide P pieces all meet a partial edge somewhere in this set, and
# Lk > 512 takes pass (a)'s streamed-P branch.
RAGGED = (1, 7, 8, 15, 17, 48, 56, 196, 204, 294, 392)


def _bf16_case(cuda, b, lq, lk, h, bias=None, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    d = h * 64
    qkv = torch.randn(b, max(lq, lk), 3 * d, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :lq, :d], qkv[:, :lk, d:2 * d], qkv[:, :lk, 2 * d:]
    bias2d = biasb = None
    if bias == "causal":
        bias2d = torch.full((lq, lk), float("-inf"), device=cuda).triu(1)
    elif bias == "padding":
        lens = torch.randint(1, lk + 1, (b, 1), generator=gen, device=cuda)
        biasb = (torch.arange(lk, device=cuda)[None] >= lens).float() * -1e6
    do = torch.randn(b, lq, d, generator=gen, device=cuda).to(torch.bfloat16)
    return q, k, v, bias2d, biasb, do


def _assert_bf16_close(out, ref):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (bf16_ulps(out, ref) > 1).float().mean().item() <= ATTN_BF16_SHARE


def _fwd_bwd_matches_plain(cuda, b, lq, lk, h, bias=None, seed=0):
    q, k, v, bias2d, biasb, do = _bf16_case(cuda, b, lq, lk, h, bias, seed)
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    grads = attention_bwd(p, do, q, k, v)
    grads_ref = attention_bwd_plain(p, do, q, k, v)
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref)
    _assert_bf16_close(p, p_ref)
    for g, r in zip(grads, grads_ref):
        assert torch.isfinite(g).all()
        _assert_bf16_close(g, r)


@pytest.mark.parametrize("lk", RAGGED)
@pytest.mark.parametrize("lq", RAGGED)
def test_bf16_attention_ragged_lengths(cuda, lq, lk):
    _fwd_bwd_matches_plain(cuda, 2, lq, lk, 2, seed=lq * 1000 + lk)


@pytest.mark.parametrize("lq, lk", [(17, 512), (17, 513), (64, 1000), (130, 700)])
def test_bf16_attention_backward_streams_p_past_its_cache(cuda, lq, lk):
    """Rows past 512 keys: the routed calls (the cluster kernels), and the
    two-pass backward, whose pass (a) streams P there, called directly."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_two_pass
    _fwd_bwd_matches_plain(cuda, 1, lq, lk, 2, seed=lk)
    q, k, v, _, _, do = _bf16_case(cuda, 1, lq, lk, 2, seed=lk)
    _, p = attention_fwd(q, k, v, save_p=True)
    for g, r in zip(attention_bwd_two_pass(p, do, q, k, v), attention_bwd_plain(p, do, q, k, v)):
        assert torch.isfinite(g).all()
        _assert_bf16_close(g, r)


@pytest.mark.parametrize("bias", ["causal", "padding"])
@pytest.mark.parametrize("b, l, h", [(4, 77, 8), (3, 32, 8), (2, 196, 12), (2, 15, 1)])
def test_bf16_attention_biases(cuda, bias, b, l, h):
    _fwd_bwd_matches_plain(cuda, b, l, l, h, bias, seed=l)


@pytest.mark.parametrize("lk", [7, 196, 204, 392])
def test_bf16_saved_p_is_a_padded_view_read_without_a_copy(cuda, lk):
    from segclip_tpu_torch.ops.kernels.attention import _kernel_p
    q, k, v, _, _, do = _bf16_case(cuda, 2, 33, lk, 2)
    _, p = attention_fwd(q, k, v, save_p=True)
    lk8 = (lk + 7) // 8 * 8
    assert p.shape == (2, 2, 33, lk) and p.stride() == (2 * 33 * lk8, 33 * lk8, lk8, 1)
    assert p.data_ptr() % 16 == 0
    full = p.as_strided((2, 2, 33, lk8), p.stride())
    assert torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:]))
    assert _kernel_p(p) is p                        # handed to the kernel as it is
    grads = attention_bwd(p, do, q, k, v)
    for g, r in zip(grads, attention_bwd(p.contiguous(), do, q, k, v)):
        assert torch.equal(g, r)


def test_bf16_attention_fully_masked_row_is_nan_like_softmax(cuda):
    q, k, v, _, _, do = _bf16_case(cuda, 1, 9, 70, 1)
    bias2d = torch.zeros(9, 70, device=cuda)
    bias2d[4] = float("-inf")
    out, p = attention_fwd(q, k, v, bias2d, save_p=True)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d)
    assert torch.isnan(out[0, 4]).all() and torch.isnan(ref[0, 4]).all()
    assert torch.isnan(p[0, 0, 4]).all() and torch.isnan(p_ref[0, 0, 4]).all()
    keep = torch.ones(9, dtype=torch.bool, device=cuda)
    keep[4] = False
    _assert_bf16_close(out[:, keep], ref[:, keep])
    dq = attention_bwd(p, do, q, k, v)[0]
    assert torch.isnan(dq[0, 4]).all() and torch.isfinite(dq[:, keep]).all()


@pytest.mark.parametrize("kind", ["misaligned", "expanded"])
def test_bf16_backward_copies_a_do_it_cannot_read_in_place(cuda, kind):
    q, k, v, _, _, do = _bf16_case(cuda, 2, 40, 50, 2)
    _, p = attention_fwd(q, k, v, save_p=True)
    if kind == "misaligned":
        flat = torch.empty(do.numel() + 8, dtype=do.dtype, device=cuda)
        bad = flat[1:1 + do.numel()].view(do.shape)
        bad.copy_(do)
        assert bad.data_ptr() % 16 != 0
    else:                                   # the cotangent of out.sum()
        bad = do[0, 0, 0].expand_as(do)
        do = bad.contiguous()
    before = attention_bwd.launches
    grads = attention_bwd(p, bad, q, k, v)
    assert attention_bwd.launches == before + 1
    for g, r in zip(grads, attention_bwd(p, do, q, k, v)):
        assert torch.equal(g, r)


def test_bf16_kernels_refuse_misaligned_operands(cuda):
    x = torch.randn(2, 9, 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    q, k, v = x[..., 1:65], x[..., 65:129], x[..., 129:193]
    with pytest.raises(ValueError, match="16-byte"):
        attention(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd(torch.zeros(2, 1, 9, 9, device=cuda, dtype=torch.bfloat16),
                      torch.zeros(2, 9, 64, device=cuda, dtype=torch.bfloat16), q, k, v)


def test_bf16_backward_is_bit_reproducible(cuda):
    q, k, v, _, _, do = _bf16_case(cuda, 8, 196, 196, 12)
    _, p = attention_fwd(q, k, v, save_p=True)
    first = attention_bwd(p, do, q, k, v)
    second = attention_bwd(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _grouping_matches_plain(q, k, v, noise=None, tau=0.9):
    """One call of the kernel (eval form without noise, Gumbel form with
    it) against its plain version, at the tolerances of the module
    docstring; a second call must give the same bits. Returns the
    kernel's (out, hard, soft, y_soft)."""
    counter = group_assign if noise is None else group_assign_st
    before = counter.launches
    outs = group_assign_fwd(q, k, v, noise, tau)
    again = group_assign_fwd(q, k, v, noise, tau)
    if noise is None:
        _, hard_ref, soft_ref = group_assign_plain(q, k, v)
        y_ref = soft_ref
    else:
        _, hard_ref, soft_ref, y_ref = group_assign_st_plain(q, k, v, noise, tau)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    out, hard, soft, y_soft = outs
    n, g, _ = q.shape
    y = torch.matmul(q.double(), k.double().transpose(1, 2))
    if noise is not None:
        y = (y + noise.double()) / tau
    if g > 1:
        top2 = y.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-3
        assert torch.equal(hard.argmax(1)[clear], hard_ref.argmax(1)[clear])
    assert torch.equal(hard.sum(1), torch.ones(n, k.shape[1], device=q.device))
    assert (soft - soft_ref).abs().max().item() <= 1e-4
    assert (y_soft - y_ref).abs().max().item() <= 1e-4
    counts = hard.sum(-1, keepdim=True).clamp(min=1.0)
    out_ref = (torch.matmul(hard, v.float()) / counts).to(v.dtype)
    assert out.dtype == v.dtype and out.shape == q.shape
    if v.dtype == torch.float32:
        assert (out - out_ref).abs().max().item() <= 1e-5
    else:
        assert bf16_ulps(out, out_ref).max().item() <= 1
    return outs


def _grouping_inputs(cuda, n, g, l, d, dtype, gumbel, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(n, r, d, generator=gen, device=cuda).to(dtype) for r in (g, l, l))
    noise = None
    if gumbel:
        u = torch.rand(n, g, l, generator=gen, device=cuda)
        noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return q, k, v, noise


# The cluster's edges: 8 blocks per image, each assigning a multiple of 16
# patch rows (L below 8, at 16, past it, past 8 · 16) and summing D / 8
# columns (D = 7 and 100 take the general path at bf16, 100 the 16-byte
# one at float32); G = 1, 8, 32 (one to four n-tiles); N up to 96.
GROUP_LS = (1, 5, 15, 16, 17, 48, 196, 294, 1000, 4000)
GROUP_EDGES = [(96 if l <= 48 else (4 if l <= 294 else 2), g, l, (7, 96, 768, 100)[(i + j) % 4])
               for i, l in enumerate(GROUP_LS) for j, g in enumerate((1, 8, 32))]


@pytest.mark.parametrize("gumbel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, g, l, d", GROUP_EDGES)
def test_group_assign_cluster_edges(cuda, n, g, l, d, dtype, gumbel):
    q, k, v, noise = _grouping_inputs(cuda, n, g, l, d, dtype, gumbel, seed=l * 100 + g + d)
    _grouping_matches_plain(q, k, v, noise)


def _misaligned(t):
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    bad = flat[1:1 + t.numel()].view(t.shape)
    bad.copy_(t)
    return bad


@pytest.mark.parametrize("gumbel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_assign_misaligned_operands_take_the_general_path(cuda, dtype, gumbel):
    from segclip_tpu_torch.ops.kernels.grouping import vector_path
    q, k, v, noise = _grouping_inputs(cuda, 4, 8, 196, 768, dtype, gumbel, seed=11)
    assert vector_path(q, k, v)
    bad = [_misaligned(t) for t in (q, k, v)]
    assert bad[1].data_ptr() % 16 != 0 and not vector_path(*bad)
    _grouping_matches_plain(*bad, noise)


@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("gumbel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_assign_empty_group_and_exact_tie_both_forms(cuda, dtype, gumbel, d):
    """Groups 1 and 2 tie exactly on every patch (the lowest index wins),
    group 0 stays empty (its output is 0); at bf16 and D = 16 the logits
    come from the tensor cores, at D = 4 from the general path."""
    q = torch.zeros(1, 3, d, device=cuda)
    if gumbel:
        noise = torch.zeros(1, 3, 21, device=cuda)
        noise[0, 1] = noise[0, 2] = 2.0
    else:
        noise = None
        q[0, 1] = q[0, 2] = 1.0
    k = torch.ones(1, 21, d, device=cuda)
    v = torch.arange(21 * d, dtype=torch.float32, device=cuda).reshape(1, 21, d) / 64
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out, hard, soft, _ = _grouping_matches_plain(q, k, v, noise)
    assert hard[0, 1].all() and not hard[0, 0].any() and not hard[0, 2].any()
    assert torch.equal(out[0, 1], v[0].float().mean(0).to(dtype))
    assert torch.equal(out[0, 0], torch.zeros(d, device=cuda, dtype=dtype))


# The bf16 one-pass forward (csrc/attention_fwd.cu, attention_fwd_one_pass_kernel:
# TMA copies, wgmma, whole score rows on chip) for Lk ≤ its limit, the
# two-pass kernel above it. Each case runs both kernels on the same inputs
# and holds each to the plain version (out and P, the bf16 share rule), and
# the routed wrapper's call to the kernel `fwd_route` names.
ONE_PASS_MAIN_PATH = [           # (B, Lq, Lk, H, bias, cross): the B = 96 step, the 224×224 request
    (96, 196, 196, 12, None, False), (96, 8, 204, 12, None, True), (96, 8, 8, 12, None, False),
    (96, 48, 48, 12, None, False), (96, 8, 56, 12, None, True), (96, 32, 32, 8, "causal", False),
    (2, 196, 196, 12, None, False), (2, 8, 204, 12, None, True), (2, 8, 8, 12, None, False),
    (20, 77, 77, 8, "causal", False), (32, 256, 256, 16, None, False),
    (96, 49, 49, 12, None, False), (96, 8, 57, 12, None, True)]
ONE_PASS_EDGES = [               # Lq across the 64-row tile, Lk not a multiple of 8 or 16
    (2, lq, lk, 2, None, False) for lq in (1, 8, 63, 64, 65, 196)
    for lk in (1, 13, 77, 100, 255, 256)]


def _routes():
    from segclip_tpu_torch.ops.kernels.attention import (attention_fwd_one_pass,
                                                         attention_fwd_two_pass)
    return attention_fwd_one_pass.launches, attention_fwd_two_pass.launches


def _one_pass_case(cuda, b, lq, lk, h, bias, cross, seed):
    q, k, v, bias2d, biasb, _ = _bf16_case(cuda, b, lq, lk, h, bias, seed)
    if cross:                                      # q apart, k|v views of one projection
        gen = torch.Generator(device=cuda).manual_seed(seed + 1)
        q = torch.randn(b, lq, h * 64, generator=gen, device=cuda).to(torch.bfloat16)
    return q, k, v, bias2d, biasb


@pytest.mark.parametrize("b, lq, lk, h, bias, cross", ONE_PASS_MAIN_PATH + ONE_PASS_EDGES)
def test_bf16_one_pass_forward_matches_plain_and_the_two_pass_kernel(cuda, b, lq, lk, h,
                                                                     bias, cross):
    from segclip_tpu_torch.ops.kernels.attention import (ONE_PASS_LIMIT, attention_fwd_one_pass,
                                                         attention_fwd_two_pass, one_pass_limit)
    assert one_pass_limit() == ONE_PASS_LIMIT
    q, k, v, bias2d, biasb = _one_pass_case(cuda, b, lq, lk, h, bias, cross, seed=lq * 7 + lk)
    before, routes = attention.launches, _routes()
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    assert attention.launches == before + 1 and _routes() == (routes[0] + 1, routes[1])
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    eval_out, none = attention_fwd_one_pass(q, k, v, bias2d, biasb)
    two, p_two = attention_fwd_two_pass(q, k, v, bias2d, biasb, save_p=True)
    torch.cuda.synchronize()
    assert none is None and torch.equal(eval_out, out)
    for got, want in ((out, ref), (p, p_ref), (two, ref), (p_two, p_ref)):
        assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[torch.bfloat16]
        _assert_bf16_close(got, want)
    lk8 = (lk + 7) // 8 * 8
    full = p.as_strided((b, h, lq, lk8), p.stride())
    assert torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:]))


@pytest.mark.parametrize("lk", [256, 257])
def test_bf16_forward_route_at_the_limit(cuda, lk):
    """Lk at the limit takes the one-pass kernel, one past it the cluster
    kernel; the one-pass function refuses what it does not take."""
    from segclip_tpu_torch.ops.kernels.attention import (ONE_PASS_LIMIT, attention_fwd_cluster,
                                                         attention_fwd_one_pass, fwd_route)
    q, k, v, _, _, _ = _bf16_case(cuda, 2, 33, lk, 2)
    routes, cluster = _routes(), attention_fwd_cluster.launches
    out = attention(q, k, v)
    one = int(lk <= ONE_PASS_LIMIT)
    assert fwd_route(torch.bfloat16, lk) == ("one_pass" if one else "cluster")
    assert _routes() == (routes[0] + one, routes[1])
    assert attention_fwd_cluster.launches == cluster + 1 - one
    _assert_bf16_close(out, attention_plain(q, k, v))
    if not one:
        with pytest.raises(ValueError, match="one-pass"):
            attention_fwd_one_pass(q, k, v)
        with pytest.raises(ValueError, match="one-pass"):
            attention_fwd_one_pass(q.float(), k.float(), v.float())


@pytest.mark.parametrize("bias", ["causal", "padding"])
def test_bf16_one_pass_biases_and_masked_rows(cuda, bias):
    """Causal bias2d, and padding biasb with whole rows at −1e6, through
    the one-pass kernel; P read by the backward through its strides."""
    q, k, v, bias2d, biasb, do = _bf16_case(cuda, 4, 77, 77, 8, bias, seed=3)
    if biasb is not None:
        biasb[1] = -1e6                            # a sample padded everywhere
    routes = _routes()
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    assert _routes()[0] == routes[0] + 1
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref)
    _assert_bf16_close(p, p_ref)
    from segclip_tpu_torch.ops.kernels.attention import _kernel_p
    assert _kernel_p(p) is p
    for g, r in zip(attention_bwd(p, do, q, k, v), attention_bwd_plain(p, do, q, k, v)):
        _assert_bf16_close(g, r)


def test_bf16_one_pass_fully_masked_row_is_nan_like_softmax(cuda):
    q, k, v, _, _, _ = _bf16_case(cuda, 1, 70, 100, 1)
    bias2d = torch.zeros(70, 100, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    routes = _routes()
    out, p = attention_fwd(q, k, v, bias2d, save_p=True)
    assert _routes()[0] == routes[0] + 1
    ref, _ = attention_fwd_plain(q, k, v, bias2d)
    assert torch.isnan(out[0, 66]).all() and torch.isnan(ref[0, 66]).all()
    assert torch.isnan(p[0, 0, 66]).all()
    full = p.as_strided((1, 1, 70, 104), p.stride())
    assert torch.equal(full[..., 100:], torch.zeros_like(full[..., 100:]))
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    _assert_bf16_close(out[:, keep], ref[:, keep])


def test_bf16_one_pass_is_bit_reproducible_and_refuses_misaligned_operands(cuda):
    q, k, v, _, _, _ = _bf16_case(cuda, 8, 196, 196, 12)
    first = attention_fwd(q, k, v, save_p=True)
    second = attention_fwd(q, k, v, save_p=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_one_pass
    x = torch.randn(2, 9, 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd_one_pass(x[..., 1:65], x[..., 65:129], x[..., 129:193])


def test_bf16_one_pass_rounds_p_bit_for_bit(cuda):
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_one_pass
    q, k, v, bias2d = rounded_p_case(cuda)
    routes = _routes()
    out = attention(q, k, v, bias2d)
    assert _routes()[0] == routes[0] + 1
    assert torch.equal(out, attention_plain(q, k, v, bias2d))
    assert torch.equal(attention_fwd_one_pass(q, k, v, bias2d)[0], out)


# The bf16 one-pass backward (csrc/attention_bwd.cu, attention_bwd_one_pass_kernel:
# one block per (batch, head), dK and dV summed on chip, TMA copies, wgmma)
# for Lk ≤ its limit, the two-pass kernels above it. Each case runs both
# kernels on the same P, dO, q, k, v and holds each to the plain version
# (the bf16 share rule and finite values), and the routed wrapper's call to
# the kernel `bwd_route` names.
BWD_ONE_PASS_MAIN_PATH = [       # (B, Lq, Lk, H, bias, cross): the B = 96 step, ViT-B/32, ViT-L/14
    (96, 196, 196, 12, None, False), (96, 8, 204, 12, None, True), (96, 8, 8, 12, None, False),
    (96, 48, 48, 12, None, False), (96, 8, 56, 12, None, True), (96, 32, 32, 8, "causal", False),
    (96, 49, 49, 12, None, False), (96, 8, 57, 12, None, True), (32, 256, 256, 16, None, False)]
BWD_ONE_PASS_EDGES = [           # Lq and Lk ragged against the 64-row tiles and 16-key steps;
    (2, lq, lk, 2, None, lq != lk)  # Lk 100, 129 and 192 take two and three 64-key pieces
    for lq in (1, 8, 49, 57, 196, 204, 256)
    for lk in (1, 8, 49, 57, 100, 129, 192, 196, 204, 256)]


def _bwd_routes():
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_one_pass,
                                                         attention_bwd_two_pass)
    return attention_bwd_one_pass.launches, attention_bwd_two_pass.launches


def _bwd_case(cuda, b, lq, lk, h, bias, cross, seed):
    q, k, v, bias2d, biasb = _one_pass_case(cuda, b, lq, lk, h, bias, cross, seed)
    _, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    do = torch.randn(b, lq, h * 64, generator=gen, device=cuda).to(torch.bfloat16)
    return p, do, q, k, v


def _assert_grads_close(grads, ref):
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all() and g.is_contiguous()
        _assert_bf16_close(g, r)


@pytest.mark.parametrize("b, lq, lk, h, bias, cross",
                         BWD_ONE_PASS_MAIN_PATH + BWD_ONE_PASS_EDGES)
def test_bf16_bwd_one_pass_matches_plain_and_the_two_pass_kernel(cuda, b, lq, lk, h, bias,
                                                                 cross):
    from segclip_tpu_torch.ops.kernels.attention import (
        BWD_ONE_PASS_LIMIT, attention_bwd_one_pass, attention_bwd_two_pass, bwd_one_pass_limit)
    assert bwd_one_pass_limit() == BWD_ONE_PASS_LIMIT
    p, do, q, k, v = _bwd_case(cuda, b, lq, lk, h, bias, cross, seed=lq * 11 + lk)
    before, routes = attention_bwd.launches, _bwd_routes()
    grads = attention_bwd(p, do, q, k, v)
    assert attention_bwd.launches == before + 1 and _bwd_routes() == (routes[0] + 1, routes[1])
    one = attention_bwd_one_pass(p, do, q, k, v)
    two = attention_bwd_two_pass(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    torch.cuda.synchronize()
    assert _bwd_routes() == (routes[0] + 2, routes[1] + 1)
    assert all(torch.equal(g, o) for g, o in zip(grads, one))
    _assert_grads_close(one, ref)
    _assert_grads_close(two, ref)


@pytest.mark.parametrize("lk", [256, 257])
def test_bf16_bwd_one_pass_route_at_the_limit(cuda, lk):
    """Lk at the limit takes the one-pass backward, one past it the cluster
    kernel; the one-pass function refuses what it does not take."""
    from segclip_tpu_torch.ops.kernels.attention import (BWD_ONE_PASS_LIMIT,
                                                         attention_bwd_cluster,
                                                         attention_bwd_one_pass, bwd_route)
    p, do, q, k, v = _bwd_case(cuda, 2, 33, lk, 2, None, True, seed=lk)
    routes, cluster = _bwd_routes(), attention_bwd_cluster.launches
    grads = attention_bwd(p, do, q, k, v)
    one = int(lk <= BWD_ONE_PASS_LIMIT)
    assert bwd_route(torch.bfloat16, lk) == ("one_pass" if one else "cluster")
    assert _bwd_routes() == (routes[0] + one, routes[1])
    assert attention_bwd_cluster.launches == cluster + 1 - one
    _assert_grads_close(grads, attention_bwd_plain(p, do, q, k, v))
    if not one:
        with pytest.raises(ValueError, match="one-pass"):
            attention_bwd_one_pass(p, do, q, k, v)
        with pytest.raises(ValueError, match="one-pass"):
            attention_bwd_one_pass(p.float(), do.float(), q.float(), k.float(), v.float())


@pytest.mark.parametrize("bias", ["causal", "padding"])
@pytest.mark.parametrize("b, l, h", [(4, 77, 8), (96, 32, 8), (2, 196, 12)])
def test_bf16_bwd_one_pass_biases(cuda, bias, b, l, h):
    """Causal bias2d and padding biasb (one sample padded everywhere but its
    first key) through the forward, then the one-pass backward from its P."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_one_pass
    q, k, v, bias2d, biasb, do = _bf16_case(cuda, b, l, l, h, bias, seed=l + b)
    if biasb is not None:
        biasb[1, 1:] = -1e6
    _, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    _assert_grads_close(attention_bwd_one_pass(p, do, q, k, v),
                        attention_bwd_plain(p, do, q, k, v))


def test_bf16_bwd_one_pass_reads_views_in_place(cuda):
    """q|k|v column views of one projection and the forward's padded P go
    in without a copy (P of Lk = 196 and 204, rows padded to 8); a P whose
    batch and head dims are not one dim is copied first, to the same bits."""
    from segclip_tpu_torch.ops.kernels.attention import _kernel_p, attention_bwd_one_pass
    for lk, cross in ((196, False), (204, True)):
        p, do, q, k, v = _bwd_case(cuda, 3, 196 if not cross else 8, lk, 2, None, cross, seed=lk)
        assert _kernel_p(p) is p and p.stride(-2) == (lk + 7) // 8 * 8
        if not cross:
            assert q.stride(1) == 3 * q.shape[-1] and k.data_ptr() == q.data_ptr() + 2 * 128
        grads = attention_bwd_one_pass(p, do, q, k, v)
        swapped = p.transpose(0, 1).contiguous().transpose(0, 1)
        assert _kernel_p(swapped) is not swapped
        for got in (attention_bwd_one_pass(swapped, do, q, k, v),
                    attention_bwd_one_pass(p.contiguous(), do, q, k, v)):
            assert all(torch.equal(a, b) for a, b in zip(got, grads))
        _assert_grads_close(grads, attention_bwd_plain(p, do, q, k, v))


@pytest.mark.parametrize("kind", ["misaligned", "expanded"])
def test_bf16_bwd_one_pass_copies_a_do_it_cannot_read_in_place(cuda, kind):
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_one_pass
    p, do, q, k, v = _bwd_case(cuda, 2, 40, 50, 2, None, False, seed=4)
    if kind == "misaligned":
        flat = torch.empty(do.numel() + 8, dtype=do.dtype, device=cuda)
        bad = flat[1:1 + do.numel()].view(do.shape)
        bad.copy_(do)
        assert bad.data_ptr() % 16 != 0
    else:                                   # the cotangent of out.sum()
        bad = do[0, 0, 0].expand_as(do)
        do = bad.contiguous()
    routes = _bwd_routes()
    grads = attention_bwd_one_pass(p, bad, q, k, v)
    assert _bwd_routes() == (routes[0] + 1, routes[1])
    for g, r in zip(grads, attention_bwd_one_pass(p, do, q, k, v)):
        assert torch.equal(g, r)


def test_bf16_bwd_one_pass_is_bit_reproducible_and_refuses_misaligned_operands(cuda):
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_one_pass
    p, do, q, k, v = _bwd_case(cuda, 8, 196, 196, 12, None, False, seed=5)
    first = attention_bwd_one_pass(p, do, q, k, v)
    second = attention_bwd_one_pass(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    x = torch.randn(2, 9, 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd_one_pass(torch.zeros(2, 1, 9, 9, device=cuda, dtype=torch.bfloat16),
                               torch.zeros(2, 9, 64, device=cuda, dtype=torch.bfloat16),
                               x[..., 1:65], x[..., 65:129], x[..., 129:193])


def test_bf16_bwd_one_pass_fully_masked_row_is_nan_like_the_plain_version(cuda):
    """A row whose every key is masked has P = NaN: dQ's row is NaN, the
    other rows of dQ finite, and dK and dV NaN wherever the plain version's
    are."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_one_pass
    q, k, v, _, _, do = _bf16_case(cuda, 1, 70, 100, 1)
    bias2d = torch.zeros(70, 100, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    _, p = attention_fwd(q, k, v, bias2d, save_p=True)
    grads = attention_bwd_one_pass(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    assert torch.isnan(grads[0][0, 66]).all() and torch.isfinite(grads[0][:, keep]).all()
    _assert_bf16_close(grads[0][:, keep], ref[0][:, keep])
    for g, r in zip(grads[1:], ref[1:]):
        assert torch.equal(torch.isnan(g), torch.isnan(r))


# The bf16 cluster kernels (csrc/attention_fwd.cu attention_fwd_cluster_kernel,
# csrc/attention_bwd.cu attention_bwd_cluster_kernel: one thread-block cluster
# per (batch, head), a key slab per block, the row statistics, O, D and dQ
# summed across the cluster) for ONE_PASS_LIMIT < Lk ≤ CLUSTER_LIMIT. Each
# case runs the routed calls (which must take the cluster kernels) and PR 3's
# two-pass kernels on the same inputs, and holds all to the plain version
# (the bf16 share rule, finite values, P's padding columns zero).
CLUSTER_LKS = (257, 264, 294, 511, 512, 513, 784, 792, 1000, 1024)
CLUSTER_LQS = (1, 8, 17, 64, 130, 785)


def _cluster_routes():
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_cluster,
                                                         attention_fwd_cluster)
    return attention_fwd_cluster.launches, attention_bwd_cluster.launches


def _cluster_matches_plain_and_the_two_pass_kernels(cuda, b, lq, lk, h, bias=None, seed=0,
                                                    cross=True):
    from segclip_tpu_torch.ops.kernels.attention import (
        attention_bwd_two_pass, attention_fwd_two_pass)
    q, k, v, bias2d, biasb = _one_pass_case(cuda, b, lq, lk, h, bias, cross, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 3)
    do = torch.randn(b, lq, h * 64, generator=gen, device=cuda).to(torch.bfloat16)
    routes = _cluster_routes()
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    grads = attention_bwd(p, do, q, k, v)
    assert _cluster_routes() == (routes[0] + 1, routes[1] + 1)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    grads_ref = attention_bwd_plain(p, do, q, k, v)
    two, p_two = attention_fwd_two_pass(q, k, v, bias2d, biasb, save_p=True)
    grads_two = attention_bwd_two_pass(p, do, q, k, v)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (p, p_ref), (two, ref), (p_two, p_ref)):
        assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[torch.bfloat16]
        _assert_bf16_close(got, want)
    _assert_grads_close(grads, grads_ref)
    _assert_grads_close(grads_two, grads_ref)
    lk8 = (lk + 7) // 8 * 8
    full = p.as_strided((b, h, lq, lk8), p.stride())
    assert torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:]))


@pytest.mark.parametrize("lk", CLUSTER_LKS)
@pytest.mark.parametrize("lq", CLUSTER_LQS)
def test_bf16_cluster_kernels_match_plain_and_the_two_pass_kernels(cuda, lq, lk):
    _cluster_matches_plain_and_the_two_pass_kernels(cuda, 2, lq, lk, 2, seed=lq * 13 + lk,
                                                    cross=lq != lk)


@pytest.mark.parametrize("b, lq, lk, h", [(24, 784, 784, 12), (24, 8, 792, 12),
                                          (32, 8, 264, 16), (1, 294, 294, 12),
                                          (1, 8, 302, 12)])
def test_bf16_cluster_kernels_at_the_paths_shapes(cuda, b, lq, lk, h):
    """448 px's 24×784 and cross 24×8×792, ViT-L/14's cross 32×8×264, a
    224×336 request's 1×294 and cross 1×8×302 (a launch that takes thin
    slabs)."""
    _cluster_matches_plain_and_the_two_pass_kernels(cuda, b, lq, lk, h, seed=lk,
                                                    cross=lq != lk)


def test_bf16_cluster_limit_mirrors_the_library():
    from segclip_tpu_torch.ops.kernels.attention import (BWD_CLUSTER_LIMIT, CLUSTER_LIMIT,
                                                         bwd_cluster_limit, cluster_limit)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert cluster_limit() == CLUSTER_LIMIT and bwd_cluster_limit() == BWD_CLUSTER_LIMIT


@pytest.mark.parametrize("lk", [1024, 1025])
def test_bf16_cluster_route_at_its_limit(cuda, lk):
    """CLUSTER_LIMIT keys take the cluster kernels, one more the long
    forward and the long backward; the cluster functions refuse what they
    do not take."""
    from segclip_tpu_torch.ops.kernels.attention import (
        CLUSTER_LIMIT, attention_bwd_cluster, attention_bwd_long, attention_fwd_cluster,
        attention_fwd_long, fwd_route)
    p, do, q, k, v = _bwd_case(cuda, 1, 17, lk, 2, None, True, seed=lk)
    routes, long = _cluster_routes(), attention_fwd_long.launches
    bwd_long = attention_bwd_long.launches
    attention_bwd(p, do, q, k, v)
    attention(q, k, v)
    inside = int(lk <= CLUSTER_LIMIT)
    assert fwd_route(torch.bfloat16, lk) == ("cluster" if inside else "long")
    assert _cluster_routes() == (routes[0] + inside, routes[1] + inside)
    assert attention_fwd_long.launches == long + 1 - inside
    assert attention_bwd_long.launches == bwd_long + 1 - inside
    if not inside:
        with pytest.raises(ValueError, match="cluster"):
            attention_fwd_cluster(q, k, v)
        with pytest.raises(ValueError, match="cluster"):
            attention_bwd_cluster(p, do, q, k, v)
    q2, k2, v2, _, _, _ = _bf16_case(cuda, 1, 17, 200, 2)
    with pytest.raises(ValueError, match="cluster"):
        attention_fwd_cluster(q2, k2, v2)
    with pytest.raises(ValueError, match="cluster"):
        attention_fwd_cluster(q.float(), k.float(), v.float())


@pytest.mark.parametrize("bias", ["causal", "padding"])
@pytest.mark.parametrize("lq, lk", [(300, 300), (785, 784), (8, 792)])
def test_bf16_cluster_kernels_biases(cuda, bias, lq, lk):
    """Causal bias2d, and padding biasb with one sample padded everywhere but
    its first key, through both cluster kernels."""
    if bias == "causal" and lq != lk:
        lq = lk
    q, k, v, bias2d, biasb, do = _bf16_case(cuda, 3, lq, lk, 2, bias, seed=lk + 1)
    if biasb is not None:
        biasb[1, 1:] = -1e6
    routes = _cluster_routes()
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    grads = attention_bwd(p, do, q, k, v)
    assert _cluster_routes() == (routes[0] + 1, routes[1] + 1)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref)
    _assert_bf16_close(p, p_ref)
    _assert_grads_close(grads, attention_bwd_plain(p, do, q, k, v))


@pytest.mark.parametrize("lk", [300, 784])
def test_bf16_cluster_nearly_uniform_rows(cuda, lk):
    """Rows of nearly equal scores: l close to Lk (past 256, where the
    branch-free division is not used), P held to the plain version's P."""
    gen = torch.Generator(device=cuda).manual_seed(lk)
    q = (torch.randn(2, 70, 128, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    kv = torch.randn(2, lk, 256, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = kv[..., :128], kv[..., 128:]
    routes = _cluster_routes()
    out, p = attention_fwd(q, k, v, save_p=True)
    assert _cluster_routes()[0] == routes[0] + 1
    ref, p_ref = attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert (p_ref.float().amax() * lk).item() < 1.1       # l is within 10 % of Lk
    _assert_bf16_close(p, p_ref)
    _assert_bf16_close(out, ref)


def test_bf16_cluster_fully_masked_row_is_nan_like_the_plain_version(cuda):
    q, k, v, _, _, do = _bf16_case(cuda, 1, 70, 300, 1)
    bias2d = torch.zeros(70, 300, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    out, p = attention_fwd(q, k, v, bias2d, save_p=True)
    ref, _ = attention_fwd_plain(q, k, v, bias2d)
    assert torch.isnan(out[0, 66]).all() and torch.isnan(ref[0, 66]).all()
    assert torch.isnan(p[0, 0, 66]).all()
    full = p.as_strided((1, 1, 70, 304), p.stride())
    assert torch.equal(full[..., 300:], torch.zeros_like(full[..., 300:]))
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    _assert_bf16_close(out[:, keep], ref[:, keep])
    grads = attention_bwd(p, do, q, k, v)
    grads_ref = attention_bwd_plain(p, do, q, k, v)
    assert torch.isnan(grads[0][0, 66]).all() and torch.isfinite(grads[0][:, keep]).all()
    _assert_bf16_close(grads[0][:, keep], grads_ref[0][:, keep])
    for g, r in zip(grads[1:], grads_ref[1:]):
        assert torch.equal(torch.isnan(g), torch.isnan(r))


def test_bf16_cluster_reads_views_in_place_and_repeats_bit_for_bit(cuda):
    """q|k|v column views and the forward's padded P go in without a copy;
    two calls give the same bits in both directions; misaligned operands
    are refused."""
    from segclip_tpu_torch.ops.kernels.attention import (
        _kernel_p, attention_bwd_cluster, attention_fwd_cluster)
    q, k, v, _, _, do = _bf16_case(cuda, 4, 784, 784, 12, seed=9)
    assert q.stride(1) == 3 * q.shape[-1]
    first = attention_fwd_cluster(q, k, v, save_p=True)
    second = attention_fwd_cluster(q, k, v, save_p=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    p = first[1]
    assert _kernel_p(p) is p and p.stride(-2) == 784
    g1 = attention_bwd_cluster(p, do, q, k, v)
    g2 = attention_bwd_cluster(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    for got in (attention_bwd_cluster(p.contiguous(), do, q, k, v),):
        assert all(torch.equal(a, b) for a, b in zip(got, g1))
    x = torch.randn(2, 300, 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd_cluster(x[..., 1:65], x[..., 65:129], x[..., 129:193])
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd_cluster(torch.zeros(2, 1, 300, 300, device=cuda, dtype=torch.bfloat16),
                              torch.zeros(2, 300, 64, device=cuda, dtype=torch.bfloat16),
                              x[..., 1:65], x[..., 65:129], x[..., 129:193])


# The float32 TF32x3 forward (csrc/attention_fwd_tf32x3.cu,
# attention_fwd_tf32x3_kernel: one block per 64-row query tile of one (batch,
# head), fp32-accurate split products on TF32 wgmma, TMA copies): every
# float32 row, of any length, held to the plain version within the float32
# tolerances (2e-5, P 1e-5). The lengths meet every edge of its 64-row
# tiles, 64-key pieces and 8-key steps, its whole-row (≤ 256 keys) and
# chunked paths, and the path's rows (196, 204, 294, 302, 784); the rows
# past 1024 keys have tests of their own below.
TF32_LENGTHS = (1, 3, 7, 8, 9, 63, 64, 65, 196, 204, 256, 257, 294, 302, 784, 1024)


def _f32_case(cuda, b, lq, lk, h, bias=None, seed=0, cross=False):
    """Column views of a packed projection: q|k|v for self attention, q and
    a packed k|v for cross attention; the causal mask (−inf) or padding."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    d = h * 64
    if cross or lq != lk:
        q = torch.randn(b, lq, d, generator=gen, device=cuda)
        kv = torch.randn(b, lk, 2 * d, generator=gen, device=cuda)
        k, v = kv[..., :d], kv[..., d:]
    else:
        qkv = torch.randn(b, lq, 3 * d, generator=gen, device=cuda)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    bias2d = biasb = None
    if bias == "causal":
        bias2d = torch.full((lq, lk), float("-inf"), device=cuda).triu(1)
    elif bias == "padding":
        lens = torch.randint(1, lk + 1, (b, 1), generator=gen, device=cuda)
        biasb = (torch.arange(lk, device=cuda)[None] >= lens).float() * -1e6
    return q, k, v, bias2d, biasb


def _tf32x3_matches_plain(cuda, q, k, v, bias2d=None, biasb=None):
    """One call with P and one without: O and P within the float32
    tolerances of the plain version, O the same bits both ways, P's columns
    [Lk, Lk8) zeros. Returns (out, P)."""
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_tf32x3
    before = attention_fwd_tf32x3.launches
    out, p = attention_fwd_tf32x3(q, k, v, bias2d, biasb, save_p=True)
    bare, none = attention_fwd_tf32x3(q, k, v, bias2d, biasb)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    torch.cuda.synchronize()
    assert attention_fwd_tf32x3.launches == before + 2 and none is None
    assert out.dtype == torch.float32 and out.shape == ref.shape and out.is_contiguous()
    assert (out - ref).abs().max().item() <= ATTN_TOL[torch.float32]
    assert (p - p_ref).abs().max().item() <= 1e-5
    assert torch.equal(out, bare)
    lk = k.shape[1]
    lk8 = (lk + 7) // 8 * 8
    full = p.as_strided((*p.shape[:3], lk8), p.stride())
    assert torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:]))
    return out, p


@pytest.mark.parametrize("h", [1, 4, 6, 12, 16])
@pytest.mark.parametrize("l", TF32_LENGTHS)
def test_tf32x3_self_attention_matches_plain(cuda, l, h):
    _tf32x3_matches_plain(cuda, *_f32_case(cuda, 2, l, l, h, seed=l * 100 + h)[:3])


@pytest.mark.parametrize("lk", TF32_LENGTHS)
@pytest.mark.parametrize("lq", TF32_LENGTHS)
def test_tf32x3_cross_lengths_match_plain(cuda, lq, lk):
    _tf32x3_matches_plain(cuda, *_f32_case(cuda, 2, lq, lk, 2, seed=lq * 2000 + lk,
                                           cross=True)[:3])


@pytest.mark.parametrize("bias", ["causal", "padding"])
@pytest.mark.parametrize("b, l, h", [(4, 77, 8), (96, 32, 8), (2, 196, 12), (2, 300, 2)])
def test_tf32x3_biases_match_plain(cuda, bias, b, l, h):
    _tf32x3_matches_plain(cuda, *_f32_case(cuda, b, l, l, h, bias, seed=l))


@pytest.mark.parametrize("lk", [70, 700])
def test_tf32x3_fully_masked_row_is_nan_like_the_plain_version(cuda, lk):
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_tf32x3
    q, k, v, _, _ = _f32_case(cuda, 1, 70, lk, 1, seed=lk, cross=True)
    bias2d = torch.zeros(70, lk, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    out, p = attention_fwd_tf32x3(q, k, v, bias2d, save_p=True)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d)
    assert torch.isnan(out[0, 66]).all() and torch.isnan(ref[0, 66]).all()
    assert torch.isnan(p[0, 0, 66]).all() and torch.isnan(p_ref[0, 0, 66]).all()
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    assert (out[:, keep] - ref[:, keep]).abs().max().item() <= ATTN_TOL[torch.float32]
    assert (p[:, :, keep] - p_ref[:, :, keep]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("lq, lk", [(196, 196), (8, 204), (294, 294), (8, 302)])
def test_tf32x3_rows_do_not_depend_on_the_batch(cuda, lq, lk):
    """Each (batch, head) row of a batch of 8 is the same bits as the row of
    that element alone (the float32 batched-decode contract), and two calls
    give the same bits."""
    from segclip_tpu_torch.ops.kernels.attention import attention_fwd_tf32x3
    q, k, v, _, _ = _f32_case(cuda, 8, lq, lk, 12, seed=lk, cross=lq != lk)
    out, p = attention_fwd_tf32x3(q, k, v, save_p=True)
    again = attention_fwd_tf32x3(q, k, v, save_p=True)
    assert torch.equal(out, again[0]) and torch.equal(p, again[1])
    for i in range(8):
        one, p_one = attention_fwd_tf32x3(q[i:i + 1], k[i:i + 1], v[i:i + 1], save_p=True)
        assert torch.equal(one, out[i:i + 1]) and torch.equal(p_one, p[i:i + 1])


def test_tf32x3_reads_packed_views_in_place_and_refuses_misaligned_operands(cuda):
    """q|k|v column views of a packed projection give the bits of contiguous
    copies (read by their row strides, no copy); the float32 backward reads
    the padded P as it is; misaligned operands are refused."""
    from segclip_tpu_torch.ops.kernels.attention import _kernel_p, attention_fwd_tf32x3
    q, k, v, _, _ = _f32_case(cuda, 4, 196, 196, 12, seed=3)
    assert q.stride(1) == 3 * q.shape[-1]
    out, p = attention_fwd_tf32x3(q, k, v, save_p=True)
    copies = attention_fwd_tf32x3(q.contiguous(), k.contiguous(), v.contiguous(), save_p=True)
    assert torch.equal(out, copies[0]) and torch.equal(p, copies[1])
    assert _kernel_p(p) is p and p.stride() == (12 * 196 * 200, 196 * 200, 200, 1)
    do = torch.randn_like(out)
    grads = attention_bwd(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(grads, attention_bwd(p.contiguous(), do, q, k, v)))
    x = torch.randn(2, 9, 3 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd_tf32x3(x[..., 1:65], x[..., 65:129], x[..., 129:193])
    with pytest.raises(ValueError, match="16-byte"):
        attention(x[..., 1:65], x[..., 65:129], x[..., 129:193])


@pytest.mark.parametrize("lk", [1024, 1025])
def test_float32_forward_route_at_the_limit(cuda, lk):
    """`attention_fwd` sends float32 rows on either side of 1024 keys to the
    TF32x3 kernel, which has no length limit; no route reaches the SIMT
    two-pass kernel."""
    from segclip_tpu_torch.ops.kernels.attention import (attention_fwd_tf32x3,
                                                         attention_fwd_two_pass)
    q, k, v, _, _ = _f32_case(cuda, 1, 40, lk, 2, seed=lk, cross=True)
    routes = (attention_fwd_tf32x3.launches, attention_fwd_two_pass.launches)
    out, p = attention_fwd(q, k, v, save_p=True)
    moved = (attention_fwd_tf32x3.launches - routes[0], attention_fwd_two_pass.launches - routes[1])
    assert moved == (1, 0)
    ref, p_ref = attention_fwd_plain(q, k, v)
    assert (out - ref).abs().max().item() <= ATTN_TOL[torch.float32]
    assert (p - p_ref).abs().max().item() <= 1e-5


# Rows past 1024 keys (whole-image requests over 1024 patches): the bf16 long
# forward (csrc/attention_fwd_long.cu, attention_fwd_long_kernel: two passes
# over 64-key pieces streamed by TMA, two warpgroups per 64-row query tile,
# wgmma) and the float32 TF32x3 forward past its old 1024-key limit. Each case
# holds the routed call (which must take the kernel) to the plain version
# (bf16: the share rule; float32: 2e-5, P 1e-5), O to the same bits with and
# without P, P's padding columns to zero, and the bf16 kernel to PR 3's
# two-pass kernel on the same inputs by the same rules.
LONG_MAIN_PATH = [               # (B, Lq, Lk, H, cross): 448x672 and 224x2048 whole requests
    (1, 1176, 1176, 12, False), (1, 8, 1184, 12, True), (1, 1792, 1792, 12, False),
    (1, 8, 1800, 12, True)]
LONG_EDGES = [                   # Lq ragged against the 64-row tiles, Lk against the pieces
    (2, lq, lk, 2, True) for lq in (1, 8, 63, 65, 130) for lk in (1025, 1087, 1088, 1089, 2049)]


def _long_case(cuda, dtype, b, lq, lk, h, cross, seed, bias=None):
    if dtype == torch.float32:
        return _f32_case(cuda, b, lq, lk, h, bias, seed=seed, cross=cross)
    return _one_pass_case(cuda, b, lq, lk, h, bias, cross, seed)


def _long_matches_plain(q, k, v, bias2d=None, biasb=None):
    from segclip_tpu_torch.ops.kernels.attention import (attention_fwd_long,
                                                         attention_fwd_tf32x3,
                                                         attention_fwd_two_pass)
    bf16 = q.dtype == torch.bfloat16
    routed = attention_fwd_long if bf16 else attention_fwd_tf32x3
    before = routed.launches
    out, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    bare, none = routed(q, k, v, bias2d, biasb)
    assert routed.launches == before + 2 and none is None
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d, biasb)
    torch.cuda.synchronize()
    assert torch.equal(out, bare) and torch.isfinite(out).all()
    pairs = [(out, ref), (p, p_ref)]
    if bf16:
        pairs += list(zip(attention_fwd_two_pass(q, k, v, bias2d, biasb, save_p=True),
                          (ref, p_ref)))
        for got, want in pairs:
            assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[torch.bfloat16]
            _assert_bf16_close(got, want)
    else:
        assert (out - ref).abs().max().item() <= ATTN_TOL[torch.float32]
        assert (p - p_ref).abs().max().item() <= 1e-5
    lk = k.shape[1]
    full = p.as_strided((*p.shape[:3], (lk + 7) // 8 * 8), p.stride())
    assert torch.equal(full[..., lk:], torch.zeros_like(full[..., lk:]))
    return out, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, lq, lk, h, cross", LONG_MAIN_PATH + LONG_EDGES)
def test_long_rows_match_plain(cuda, dtype, b, lq, lk, h, cross):
    _long_matches_plain(*_long_case(cuda, dtype, b, lq, lk, h, cross, seed=lq * 3 + lk)[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", ["causal", "padding"])
def test_long_rows_biases(cuda, dtype, bias):
    """Causal bias2d, and padding biasb with one sample padded everywhere but
    its first key."""
    q, k, v, bias2d, biasb = _long_case(cuda, dtype, 3, 1100, 1100, 2, False, seed=11,
                                        bias=bias)[:5]
    if biasb is not None:
        biasb[1, 1:] = -1e6
    _long_matches_plain(q, k, v, bias2d, biasb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_rows_fully_masked_row_is_nan_like_the_plain_version(cuda, dtype):
    q, k, v = _long_case(cuda, dtype, 1, 70, 1100, 1, True, seed=5)[:3]
    bias2d = torch.zeros(70, 1100, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    out, p = attention_fwd(q, k, v, bias2d, save_p=True)
    ref, p_ref = attention_fwd_plain(q, k, v, bias2d)
    assert torch.isnan(out[0, 66]).all() and torch.isnan(ref[0, 66]).all()
    assert torch.isnan(p[0, 0, 66].float()).all()
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    assert (out[:, keep].float() - ref[:, keep].float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq, lk", [(1176, 1176), (8, 1184)])
def test_long_rows_do_not_depend_on_the_batch(cuda, dtype, lq, lk):
    """Each (batch, head) row of a batch of 3 is the same bits as the row of
    that element alone, and two calls give the same bits."""
    q, k, v = _long_case(cuda, dtype, 3, lq, lk, 12, lq != lk, seed=lk)[:3]
    out, p = attention_fwd(q, k, v, save_p=True)
    again = attention_fwd(q, k, v, save_p=True)
    assert torch.equal(out, again[0]) and torch.equal(p, again[1])
    for i in range(3):
        one, p_one = attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], save_p=True)
        assert torch.equal(one, out[i:i + 1]) and torch.equal(p_one, p[i:i + 1])


def test_long_kernel_limit_and_refusals(cuda):
    """The library's lower limit is LONG_MIN_LK, one past the cluster
    kernel's; the long function refuses shorter rows, float32 and
    misaligned views."""
    from segclip_tpu_torch.ops.kernels.attention import (CLUSTER_LIMIT, LONG_MIN_LK,
                                                         attention_fwd_long, cluster_limit,
                                                         long_min_lk)
    assert long_min_lk() == LONG_MIN_LK == cluster_limit() + 1 == CLUSTER_LIMIT + 1
    q, k, v = _long_case(cuda, torch.bfloat16, 1, 17, 1024, 2, True, seed=1)[:3]
    with pytest.raises(ValueError, match="long"):
        attention_fwd_long(q, k, v)
    q, k, v = _long_case(cuda, torch.bfloat16, 1, 17, 1100, 2, True, seed=1)[:3]
    with pytest.raises(ValueError, match="long"):
        attention_fwd_long(q.float(), k.float(), v.float())
    x = torch.randn(1, 1100, 3 * 64 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd_long(x[..., 1:65], x[..., 65:129], x[..., 129:193])


def test_division_is_ieee_over_the_rows_lengths(cuda):
    """hopper.cuh's branch-free div_normal equals IEEE `/` bit for bit over
    every significand of l in [1, 2) at 2^0, 2^10 and 2^13 (rows of up to
    16384 keys), p random in [2^-100, 1]."""
    from segclip_tpu_torch.ops.kernels.attention import division_check
    gen = torch.Generator(device=cuda).manual_seed(0)
    sig = 1 + torch.arange(2 ** 23, device=cuda, dtype=torch.float64) / 2 ** 23
    for e in (0, 10, 13):
        l = (sig * 2.0 ** e).float()
        p = torch.exp2(-100 * torch.rand(l.shape, generator=gen, device=cuda))
        fast, ieee = division_check(p, l)
        assert torch.equal(fast.view(torch.int32), ieee.view(torch.int32))


# The float32 TF32x3 backward (csrc/attention_bwd_tf32x3.cu,
# attention_bwd_tf32x3_kernel: clusters of ⌈Lk/64⌉ blocks walking the (batch,
# head) rows, each block one 64-key slab, D and dQ summed across the cluster
# in rank order, fp32-accurate split products on TF32 wgmma, TMA copies):
# every float32 backward of up to BWD_TF32X3_LIMIT keys. Each case runs the
# routed call (which must take the TF32x3 kernel), the kernel's own function
# (the same bits) and the SIMT pair on the same inputs, and holds both to
# the plain version at the float32 backward tolerance, per output max |err|
# ≤ 1e-5·(1 + max|ref|).
BWD_F32_TOL = 1e-5
BWD_TF32_MAIN_PATH = [           # (B, Lq, Lk, H, bias, cross): the B = 96 step, a TP rank,
    (96, 196, 196, 12, None, False), (96, 8, 204, 12, None, True),       # ViT-B/32, the drift
    (96, 8, 8, 12, None, False), (96, 48, 48, 12, None, False), (96, 8, 56, 12, None, True),
    (96, 32, 32, 8, "causal", False), (48, 196, 196, 12, None, False),
    (96, 196, 196, 6, None, False), (96, 8, 204, 6, None, True), (48, 32, 32, 4, "causal", False),
    (96, 49, 49, 12, None, False), (96, 8, 57, 12, None, True), (8, 3, 3, 1, None, False)]
BWD_TF32_EDGES = [               # Lq ragged against the 64-row tiles, Lk against the 64-key slabs
    (2, lq, lk, 2, None, True)
    for lq in (1, 8, 63, 65, 130) for lk in (1, 63, 64, 65, 255, 256)]


def _bwd_f32_routes():
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_tf32x3,
                                                         attention_bwd_two_pass)
    return attention_bwd_tf32x3.launches, attention_bwd_two_pass.launches


def _bwd_f32_case(cuda, b, lq, lk, h, bias, cross, seed):
    q, k, v, bias2d, biasb = _f32_case(cuda, b, lq, lk, h, bias, seed=seed, cross=cross)
    _, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    do = torch.randn(b, lq, h * 64, generator=gen, device=cuda)
    return p, do, q, k, v


def _assert_f32_grads_close(grads, ref):
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape and g.is_contiguous()
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= BWD_F32_TOL * (1 + r.abs().max().item())


@pytest.mark.parametrize("b, lq, lk, h, bias, cross", BWD_TF32_MAIN_PATH + BWD_TF32_EDGES)
def test_tf32x3_bwd_matches_plain_and_the_simt_pair(cuda, b, lq, lk, h, bias, cross):
    from segclip_tpu_torch.ops.kernels.attention import (
        BWD_TF32X3_LIMIT, attention_bwd_tf32x3, attention_bwd_two_pass, bwd_tf32x3_limit)
    assert bwd_tf32x3_limit() == BWD_TF32X3_LIMIT
    p, do, q, k, v = _bwd_f32_case(cuda, b, lq, lk, h, bias, cross, seed=lq * 11 + lk + h)
    before, routes = attention_bwd.launches, _bwd_f32_routes()
    grads = attention_bwd(p, do, q, k, v)
    assert attention_bwd.launches == before + 1
    assert _bwd_f32_routes() == (routes[0] + 1, routes[1])
    own = attention_bwd_tf32x3(p, do, q, k, v)
    simt = attention_bwd_two_pass(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    torch.cuda.synchronize()
    assert _bwd_f32_routes() == (routes[0] + 2, routes[1] + 1)
    assert all(torch.equal(g, o) for g, o in zip(grads, own))
    _assert_f32_grads_close(grads, ref)
    _assert_f32_grads_close(simt, ref)


@pytest.mark.parametrize("bias", ["causal", "padding"])
@pytest.mark.parametrize("b, l, h", [(4, 77, 8), (96, 32, 8), (2, 196, 12), (3, 256, 2)])
def test_tf32x3_bwd_biases(cuda, bias, b, l, h):
    p, do, q, k, v = _bwd_f32_case(cuda, b, l, l, h, bias, False, seed=l + h)
    _assert_f32_grads_close(attention_bwd(p, do, q, k, v), attention_bwd_plain(p, do, q, k, v))


@pytest.mark.parametrize("lk", [100, 256])
def test_tf32x3_bwd_fully_masked_row_is_nan_like_the_plain_version(cuda, lk):
    """A row whose every key is masked has P = NaN: dQ's row is NaN, the
    other rows of dQ within the tolerance, and dK and dV NaN wherever the
    plain version's are."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_tf32x3
    q, k, v, _, _ = _f32_case(cuda, 1, 70, lk, 1, seed=lk, cross=True)
    bias2d = torch.zeros(70, lk, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    _, p = attention_fwd(q, k, v, bias2d, save_p=True)
    do = torch.randn_like(q)
    grads = attention_bwd_tf32x3(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    assert torch.isnan(grads[0][0, 66]).all() and torch.isnan(ref[0][0, 66]).all()
    rows = grads[0][:, keep]
    assert (rows - ref[0][:, keep]).abs().max().item() <= BWD_F32_TOL * (
        1 + ref[0][:, keep].abs().max().item())
    for g, r in zip(grads[1:], ref[1:]):
        assert torch.equal(torch.isnan(g), torch.isnan(r))


@pytest.mark.parametrize("lq, lk", [(196, 196), (8, 204), (65, 256), (48, 48)])
def test_tf32x3_bwd_repeats_bit_for_bit_and_rows_do_not_depend_on_the_batch(cuda, lq, lk):
    """Two calls give the same bits (no atomics; D and dQ summed in rank
    order), and each (batch, head) row of a batch of 8 is the bits of that
    element alone, whichever cluster of the persistent grid takes it."""
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_tf32x3
    p, do, q, k, v = _bwd_f32_case(cuda, 8, lq, lk, 12, None, lq != lk, seed=lk)
    first = attention_bwd_tf32x3(p, do, q, k, v)
    second = attention_bwd_tf32x3(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for i in (0, 5):
        one = attention_bwd_tf32x3(p[i:i + 1], do[i:i + 1], q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(one, first))


@pytest.mark.parametrize("kind", ["p offset", "p swapped", "do offset", "do expanded"])
def test_tf32x3_bwd_copies_a_p_or_do_it_cannot_read_in_place(cuda, kind):
    """A P or dO the TMA cannot read (a base off 16 bytes, batch and head
    dims that are not one (B·H) dim, a zero stride) is copied, not refused,
    and gives the bits of contiguous operands."""
    from segclip_tpu_torch.ops.kernels.attention import (_kernel_do, _kernel_p,
                                                         attention_bwd_tf32x3)
    p, do, q, k, v = _bwd_f32_case(cuda, 2, 40, 70, 2, None, True, seed=9)
    want = attention_bwd_tf32x3(p.contiguous(), do.contiguous(), q, k, v)
    if kind == "p offset":
        buf = torch.zeros(p.numel() + 1, device=cuda)
        odd = buf[1:].view(p.shape).copy_(p)
        assert _kernel_p(odd, True) is not odd
        got = attention_bwd_tf32x3(odd, do, q, k, v)
    elif kind == "p swapped":
        swapped = p.transpose(0, 1).contiguous().transpose(0, 1)
        assert _kernel_p(swapped, True) is not swapped
        got = attention_bwd_tf32x3(swapped, do, q, k, v)
    elif kind == "do offset":
        buf = torch.zeros(do.numel() + 1, device=cuda)
        odd = buf[1:].view(do.shape).copy_(do)
        assert _kernel_do(odd, True) is not odd
        got = attention_bwd_tf32x3(p, odd, q, k, v)
    else:
        ones = torch.ones(1, 1, 1, device=cuda).expand(do.shape)
        want = attention_bwd_tf32x3(p, ones.contiguous(), q, k, v)
        got = attention_bwd_tf32x3(p, ones, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("lk", [256, 257])
def test_float32_backward_route_at_the_limit(cuda, lk):
    """Lk at BWD_TF32X3_LIMIT takes the TF32x3 backward, one past it the
    TF32x3 long backward (never the SIMT pair); the TF32x3 function refuses
    what it does not take."""
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_tf32x3,
                                                         attention_bwd_tf32x3_long)
    p, do, q, k, v = _bwd_f32_case(cuda, 2, 33, lk, 2, None, True, seed=lk)
    routes, long = _bwd_f32_routes(), attention_bwd_tf32x3_long.launches
    grads = attention_bwd(p, do, q, k, v)
    moved = tuple(a - b for a, b in zip(_bwd_f32_routes(), routes))
    assert moved == ((1, 0) if lk <= 256 else (0, 0))
    assert attention_bwd_tf32x3_long.launches == long + int(lk > 256)
    _assert_f32_grads_close(grads, attention_bwd_plain(p, do, q, k, v))
    if lk > 256:
        with pytest.raises(ValueError, match="at most 256 keys"):
            attention_bwd_tf32x3(p, do, q, k, v)
    with pytest.raises(ValueError, match="float32 rows"):
        attention_bwd_tf32x3(*(t.to(torch.bfloat16) for t in (p, do, q, k, v)))
    x = torch.randn(2, 9, 3 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd_tf32x3(torch.zeros(2, 1, 9, 9, device=cuda), torch.zeros(2, 9, 64, device=cuda),
                             x[..., 1:65], x[..., 65:129], x[..., 129:193])


# The long-row backwards (csrc/attention_bwd_long.cu: a row pass for D and
# dQ per 64-row query tile, then a slab pass for dK and dV per key slab):
# bf16 rows past BWD_CLUSTER_LIMIT ("long") and float32 rows past
# BWD_TF32X3_LIMIT ("tf32x3_long"), each routed call held to the plain
# version (bf16: the share rule; float32: 1e-5·(1 + max|ref|)) and beside
# it the two-pass pair it replaced (the mma.sync pair, the SIMT pair) by
# the same rules. The shapes are the main path's (the 672 px step's 4×1764
# and cross 4×8×1772; a 448×672 request's 1176; the float32 ViT-L/14 cross
# rows 2×8×264 at H = 16, the float32 448 px step's 2×784 and cross 2×8×792)
# and rows ragged against the 64-row tiles, the 64-key pieces and the
# 128-key slabs.
BWD_LONG_MAIN_PATH = [           # (dtype, B, Lq, Lk, H, cross)
    (torch.bfloat16, 4, 1764, 1764, 12, False), (torch.bfloat16, 4, 8, 1772, 12, True),
    (torch.bfloat16, 1, 1176, 1176, 12, False), (torch.float32, 2, 8, 264, 16, True),
    (torch.float32, 2, 784, 784, 12, False), (torch.float32, 2, 8, 792, 12, True)]
BWD_LONG_EDGES = (
    [(torch.bfloat16, 2, lq, lk, 2, True) for lq in (1, 8, 63, 65, 130)
     for lk in (1025, 1087, 1088, 1089, 1153, 2049)]
    + [(torch.float32, 2, lq, lk, 2, True) for lq in (1, 8, 63, 65, 130)
       for lk in (257, 287, 288, 289, 320, 321, 1025)])


def _bwd_long_case(cuda, dtype, b, lq, lk, h, cross, seed, bias=None):
    q, k, v, bias2d, biasb = _long_case(cuda, dtype, b, lq, lk, h, cross, seed, bias)[:5]
    _, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    do = torch.randn(b, lq, h * 64, generator=gen, device=cuda).to(dtype)
    return p, do, q, k, v


def _assert_long_grads_close(grads, ref):
    if grads[0].dtype == torch.float32:
        _assert_f32_grads_close(grads, ref)
    else:
        _assert_grads_close(grads, ref)


def _long_fn(dtype):
    from segclip_tpu_torch.ops.kernels.attention import (attention_bwd_long,
                                                         attention_bwd_tf32x3_long)
    return attention_bwd_long if dtype == torch.bfloat16 else attention_bwd_tf32x3_long


@pytest.mark.parametrize("dtype, b, lq, lk, h, cross", BWD_LONG_MAIN_PATH + BWD_LONG_EDGES)
def test_long_bwd_matches_plain_and_the_two_pass_pair(cuda, dtype, b, lq, lk, h, cross):
    from segclip_tpu_torch.ops.kernels.attention import attention_bwd_two_pass
    p, do, q, k, v = _bwd_long_case(cuda, dtype, b, lq, lk, h, cross, seed=lq * 7 + lk)
    fn = _long_fn(dtype)
    before, two_before = fn.launches, attention_bwd_two_pass.launches
    grads = attention_bwd(p, do, q, k, v)
    assert fn.launches == before + 1 and attention_bwd_two_pass.launches == two_before
    own = fn(p, do, q, k, v)
    two = attention_bwd_two_pass(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    torch.cuda.synchronize()
    assert all(torch.equal(g, o) for g, o in zip(grads, own))
    _assert_long_grads_close(grads, ref)
    _assert_long_grads_close(two, ref)


@pytest.mark.parametrize("dtype, l", [(torch.bfloat16, 1100), (torch.float32, 300)])
@pytest.mark.parametrize("bias", ["causal", "padding"])
def test_long_bwd_biases(cuda, dtype, l, bias):
    """Causal bias2d, and padding biasb with one sample padded everywhere but
    its first key."""
    q, k, v, bias2d, biasb = _long_case(cuda, dtype, 3, l, l, 2, False, seed=l, bias=bias)[:5]
    if biasb is not None:
        biasb[1, 1:] = -1e6
    _, p = attention_fwd(q, k, v, bias2d, biasb, save_p=True)
    do = torch.randn_like(q)
    _assert_long_grads_close(attention_bwd(p, do, q, k, v), attention_bwd_plain(p, do, q, k, v))


@pytest.mark.parametrize("dtype, lk", [(torch.bfloat16, 1100), (torch.float32, 300)])
def test_long_bwd_fully_masked_row_is_nan_like_the_plain_version(cuda, dtype, lk):
    """A row whose every key is masked has P = NaN: dQ's row is NaN, the
    other rows of dQ within the tolerance, and dK and dV NaN wherever the
    plain version's are."""
    q, k, v = _long_case(cuda, dtype, 1, 70, lk, 1, True, seed=lk)[:3]
    bias2d = torch.zeros(70, lk, device=cuda)
    bias2d[66] = float("-inf")                     # a row of the second query tile
    _, p = attention_fwd(q, k, v, bias2d, save_p=True)
    do = torch.randn_like(q)
    grads = _long_fn(dtype)(p, do, q, k, v)
    ref = attention_bwd_plain(p, do, q, k, v)
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[66] = False
    assert torch.isnan(grads[0][0, 66].float()).all() and torch.isnan(ref[0][0, 66].float()).all()
    rows, want = grads[0][:, keep].float(), ref[0][:, keep].float()
    if dtype == torch.float32:
        assert (rows - want).abs().max().item() <= BWD_F32_TOL * (1 + want.abs().max().item())
    else:
        _assert_bf16_close(grads[0][:, keep], ref[0][:, keep])
    for g, r in zip(grads[1:], ref[1:]):
        assert torch.equal(torch.isnan(g), torch.isnan(r))


@pytest.mark.parametrize("dtype, lq, lk", [(torch.bfloat16, 1176, 1176),
                                           (torch.bfloat16, 8, 1184),
                                           (torch.float32, 300, 300), (torch.float32, 8, 264)])
def test_long_bwd_repeats_bit_for_bit_and_rows_do_not_depend_on_the_batch(cuda, dtype, lq, lk):
    """Two calls give the same bits (no atomics, every sum in a fixed
    order), and each (batch, head) row of a batch of 3 is the bits of that
    element alone."""
    p, do, q, k, v = _bwd_long_case(cuda, dtype, 3, lq, lk, 4, lq != lk, seed=lk)
    fn = _long_fn(dtype)
    first, second = fn(p, do, q, k, v), fn(p, do, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for i in (0, 2):
        one = fn(p[i:i + 1], do[i:i + 1], q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(one, first))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_long_bwd_limits_and_refusals(cuda, dtype):
    """The library's lower limits are BWD_LONG_MIN_LK and
    BWD_TF32X3_LONG_MIN_LK, one past the cluster and TF32x3 backwards';
    each long function refuses shorter rows and the other dtype; a P the
    TMA cannot read is copied and gives the bits of a contiguous one."""
    from segclip_tpu_torch.ops.kernels import attention as kattn
    route = "long" if dtype == torch.bfloat16 else "tf32x3_long"
    assert kattn.bwd_long_min_lk("long") == kattn.BWD_LONG_MIN_LK == kattn.bwd_cluster_limit() + 1
    assert (kattn.bwd_long_min_lk("tf32x3_long") == kattn.BWD_TF32X3_LONG_MIN_LK
            == kattn.bwd_tf32x3_limit() + 1)
    fn, lk = _long_fn(dtype), kattn.bwd_long_min_lk(route)
    p, do, q, k, v = _bwd_long_case(cuda, dtype, 2, 9, lk - 1, 2, True, seed=3)
    with pytest.raises(ValueError, match=route):
        fn(p, do, q, k, v)
    p, do, q, k, v = _bwd_long_case(cuda, dtype, 2, 9, lk, 2, True, seed=3)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match=route):
        fn(*(t.to(other) for t in (p, do, q, k, v)))
    swapped = p.transpose(0, 1).contiguous().transpose(0, 1)
    assert all(torch.equal(a, b) for a, b in zip(fn(swapped, do, q, k, v),
                                                 fn(p.contiguous(), do, q, k, v)))
