"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker `gpu`) and skips without one; on
the card (H100, sm_90a) run them with

    python -m pytest tests/test_torch_kernels.py -q -m gpu

The first test builds the kernels with nvcc. Tolerances, kernel against
plain on the same inputs, with bf16 distances in ulps of the plain value
(segclip_tpu_torch/ops/kernels/checks.py): attention max |err| 2e-5 at
float32; at bfloat16 at most a share ATTN_BF16_SHARE of outputs more than one
ulp apart and max |err| 2e-2, and the rounded-P case equal bit for bit;
grouping soft 1e-4, out 1e-5 at float32 and within one ulp at bfloat16, hard
equal away from near-tie patches (top-2 logit margin < 1e-3).
"""
import pytest
import torch

from segclip_tpu_torch.ops.kernels.attention import attention, attention_plain
from segclip_tpu_torch.ops.kernels.checks import (ATTN_BF16_SHARE, bf16_ulps,
                                                  rounded_p_case)
from segclip_tpu_torch.ops.kernels.grouping import group_assign, group_assign_plain

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
    x = torch.randn(1, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        group_assign(torch.randn(1, 33, 64, device=cuda), x, x)
    with pytest.raises(ValueError):
        group_assign(x[:, :2], x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError):
        group_assign(torch.randn(1, 8, 8192, device=cuda),
                     torch.randn(1, 4, 8192, device=cuda),
                     torch.randn(1, 4, 8192, device=cuda))
