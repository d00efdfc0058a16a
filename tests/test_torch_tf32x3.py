"""The float32 TF32x3 attention forward (csrc/attention_fwd_tf32x3.cu) on the
CPU: its arithmetic, its operand layout and its route.

The kernel runs only on the card (tests/test_torch_kernels.py holds it to the
plain version there). Here a torch emulation of its arithmetic, kept in this
file and not in the package, writes down the error budget before any chip
run: each operand split as x = hi + lo, hi = TF32 rounding of x (to nearest,
ties away, from the float32 bits, as `cvt.rna.tf32.f32`), lo = the TF32
rounding of x − hi; each product lo·hi + hi·lo + hi·hi, 8-wide k-steps
summed into a float32 accumulator in the kernel's order; the softmax in
float32 with the kernel's chunks of four 64-key pieces, each chunk's pieces
shared by two warpgroups whose partials are summed (rows past 256 keys: m
and l online over the chunks in order, the kernel's pass 1). At the float32
shapes of chip_smoke.py's phase 1 (batch cut to 2: the kernel's rows do not
depend on one another), and at its rows past 1024 keys (a 448×672 image's
1176 and cross 1184, a 224×2048 image's 1792 and cross 1800; batch cut to
1, the vision rows' heads to 2), it holds O within 2e-6 and P within 1e-6
of a float64 reference, a tenth of the card's tolerances (2e-5 and 1e-5),
where a single TF32 product (hi·hi alone) does not. The kernel splits no
row across blocks, so there is no cross-block combination to emulate.
"""
import re

import numpy as np
import pytest
import torch

from segclip_tpu_torch.ops.kernels import attention as kattn

O_BUDGET = 2e-6
P_BUDGET = 1e-6
PIECES_IN_REGISTERS = 4          # 64-key pieces of a chunk (MAX_NC)

# (name, Lq, Lk, H, bias[, B]): phase 1's float32 shapes, B = 2 unless given.
SHAPES = [
    ("train vision 96x196", 196, 196, 12, None),
    ("train TP vision 96x196 H6", 196, 196, 6, None),
    ("train cross 96x8x204", 8, 204, 12, None),
    ("train MAE vision 96x48", 48, 48, 12, None),
    ("train MAE cross 96x8x56", 8, 56, 12, None),
    ("train text 96x32 causal", 32, 32, 8, "causal"),
    ("train group stage 96x8x8", 8, 8, 12, None),
    ("eval vision 2x196", 196, 196, 12, None),
    ("eval cross 2x8x204", 8, 204, 12, None),
    ("eval text 20x77 causal", 77, 77, 8, "causal"),
    ("eval vision 1x294", 294, 294, 12, None),
    ("eval cross 1x8x302", 8, 302, 12, None),
    ("drift MAE one head L=3", 3, 3, 1, None),
    # whole-image requests past 1024 patches (chip_smoke phase 2's 448x672
    # and 224x2048), B = 1; the vision rows' 12 heads cut to 2
    ("eval vision 1x1176", 1176, 1176, 2, None, 1),
    ("eval cross 1x8x1184", 8, 1184, 12, None, 1),
    ("eval vision 1x1792", 1792, 1792, 2, None, 1),
    ("eval cross 1x8x1800", 8, 1800, 12, None, 1),
]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as float32 whose lower 13 bits are zero."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    out = (u & 0x80000000) | mag
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def products(a: torch.Tensor, b: torch.Tensor, terms: int = 3, pv: bool = False,
             acc: torch.Tensor = None) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the kernel's wgmma chain, each 8-wide
    k-step's product added to the float32 accumulator `acc` (zeros if None);
    K is padded to 8 with zeros. Q·Kᵀ (pv False): per k-step lo·hi, hi·lo,
    hi·hi. P·V (pv True), per 64-key piece: hi·lo and hi·hi over its k-steps,
    then lo·hi over them. terms = 1: hi·hi alone."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    if acc is None:
        acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for p0 in range(0, a.shape[-1], 64):
        steps = [slice(k0, k0 + 8) for k0 in range(p0, min(p0 + 64, a.shape[-1]), 8)]
        if terms == 1:
            order = [(ah, bh, ks) for ks in steps]
        elif pv:
            order = [x for ks in steps for x in ((ah, bl, ks), (ah, bh, ks))]
            order += [(al, bh, ks) for ks in steps]
        else:
            order = [x for ks in steps for x in ((al, bh, ks), (ah, bl, ks), (ah, bh, ks))]
        for x, y, ks in order:
            acc = acc + x[..., ks] @ y[..., ks, :]
    return acc


def emulate(q, k, v, bias, scale, terms: int = 3):
    """The kernel's forward on (B, H, L, 64) float32 operands: (O, P). Rows
    go in chunks of up to four 64-key pieces, two warpgroups taking half a
    chunk's pieces each: the row max and sum are their partials combined
    (rows past 256 keys: m and l online over the chunks), and O is the sum
    of their P·V partials, warpgroup 0's first."""
    s = products(q, k.transpose(-1, -2), terms) * scale
    if bias is not None:
        s = s + bias
    lk = s.shape[-1]
    nc = min(PIECES_IN_REGISTERS, -(-lk // 64))
    halves = [(c0 + w * 64 * ((nc + 1) // 2), min(c0 + (w + 1) * 64 * ((nc + 1) // 2),
                                                   c0 + 64 * nc, lk))
              for c0 in range(0, lk, 64 * nc) for w in (0, 1)]

    def sums(x, c=0):                             # chunk c: warpgroup 0's partial + warpgroup 1's
        (a0, a1), (b0, b1) = halves[2 * c], halves[2 * c + 1]
        return x[..., a0:a1].sum(-1, keepdim=True) + x[..., b0:b1].sum(-1, keepdim=True)
    if lk <= 64 * nc:                              # one chunk: the whole row
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        p = p / sums(p)
    else:                                          # m and l online over the chunks, in order
        m = torch.full(s.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        for c in range(len(halves) // 2):
            c0 = halves[2 * c][0]
            m_new = torch.maximum(m, s[..., c0:c0 + 64 * nc].amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + sums(torch.exp(s - m_new), c)
            m = m_new
        p = torch.exp(s - m) / l
    o = [None, None]
    for i, (k0, k1) in enumerate(halves):
        if k0 < k1:
            o[i % 2] = products(p[..., k0:k1], v[..., k0:k1, :], terms, pv=True, acc=o[i % 2])
    return o[0] if o[1] is None else o[0] + o[1], p


def phase1_inputs(lq, lk, h, bias, seed, b=2):
    """Standard normal q|k|v as phase 1 draws them (numpy here), split into
    (B, H, L, 64) heads; the causal mask as ops.attention.causal_mask."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, 64)).astype(np.float32))
               for n in (lq, lk, lk))
    mask = None
    if bias == "causal":
        mask = torch.full((lq, lk), float("-inf")).triu(1)
    return q, k, v, mask


def reference(q, k, v, bias, scale):
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s, -1)
    return p @ v.double(), p


@pytest.mark.parametrize("name, lq, lk, h, bias, b", [(*c, 2)[:6] for c in SHAPES],
                         ids=[c[0] for c in SHAPES])
def test_split_products_hold_a_tenth_of_the_float32_tolerances(name, lq, lk, h, bias, b):
    q, k, v, mask = phase1_inputs(lq, lk, h, bias, seed=lq * 1000 + lk + h, b=b)
    scale = 64 ** -0.5
    ref, p_ref = reference(q, k, v, mask, scale)
    out, p = emulate(q, k, v, mask, scale)
    o_err = (out.double() - ref).abs().max().item()
    p_err = (p.double() - p_ref).abs().max().item()
    assert o_err <= O_BUDGET and p_err <= P_BUDGET, (name, o_err, p_err)
    one, p_one = emulate(q, k, v, mask, scale, terms=1)
    o_one = (one.double() - ref).abs().max().item()
    p_one = (p_one.double() - p_ref).abs().max().item()
    assert o_one > O_BUDGET and p_one > P_BUDGET, (name, o_one, p_one)


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulation's split is `cvt.rna.tf32.f32`: 13 low bits cleared,
    rounded to nearest with ties away from zero, and hi + lo within 2^-22
    of x."""
    one = 1.0 + 2.0 ** -10                      # a TF32 value
    tie = 1.0 + 2.0 ** -11                      # half-way between 1 and `one`
    x = torch.tensor([1.0, one, tie, -tie, 1.0 + 2.0 ** -12, 3.0e-5, -7.25], dtype=torch.float32)
    hi = tf32_rna(x)
    assert hi.tolist()[:5] == [1.0, one, one, -one, 1.0]
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split(x)
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


def test_key_permutation_leaves_p_v_unchanged():
    """P's accumulator holds keys {2t, 2t + 1} of each 8-key step in thread t
    (lane % 4); the TF32 A fragment takes slots {t, t + 4}. The kernel puts
    a_i = d[4kk + 2(i % 2) + i / 2] (slot t + 4(i / 2), key 2t + i / 2) and
    writes Vᵀ's slot 4·odd + i of each step as key 2i + odd: both give slot s
    key 2(s % 4) + s / 4, and the permuted product equals P·V exactly (float64
    on integer values, so every sum is exact)."""
    slot_of_fragment = {}
    for t in range(4):
        for i in range(4):
            e = 2 * (i % 2) + i // 2                # the accumulator element the fragment takes
            key = 2 * t + (e & 1)                   # its key (column 8kk + 2t + e % 2)
            slot_of_fragment[t + 4 * (i // 2)] = key
    slot_of_vt = {4 * odd + i: 2 * i + odd for odd in range(2) for i in range(4)}
    assert slot_of_fragment == slot_of_vt == {s: 2 * (s % 4) + s // 4 for s in range(8)}
    assert sorted(slot_of_vt.values()) == list(range(8))
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.integers(-50, 50, size=(64, 24)).astype(np.float64))
    v = torch.from_numpy(rng.integers(-50, 50, size=(24, 64)).astype(np.float64))
    perm = torch.tensor([8 * j + slot_of_vt[s] for j in range(3) for s in range(8)])
    assert torch.equal(p[:, perm] @ v[perm], p @ v)


def test_forward_route_sends_float32_rows_to_the_tf32x3_kernel():
    """Every float32 row, of any length, takes "tf32x3" (the rows past 1024
    keys too, which PR 1's SIMT kernel took before); bfloat16 routes are
    one-pass, cluster, then long."""
    for lk in (1, 3, 8, 32, 48, 56, 77, 196, 204, 256, 257, 294, 302, 784, 792, 1024,
               1025, 1176, 1184, 1792, 1800, 2048, 100_000):
        assert kattn.fwd_route(torch.float32, lk) == "tf32x3", lk
    assert kattn.fwd_route(torch.bfloat16, 196) == "one_pass"
    assert kattn.fwd_route(torch.bfloat16, 784) == "cluster"
    assert kattn.fwd_route(torch.bfloat16, 1025) == "long"


def test_tf32x3_limit_mirrors_the_cuda_constant_and_the_header_names_the_design():
    """The TF32x3 forward has no upper limit: csrc/attention_fwd_tf32x3.cu
    declares none and its entry point refuses no Lk ≥ 1, so the wrapper
    mirrors none; the source's header says which TPU kernel it replaces,
    what bounds it and what its design does."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_fwd_tf32x3.cu").read_text()
    assert "TF32X3_LIMIT" not in text and "segclip_attention_fwd_tf32x3_limit" not in text
    assert "lk < 1 || batch > 65535" in text
    assert not hasattr(kattn, "TF32X3_LIMIT") and not hasattr(kattn, "tf32x3_limit")
    header = text[:text.index("#include")]
    for needle in ("segclip_tpu/ops/pallas/attention.py", "_fwd_kernel", "3xTF32",
                   "cvt.rna.tf32", "wgmma", "TMA", "K-major", "bytes", "0.122 ms",
                   "attention_fwd_tf32x3_kernel", "2(s − 4) + 1", "bit for bit",
                   "any length", "never of B·H", "div_normal"):
        assert needle in header, needle
    hopper = (build.CSRC / "hopper.cuh").read_text()
    for needle in ("m64n64k8.f32.tf32.tf32", "cvt.rna.tf32.f32", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"):
        assert needle in hopper, needle


def test_tf32x3_function_takes_the_plain_version_on_the_cpu():
    """`attention_fwd_tf32x3` given CPU tensors returns the plain version's
    output and P and launches nothing; the routed forward at float32 does
    the same."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3 * 128)).astype(np.float32))
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]

    def counts():
        return (kattn.attention.launches, kattn.attention_fwd_tf32x3.launches,
                kattn.attention_fwd_two_pass.launches)
    before = counts()
    out, p = kattn.attention_fwd_tf32x3(q, k, v, save_p=True)
    ref, p_ref = kattn.attention_fwd_plain(q, k, v)
    assert torch.equal(out, ref) and torch.equal(p, p_ref)
    assert kattn.attention_fwd_tf32x3(q, k, v)[1] is None
    routed, routed_p = kattn.attention_fwd(q, k, v, save_p=True)
    assert torch.equal(routed, ref) and torch.equal(routed_p, p_ref)
    assert counts() == before
