"""The float32 TF32x3 attention backward (csrc/attention_bwd_tf32x3.cu) on the
CPU: its arithmetic, its route and its limit.

The kernel runs only on the card (tests/test_torch_kernels.py holds it to the
plain version there). Here a torch emulation of its arithmetic writes down
the error budget before any chip run, with test_torch_tf32x3.py's `tf32_rna`
and `split` (x = hi + lo, hi the TF32 rounding of x, to nearest with ties
away, lo that of x − hi):
  - per 64-key slab c (a block of the cluster), dPᵀ_c = V_c·dOᵀ as split
    products per 8-wide k-step over the dims (lo·hi, hi·lo, hi·hi), the
    partial D_c = rowsum over the slab of dP ∘ P in float32, and D = Σ_c D_c
    in rank order;
  - dSᵀ_c = Pᵀ_c ∘ (dPᵀ_c − D) in float32, then split like any operand;
  - dV_c += Pᵀ_c·dO and dK_c += dSᵀ_c·Q with the A operand from registers,
    per 64-row query tile and per warpgroup's 32 rows of it (hi·lo and hi·hi
    per k-step, then lo·hi), the two warpgroups' parts added at the end,
    warpgroup 0's first;
  - dQ_c = dS_c·K_c (lo·hi, hi·lo, hi·hi per 8-key step), dQ = Σ_c dQ_c in
    rank order; dQ and dK times the scale.
At the float32 backward shapes of chip_smoke.py's phase 1 (batch cut to 2:
the kernel's (batch, head) rows do not depend on one another) it holds dQ, dK
and dV within a tenth of the card's tolerance, 1e-6·(1 + max|ref|) per
output, of a float64 reference, where a single TF32 product (hi·hi alone)
does not.
"""
import re

import numpy as np
import pytest
import torch

from segclip_tpu_torch.ops.kernels import attention as kattn
from test_torch_tf32x3 import split

BWD_BUDGET = 1e-6                 # a tenth of chip_smoke's BWD_REL_TOL_F32
SLAB = 64                         # keys a block of the cluster owns
TILE = 64                         # query rows a tile, two warpgroups of 32

# (name, Lq, Lk, H, bias): phase 1's float32 backward shapes, B = 2 (the data-
# and tensor-parallel ranks' rows are the B = 96 step's), and rows ragged
# against the tiles, the slabs and the 8-wide steps.
SHAPES = [
    ("train vision 96x196", 196, 196, 12, None),
    ("train TP vision 96x196 H6", 196, 196, 6, None),
    ("train cross 96x8x204", 8, 204, 12, None),
    ("train MAE vision 96x48", 48, 48, 12, None),
    ("train MAE cross 96x8x56", 8, 56, 12, None),
    ("train text 96x32 causal", 32, 32, 8, "causal"),
    ("train group stage 96x8x8", 8, 8, 12, None),
    ("b32 vision 96x49", 49, 49, 12, None),
    ("b32 cross 96x8x57", 8, 57, 12, None),
    ("drift MAE one head L=3", 3, 3, 1, None),
    ("edge 130x65", 130, 65, 2, None),
    ("edge 65x256", 65, 256, 2, None),
    ("edge 1x1", 1, 1, 1, None),
]


def ss(a, b, acc=None, ks=None):
    """acc + a @ b as split products from shared memory: per 8-wide k-step
    lo·hi, hi·lo, hi·hi (a single hi·hi with `ks` = 1); K padded to 8."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    if acc is None:
        acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        terms = [(ah, bh)] if ks == 1 else [(al, bh), (ah, bl), (ah, bh)]
        for x, y in terms:
            acc = acc + x[..., s] @ y[..., s, :]
    return acc


def rs(a, b, acc, ks=None):
    """acc + a @ b with A from registers (one warpgroup's k-steps of one
    tile): hi·lo and hi·hi per 8-wide k-step, then lo·hi per k-step."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    steps = [slice(k0, k0 + 8) for k0 in range(0, a.shape[-1], 8)]
    if ks == 1:
        order = [(ah, bh, s) for s in steps]
    else:
        order = [x for s in steps for x in ((ah, bl, s), (ah, bh, s))] + [(al, bh, s) for s in steps]
    for x, y, s in order:
        acc = acc + x[..., s] @ y[..., s, :]
    return acc


def emulate(p, do, q, k, v, scale, ks=None):
    """The kernel's backward on (B, H, L, 64) float32 operands and P (B, H,
    Lq, Lk): (dQ, dK, dV) as (B, H, L, 64)."""
    lq, lk = p.shape[-2:]
    slabs = [slice(c0, min(c0 + SLAB, lk)) for c0 in range(0, lk, SLAB)]
    dpt = [ss(v[..., s, :], do.transpose(-1, -2), ks=ks) for s in slabs]   # keys × query rows
    d_c = [(x * p[..., s].transpose(-1, -2)).sum(-2) for x, s in zip(dpt, slabs)]
    d = d_c[0]
    for x in d_c[1:]:
        d = d + x                                                # rank order
    dq, dks, dvs = None, [], []
    for x, s in zip(dpt, slabs):
        pt = p[..., s].transpose(-1, -2)
        dst = pt * (x - d[..., None, :])
        parts = {"dv": [torch.zeros(*pt.shape[:-1], 64) for _ in range(2)],
                 "dk": [torch.zeros(*pt.shape[:-1], 64) for _ in range(2)]}
        for q0 in range(0, lq, TILE):
            for w in range(2):
                r = slice(q0 + 32 * w, min(q0 + 32 * w + 32, lq))
                if r.start >= lq:
                    continue
                parts["dv"][w] = rs(pt[..., r], do[..., r, :], parts["dv"][w], ks)
                parts["dk"][w] = rs(dst[..., r], q[..., r, :], parts["dk"][w], ks)
        dvs.append(parts["dv"][0] + parts["dv"][1])
        dks.append((parts["dk"][0] + parts["dk"][1]) * scale)
        part = ss(dst.transpose(-1, -2), k[..., s, :], ks=ks)
        dq = part if dq is None else dq + part                   # rank order
    return dq * scale, torch.cat(dks, -2), torch.cat(dvs, -2)


def reference(p, do, q, k, v, scale):
    p, do, q, k, v = (t.double() for t in (p, do, q, k, v))
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, dv


def inputs(lq, lk, h, bias, seed):
    """Standard normal q, k, v and dO (numpy), P the float32 softmax of the
    scores as the forward saves it (the causal mask as
    ops.attention.causal_mask), split into (B, H, L, 64) heads, B = 2."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, n, 64)).astype(np.float32))
               for n in (lq, lk, lk))
    do = torch.from_numpy(rng.standard_normal((2, h, lq, 64)).astype(np.float32))
    s = (q.double() @ k.double().transpose(-1, -2)) * 64 ** -0.5
    if bias == "causal":
        s = s + torch.full((lq, lk), float("-inf"), dtype=torch.float64).triu(1)
    return torch.softmax(s, -1).float(), do, q, k, v


def worst(got, ref):
    return max((g.double() - r).abs().max().item() / (1 + r.abs().max().item())
               for g, r in zip(got, ref))


@pytest.mark.parametrize("name, lq, lk, h, bias", SHAPES)
def test_split_products_hold_a_tenth_of_the_backward_tolerance(name, lq, lk, h, bias):
    p, do, q, k, v = inputs(lq, lk, h, bias, seed=lq * 1000 + lk + h)
    scale = 64 ** -0.5
    ref = reference(p, do, q, k, v, scale)
    got = emulate(p, do, q, k, v, scale)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    err = worst(got, ref)
    assert err <= BWD_BUDGET, (name, err)
    one = worst(emulate(p, do, q, k, v, scale, ks=1), ref)
    assert one > BWD_BUDGET, (name, one)


@pytest.mark.parametrize("lk, route", [(1, "tf32x3"), (3, "tf32x3"), (8, "tf32x3"),
                                       (49, "tf32x3"), (57, "tf32x3"), (64, "tf32x3"),
                                       (65, "tf32x3"), (196, "tf32x3"), (204, "tf32x3"),
                                       (255, "tf32x3"), (256, "tf32x3"), (257, "tf32x3_long"),
                                       (294, "tf32x3_long"), (784, "tf32x3_long"),
                                       (1025, "tf32x3_long")])
def test_backward_route_sends_float32_rows_to_the_tf32x3_kernel(lk, route):
    """Every float32 backward of at most BWD_TF32X3_LIMIT (256) keys takes
    "tf32x3", longer ones the TF32x3 long kernels; bfloat16 rows take the
    one-pass, cluster and long kernels."""
    assert kattn.bwd_route(torch.float32, lk) == route
    assert kattn.bwd_route(torch.bfloat16, lk) == ("one_pass" if lk <= 256 else
                                                   "cluster" if lk <= 1024 else "long")
    assert kattn.bwd_route(torch.float32, lk, tf32x3=lk - 1) == "tf32x3_long"


@pytest.mark.parametrize("needle", [
    "segclip_tpu/ops/pallas/attention.py", "_bwd_kernel", "3xTF32", "cvt.rna.tf32", "wgmma",
    "TMA", "K-major", "bytes", "0.1736 ms", "attention_bwd_tf32x3_kernel", "rank order",
    "st.async", "no atomics", "transpose_split"])
def test_bwd_tf32x3_limit_mirrors_the_cuda_constant_and_the_header_names_the_design(needle):
    """BWD_TF32X3_LIMIT in the wrapper is csrc/attention_bwd_tf32x3.cu's
    constant, which the library reports; the source's header says which
    TPU kernel it replaces, what bounds it and what its design does."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_bwd_tf32x3.cu").read_text()
    assert re.findall(r"constexpr int BWD_TF32X3_LIMIT = (\d+);", text) == [
        str(kattn.BWD_TF32X3_LIMIT)]
    assert "int segclip_attention_bwd_tf32x3_limit() { return BWD_TF32X3_LIMIT; }" in text
    assert kattn.BWD_TF32X3_LIMIT == kattn.BWD_ONE_PASS_LIMIT == 256
    header = text[:text.index("#include")]
    assert needle in header.replace("No atomics", "no atomics"), needle
    assert "__global__" in text and "segclip_kernels" in text
    assert "atomic" not in text[text.index("#include"):]
