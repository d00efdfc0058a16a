"""The long-row attention backwards (csrc/attention_bwd_long.cu) on the CPU:
the float32 route's arithmetic, both routes and their limits, and the
source's header.

The kernels run only on the card (tests/test_torch_kernels.py holds them to
the plain version there). Here a torch emulation of the float32 route
("tf32x3_long") writes down its error budget, with test_torch_tf32x3.py's
`split` (x = hi + lo, hi the TF32 rounding of x, lo that of x − hi) and
test_torch_tf32x3_bwd.py's split products (`ss`: lo·hi, hi·lo, hi·hi per
8-wide k-step; `rs`, A from registers: hi·lo and hi·hi per k-step, then
lo·hi):
  - the row pass: per 64-key piece in order and per warpgroup's 32 keys of
    it, dP = dO·Vᵀ (`ss` over the dims), that warpgroup's share of D =
    rowsum(dP ∘ P) summed over the pieces in order, D the two shares added,
    warpgroup 0's first; then per piece in order dS = P ∘ (dP − D) and the
    piece's dS·K (`rs` over the warpgroup's 32 keys) added to its dQ in
    float32, the two warpgroups' dQ added, times the scale;
  - the slab pass: per 64-key slab, dPᵀ = V·dOᵀ (`ss`), dSᵀ = Pᵀ ∘ (dPᵀ −
    D) with the row pass's D, and per 64-row query tile in order and per
    warpgroup's 32 rows of it the tile's Pᵀ·dO and dSᵀ·Q (`rs`) added to
    dV and dK in float32, the two warpgroups' parts added, warpgroup 0's
    first; dK times the scale.
At the float32 rows that take this route on the main path (phase 12's
float32 ViT-L/14 cross rows 2×8×264 at H = 16, the float32 448 px step's
784 and cross 792 and a 1176-key row, their heads cut to 2) it holds dQ, dK
and dV within a tenth of the card's tolerance, 1e-6·(1 + max|ref|) per
output, of a float64 reference, where a single TF32 product (hi·hi alone)
does not.
"""
import re

import numpy as np
import pytest
import torch

from segclip_tpu_torch.ops.kernels import attention as kattn
from test_torch_tf32x3_bwd import BWD_BUDGET, reference, rs, ss, worst

PIECE = 64                        # keys a piece of the row pass and a slab of the slab pass
TILE = 64                         # query rows a tile

# (name, B, Lq, Lk, H): the route's rows on the main path, heads cut to 2
# past the ViT-L/14 rows, and a row ragged against pieces, tiles and steps.
SHAPES = [
    ("l14 float32 cross 2x8x264 H16", 2, 8, 264, 16),
    ("448_f32 vision 1x784 H2", 1, 784, 784, 2),
    ("448_f32 cross 1x8x792 H2", 1, 8, 792, 2),
    ("vision 1x1176 H2", 1, 1176, 1176, 2),
    ("ragged 1x77x333 H2", 1, 77, 333, 2),
]


def emulate(p, do, q, k, v, scale, ks=None):
    """The two passes on (B, H, L, 64) float32 operands and P (B, H, Lq,
    Lk): (dQ, dK, dV) as (B, H, L, 64)."""
    lq, lk = p.shape[-2:]
    halves = [slice(c0 + 32 * w, min(c0 + 32 * w + 32, lk)) for c0 in range(0, lk, PIECE)
              for w in range(2)]
    halves = [(s, i % 2) for i, s in enumerate(halves) if s.start < lk]
    # row pass, walk 1: each warpgroup's share of D over the pieces in order
    share = [torch.zeros(p.shape[:-1]), torch.zeros(p.shape[:-1])]
    dps = []
    for s, w in halves:
        dp = ss(do, v[..., s, :].transpose(-1, -2), ks=ks)       # query rows × 32 keys
        dps.append(dp)
        share[w] = share[w] + (dp * p[..., s]).sum(-1)
    d = share[0] + share[1]
    # walk 2: dS and the warpgroups' dQ over the pieces in order
    dq = [torch.zeros(*p.shape[:-1], 64), torch.zeros(*p.shape[:-1], 64)]
    for (s, w), dp in zip(halves, dps):
        ds = p[..., s] * (dp - d[..., None])
        dq[w] = dq[w] + rs(ds, k[..., s, :], torch.zeros_like(dq[w]), ks)
    # slab pass
    dks, dvs = [], []
    for c0 in range(0, lk, PIECE):
        s = slice(c0, min(c0 + PIECE, lk))
        pt = p[..., s].transpose(-1, -2)
        dst = pt * (ss(v[..., s, :], do.transpose(-1, -2), ks=ks) - d[..., None, :])
        parts = {"dv": [torch.zeros(*pt.shape[:-1], 64) for _ in range(2)],
                 "dk": [torch.zeros(*pt.shape[:-1], 64) for _ in range(2)]}
        for q0 in range(0, lq, TILE):
            for w in range(2):
                r = slice(q0 + 32 * w, min(q0 + 32 * w + 32, lq))
                if r.start >= lq:
                    continue
                for key, a, b in (("dv", pt, do), ("dk", dst, q)):
                    part = rs(a[..., r], b[..., r, :], torch.zeros_like(parts[key][w]), ks)
                    parts[key][w] = parts[key][w] + part
        dvs.append(parts["dv"][0] + parts["dv"][1])
        dks.append((parts["dk"][0] + parts["dk"][1]) * scale)
    return (dq[0] + dq[1]) * scale, torch.cat(dks, -2), torch.cat(dvs, -2)


def inputs(b, lq, lk, h, seed):
    """Standard normal q, k, v and dO (numpy), P the float32 softmax of the
    scores as the forward saves it, as (B, H, L, 64) heads."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, 64)).astype(np.float32))
               for n in (lq, lk, lk))
    do = torch.from_numpy(rng.standard_normal((b, h, lq, 64)).astype(np.float32))
    s = (q.double() @ k.double().transpose(-1, -2)) * 64 ** -0.5
    return torch.softmax(s, -1).float(), do, q, k, v


@pytest.mark.parametrize("name, b, lq, lk, h", SHAPES)
def test_long_split_products_hold_a_tenth_of_the_backward_tolerance(name, b, lq, lk, h):
    p, do, q, k, v = inputs(b, lq, lk, h, seed=lq * 1000 + lk + h)
    scale = 64 ** -0.5
    ref = reference(p, do, q, k, v, scale)
    got = emulate(p, do, q, k, v, scale)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    err = worst(got, ref)
    assert err <= BWD_BUDGET, (name, err)
    one = worst(emulate(p, do, q, k, v, scale, ks=1), ref)
    assert one > BWD_BUDGET, (name, one)


@pytest.mark.parametrize("dtype, lk, route", [
    (torch.float32, 256, "tf32x3"), (torch.float32, 257, "tf32x3_long"),
    (torch.float32, 264, "tf32x3_long"), (torch.float32, 784, "tf32x3_long"),
    (torch.float32, 792, "tf32x3_long"), (torch.float32, 1176, "tf32x3_long"),
    (torch.bfloat16, 1024, "cluster"), (torch.bfloat16, 1025, "long"),
    (torch.bfloat16, 1176, "long"), (torch.bfloat16, 1764, "long"),
    (torch.bfloat16, 1772, "long")])
def test_long_backward_routes(dtype, lk, route):
    """float32 rows past BWD_TF32X3_LIMIT take "tf32x3_long", bf16 rows past
    BWD_CLUSTER_LIMIT "long"; each starts where the kernel before it ends."""
    assert kattn.bwd_route(dtype, lk) == route
    assert kattn.BWD_TF32X3_LONG_MIN_LK == kattn.BWD_TF32X3_LIMIT + 1
    assert kattn.BWD_LONG_MIN_LK == kattn.BWD_CLUSTER_LIMIT + 1


@pytest.mark.parametrize("constant, entry", [
    ("BWD_LONG_MIN_LK", "segclip_attention_bwd_long_min_lk"),
    ("BWD_TF32X3_LONG_MIN_LK", "segclip_attention_bwd_tf32x3_long_min_lk")])
def test_long_limits_mirror_the_cuda_constants(constant, entry):
    """Each Python limit is csrc/attention_bwd_long.cu's constant, which the
    library reports through its own entry point."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_bwd_long.cu").read_text()
    assert re.findall(rf"constexpr int {constant} = (\d+);", text) == [
        str(getattr(kattn, constant))]
    assert f"int {entry}() {{ return {constant}; }}" in text


@pytest.mark.parametrize("needle", [
    "segclip_tpu/ops/pallas/attention.py:96", "_bwd_kernel", "bytes", "0.112 ms", "0.046 ms",
    "row pass", "slab pass", "scratch", "three times", "wgmma", "TMA", "transpose bit",
    "ldmatrix.trans", "K-major", "transpose_split", "hi + lo", "No atomics",
    "attention_bwd_long_rows_kernel", "attention_bwd_long_cols_kernel",
    "attention_bwd_tf32x3_long_rows_kernel", "attention_bwd_tf32x3_long_cols_kernel"])
def test_long_source_header_names_its_tpu_kernel_bound_and_design(needle):
    """The source's header says which TPU kernel it replaces (file and
    line), what bounds it on the card at the routes' main shapes, and what
    its two passes do; no atomics in its code."""
    from segclip_tpu_torch.kernels import build
    text = (build.CSRC / "attention_bwd_long.cu").read_text()
    header = text[:text.index("#include")]
    assert needle in header, needle
    assert "__global__" in text and "segclip_kernels" in text
    assert "atomic" not in text[text.index("#include"):]
