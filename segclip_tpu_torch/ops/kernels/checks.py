"""Measures for holding a kernel's output to its plain version at bfloat16.

Both sides round an fp32 value to bf16 at the end, so where only the order
of fp32 sums differs they are at most one bf16 ulp apart. `bf16_ulps` gives
that distance. The attention kernel has one more rounding inside: P is
rounded to bf16 before P·V. Kernel and plain compute P in fp32 a few fp32
ulps apart, so on a rare P entry that lies on a bf16 rounding midpoint the
two round it to neighbouring bf16 values, and that row's output can move by
several of its own ulps. Hence the attention check bounds the *share* of
elements more than one ulp apart (`ATTN_BF16_SHARE`): a float32 CPU
emulation of the kernel's order of operations put it at ≤ 3e-5 on the
path's shapes (seeded normal q, k, v), and an emulated kernel that skipped
the rounding of P at 0.09–0.12. `rounded_p_case` holds the same step on
inputs where kernel and plain must agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

# Units of `bf16_ulps` never fall below this: the ulp of |x| in [2^-7, 2^-6).
ULP_FLOOR = 2.0 ** -14
# Share of bf16 attention outputs allowed more than one ulp from the plain
# version (see the module docstring).
ATTN_BF16_SHARE = 1e-3


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|out − ref| in units of the bf16 ulp of ref (at least ULP_FLOOR)."""
    ref32 = ref.float()
    # |ref| in [2^(exp−1), 2^exp), where a bf16 ulp is 2^(exp−8)
    _, exp = torch.frexp(ref32.abs().clamp(min=ULP_FLOOR * 2 ** 7))
    unit = torch.ldexp(torch.ones_like(ref32), exp - 8)
    return (out.float() - ref32).abs() / unit


def rounded_p_case(device) -> Tuple[torch.Tensor, ...]:
    """bf16 q, k, v (1, L, 64) and an fp32 bias2d on which rounding P to
    bf16 before P·V moves the output by up to 6 bf16 ulps.

    q = 0, so the scores of row i are its bias2d row [0, t_i] and P is
    softmax([0, t_i]). The two rows of v are +c and −c, so o = (p0 − p1)·c.
    Each fp32 p lies ≥ 0.016 bf16 ulps from a rounding midpoint, far beyond
    fp32 error, and every product and sum of P·V is exact in fp32: a kernel
    that keeps the dtype chain gives the plain version's output bit for bit.
    """
    t = torch.tensor([-0.1, 0.3, 1.1, -2.0], device=device)
    bias2d = torch.stack([torch.zeros_like(t), t], dim=1)          # (4, 2)
    c = 1.0 + torch.arange(64, device=device) / 128.0              # exact in bf16
    v = torch.stack([c, -c])[None].to(torch.bfloat16)              # (1, 2, 64)
    q = torch.zeros(1, 4, 64, dtype=torch.bfloat16, device=device)
    return q, v.clone(), v, bias2d
