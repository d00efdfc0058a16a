"""The least time one H100 SXM could take for each kernel's work: the bytes
the function must move (each input read once, each output written once)
over the memory rate, or its operations over the peak rate of their type,
whichever is larger.

Rates are NVIDIA's published dense peaks at the full 700 W power limit:
3.35 TB/s of HBM3, 989 TFLOP/s for bf16 products on tensor cores, 67
TFLOP/s for float32 outside them (the float32 kernels run without TF32).
`chip_smoke.py` puts these bounds beside the measured times; a card set
below 700 W cannot reach them.

Counts are of the function, not of the kernel: the attention backward
counts dV, dP, dQ and dK (four products), not the recomputed dP or the
hi/lo split of dS; a causal mask is counted as the full product, as the
kernels compute it.
"""
from __future__ import annotations

from typing import Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HEAD_DIM = 64


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations": which of the two bounds
    it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def attention_fwd_work(b: int, lq: int, lk: int, heads: int, dtype: torch.dtype,
                       save_p: bool, bias2d: bool = False,
                       biasb: bool = False) -> Tuple[float, float]:
    """(bytes, flops) of the forward: Q read, K and V read, O written, P
    (B, H, Lq, Lk) written when saved, the fp32 biases read; QKᵀ and P·V."""
    e, d = _size(dtype), heads * HEAD_DIM
    nbytes = e * d * (2 * b * lq + 2 * b * lk)
    if save_p:
        nbytes += e * b * heads * lq * lk
    nbytes += 4 * (lq * lk * bias2d + b * lk * biasb)
    return nbytes, 4.0 * b * heads * lq * lk * HEAD_DIM


def attention_bwd_work(b: int, lq: int, lk: int, heads: int,
                       dtype: torch.dtype) -> Tuple[float, float]:
    """(bytes, flops) of the backward from the saved P: P, dO, Q, K, V read,
    dQ, dK, dV written; dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q."""
    e, d = _size(dtype), heads * HEAD_DIM
    nbytes = e * (b * heads * lq * lk + d * (3 * b * lq + 4 * b * lk))
    return nbytes, 8.0 * b * heads * lq * lk * HEAD_DIM


def group_assign_work(n: int, g: int, l: int, d: int, dtype: torch.dtype,
                      training: bool) -> Tuple[float, float]:
    """(bytes, flops) of the grouping: q (N, G, D), k and v (N, L, D) read,
    out (N, G, D) written, hard and soft (N, G, L) fp32 written; training
    adds the fp32 noise read and y_soft written. q·kᵀ and hard·v."""
    e = _size(dtype)
    nbytes = e * (2 * n * g * d + 2 * n * l * d) + 4 * n * g * l * (4 if training else 2)
    return nbytes, 4.0 * n * g * l * d
