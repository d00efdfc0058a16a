"""Semantic grouping numerics, plain torch (segclip_tpu/ops/grouping.py):
Gumbel straight-through assignment over the group axis and count-normalised
aggregation of patch values into group tokens.

The model's grouping goes through the group-assignment kernel
(ops/kernels/grouping.py) at eval and at training; `group_assign_aggregate`
is that kernel's plain version. The training form takes Gumbel noise passed
in or drawn from a torch.Generator (`draw_gumbel`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_gumbel(shape, device, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Gumbel(0, 1) noise, −log(−log(u)) of uniform u in [tiny, 1), fp32,
    drawn on `device` from `generator`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   dim: int = -1, generator: Optional[torch.Generator] = None,
                   training: bool = True,
                   gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-softmax with an optional straight-through hard one-hot.

    training=True adds Gumbel(0, 1) noise and divides by tau before the
    softmax; training=False is a plain softmax. `gumbel_noise` overrides the
    draw (tests hand both frameworks the same noise)."""
    logits32 = logits.float()
    if training:
        if gumbel_noise is None:
            gumbel_noise = draw_gumbel(logits.shape, logits.device, generator)
        y_soft = torch.softmax((logits32 + gumbel_noise.float()) / tau, dim=dim)
    else:
        y_soft = torch.softmax(logits32, dim=dim)

    if hard:
        index = y_soft.argmax(dim=dim, keepdim=True)
        y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
        y = y_hard - y_soft.detach() + y_soft           # forward hard, grad soft
    else:
        y = y_soft
    return y.to(logits.dtype)


def group_assign_aggregate(logits: torch.Tensor, v: torch.Tensor, tau: float,
                           training: bool = True,
                           generator: Optional[torch.Generator] = None,
                           gumbel_noise: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (B, G, L) un-scaled group affinities, v (B, L, D) patch values
    → (grouped (B, G, D) in v's dtype, hard (B, G, L), soft (B, G, L)).
    The softmax is over G; the aggregation divides by max(count, 1)."""
    hard = gumbel_softmax(logits, tau=tau, hard=True, dim=1,
                          generator=generator, training=training,
                          gumbel_noise=gumbel_noise)
    soft = torch.softmax(logits.float(), dim=1).to(logits.dtype)
    grouped = torch.matmul(hard.float(), v.float())
    counts = hard.float().sum(dim=-1, keepdim=True)
    grouped = grouped / torch.maximum(counts, torch.ones_like(counts))
    return grouped.to(v.dtype), hard, soft
