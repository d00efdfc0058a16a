"""Collectives for the global-batch contrastive loss and the data-parallel
step (segclip_tpu/parallel/collectives.py).

The loss code calls `global_gather` and `rank_of` as the JAX package's
does. With no process group, or a group of one process, they are the
identity and rank 0. Across processes `global_gather` concatenates along dim
0 and is differentiable: its backward sums the cotangent across the ranks
and keeps this rank's rows, the transpose of `lax.all_gather`
(psum_scatter), so each rank's gradient takes in every rank's loss. The
reference needed diffdist's autograd all_gather for the same
(util_module.py:180-190).

The gather is an all-reduce of a zero-filled (world·B, …) buffer holding
this rank's rows: exact (x + 0 = x), and the same code on gloo and NCCL,
where gloo refuses all_gather on CUDA tensors. Every rank must give the
same B.

Under tensor parallelism (parallel/dist.py's grid) the ranks of one model
row hold the same rows of the batch, so all three work over this rank's
data column and its data rank: the model peers' copies are neither gathered
twice nor averaged in.
"""
from __future__ import annotations

from typing import List

import torch

from segclip_tpu_torch.parallel.dist import (all_reduce_, data_group, data_rank,
                                             data_size)


def _gather(x: torch.Tensor) -> torch.Tensor:
    b, r = x.shape[0], data_rank()
    out = x.new_zeros((data_size() * b,) + tuple(x.shape[1:]))
    out[r * b:(r + 1) * b] = x
    return all_reduce_(out, data_group())


class _GlobalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        b, r = ctx.rows, data_rank()
        return all_reduce_(grad.contiguous().clone(), data_group())[r * b:(r + 1) * b]


def global_gather(x: torch.Tensor) -> torch.Tensor:
    """x concatenated across the data ranks along dim 0, data rank order;
    the identity with one data rank."""
    if data_size() == 1:
        return x
    return _GlobalGather.apply(x)


def rank_of() -> int:
    """This process's data rank (0 at world size 1)."""
    return data_rank()


def mean_across_ranks_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the data ranks, in place, with
    one all-reduce of their concatenation (the data-parallel step's `pmean`
    of gradients and of losses). All tensors share one dtype."""
    world = data_size()
    if world == 1 or not tensors:
        return
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]),
                       data_group()).div_(world)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
