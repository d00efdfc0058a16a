"""Collectives for the global-batch contrastive loss
(segclip_tpu/parallel/collectives.py), at world size 1.

The loss code calls `global_gather` and `rank_of` as the JAX package's does.
With no process group, or a group of one process, they are the identity
and rank 0. A larger world needs a differentiable all-gather, which is the
data-parallel slice's work: until then they raise instead of computing a
loss over one shard's batch as if it were the global one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def _single_process(what: str) -> None:
    if world_size() > 1:
        raise NotImplementedError(
            f"{what} at world size {world_size()}: the port gathers across "
            f"processes only once data parallelism is ported")


def global_gather(x: torch.Tensor) -> torch.Tensor:
    """x concatenated across the processes along dim 0 (identity at world
    size 1)."""
    _single_process("global_gather")
    return x


def rank_of() -> int:
    """This process's rank (0 at world size 1)."""
    _single_process("rank_of")
    return 0
