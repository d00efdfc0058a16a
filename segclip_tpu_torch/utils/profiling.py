"""Profiler trace of a span of training (segclip_tpu/utils/profiling.py
`trace_if`, with torch.profiler in place of jax.profiler)."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_if(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """A torch.profiler trace of the enclosed span when enabled: host
    operators, and the card's kernels and copies where there is a card,
    written to `log_dir` as a Chrome/TensorBoard trace (`*.pt.trace.json`)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
