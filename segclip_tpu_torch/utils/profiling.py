"""Profiling and step timing (segclip_tpu/utils/profiling.py, with
torch.profiler in place of jax.profiler).

Usage:
    with trace_if(log_dir, enabled=profile):
        for step, batch in enumerate(loader):
            with step_annotation(step):
                metrics = train_step(state, batch)

    timer = StepTimer(warmup=2)
    ...
    timer.tick(metrics["loss"])   # a scalar fetched to the host syncs honestly
"""
from __future__ import annotations

import contextlib
import time
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


def step_annotation(step: int) -> torch.profiler.record_function:
    """Named trace span for one training step: `train_step <step>`, the
    event that jax.profiler.StepTraceAnnotation("train_step", step_num=step)
    shows on a trace's timeline."""
    return torch.profiler.record_function(f"train_step {step}")


class StepTimer:
    """Throughput meter over the steps after `warmup` ticks. A tick syncs
    before it counts: by fetching `sync_scalar` to the host where one is
    given, else by waiting for the card where there is one."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._n = 0
        self._t0: Optional[float] = None

    def tick(self, sync_scalar=None) -> None:
        if sync_scalar is not None:
            float(sync_scalar)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        self._n += 1
        if self._n == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def steps_timed(self) -> int:
        return max(0, self._n - self.warmup)

    def rate(self, per_step_items: int = 1) -> float:
        """items/s over the steps after the warm-up; NaN before any."""
        if self._t0 is None or self.steps_timed == 0:
            return float("nan")
        return per_step_items * self.steps_timed / (time.perf_counter() - self._t0)
