"""Profiling: `--profile`'s trace, the program's spans and its counters.

    with trace_if(log_dir, enabled=profile):          # a torch.profiler trace
        with span("train.step", unit=step):           # recorded under any profiler
            with span("train.forward", device=True):  # + device time by CUDA events
                ...
    count("host_syncs")                               # always on
    counters(), spans(), clear()

A span records only while a torch.profiler runs in the process (`trace_if`,
or any other): with none running it costs one look at torch's own flag and
reaches nothing else, not even `record_function` (whose call costs
microseconds with the profiler off). Under a profiler it enters a
`record_function` of its name, so the exported trace shows it, and keeps
its name, parent, unit and host start and end in a bounded buffer, on the
clock kineto stamps its events with (`time.time_ns`), so that a span and the
profiler's host and device intervals can be laid side by side. With
`device=True` it also records a CUDA event on the current stream at each
edge; the device time between them is resolved when `spans()` reads the
buffer, so nothing waits on the device inside the span.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_LIMIT = 1 << 16            # spans kept; later ones are not recorded


class Span(NamedTuple):
    name: str
    parent: Optional[int]       # index of the enclosing span in `spans()`
    unit: Optional[int]         # e.g. the step a train.step span ran
    start_ns: int               # host clock (time.time_ns, kineto's)
    end_ns: Optional[int]       # None while the span is open
    device_ms: Optional[float]  # between its CUDA events, where it has them


_buffer: List[list] = []        # [name, parent, unit, start, end, events, device_ms]
_open = threading.local()       # each thread's stack of open span indices
_counts: Dict[str, int] = {}
_lock = threading.Lock()        # the buffer's appends and the counters' additions


_OFF = contextlib.nullcontext()  # the span with no profiler running


class _On:
    __slots__ = ("name", "unit", "device", "index", "rf", "events")

    def __init__(self, name: str, unit: Optional[int], device: bool):
        self.name, self.unit, self.device = name, unit, device

    def __enter__(self) -> None:
        stack = _open.__dict__.setdefault("stack", [])
        with _lock:
            self.index = len(_buffer)
            _buffer.append([self.name, stack[-1] if stack else None, self.unit,
                            time.time_ns(), None, None, None])
        stack.append(self.index)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(None, None, None)
        record = _buffer[self.index]
        record[4], record[5] = time.time_ns(), self.events
        _open.stack.pop()
        return False


def span(name: str, unit: Optional[int] = None, device: bool = False):
    """A context manager recording `name` while a torch.profiler runs (see
    the module's docstring); `device=True` only where its work runs on a
    card. An exception leaving it closes it."""
    if not _autograd_profiler._is_profiler_enabled or len(_buffer) >= SPAN_LIMIT:
        return _OFF
    return _On(name, unit, device)


def spans() -> List[Span]:
    """The recorded spans in the order they opened, each closed one's CUDA
    events resolved to device ms (waiting for its end event once)."""
    out = []
    for record in _buffer:
        name, parent, unit, start, end, events, device_ms = record
        if events is not None and device_ms is None:
            events[1].synchronize()
            record[6] = device_ms = events[0].elapsed_time(events[1])
        out.append(Span(name, parent, unit, start, end, device_ms))
    return out


def clear() -> None:
    """Empty the span buffer (the counters stay)."""
    _buffer.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to the always-on counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter: the program's (`count`) and the kernel
    wrappers' launch counters, read where they live, as
    "<wrapper>.launches"."""
    from segclip_tpu_torch.ops.kernels import adamw, attention, grouping
    with _lock:
        out = dict(_counts)
    for module in (attention, grouping, adamw):
        for name, obj in vars(module).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int):
                out[f"{name}.launches"] = obj.launches
    return out


@contextlib.contextmanager
def trace_if(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """A torch.profiler trace of the enclosed span when enabled: host
    operators and the program's spans, and the card's kernels and copies
    where there is a card, written to `log_dir` as a Chrome/TensorBoard
    trace (`*.pt.trace.json`)."""
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
