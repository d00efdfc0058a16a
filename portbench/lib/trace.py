"""Two torch.profiler stretches of a window, kept in memory (nothing is
exported), one after the other over the same number of steps or groups:

  - the device stretch records the card's activity alone (no host
    operators, whose recording would slow the host and read as idle
    device time). Two marker kernels bound it: it runs from the end of the
    first, launched after a sync, to the start of the second, launched
    after the stretch's last unit. Busy and idle time, the device ops and
    the per-layer device times come from it.
  - the host stretch records the host's operators beside the card's, under
    a `portbench.window` annotation; it serves only to name the longest
    idle gaps by what the host was doing, which its own cost lengthens."""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

ANNOTATION = "portbench.window"
PORT_NAMESPACE = "segclip_kernels::"


class Interval(NamedTuple):
    name: str
    start: int      # ns
    end: int


class Summary(NamedTuple):
    span: Tuple[int, int]                # the stretch, ns
    device: List[Interval]               # kernels, copies, sets in the span
    host: List[Interval]                 # host operators in the span

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for iv in sorted(self.device, key=lambda i: i.start):
            if merged and iv.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], iv.end)
            else:
                merged.append([iv.start, iv.end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_seconds(self, port: bool) -> float:
        """Device seconds of the port's kernels (True) or of every other
        interval (False)."""
        return sum(iv.end - iv.start for iv in self.device
                   if (PORT_NAMESPACE in iv.name) == port) * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for iv in self.device:
            key = short_name(iv.name)
            totals[key] = totals.get(key, 0) + iv.end - iv.start
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named by
        the innermost host operator running at its middle."""
        edges = [self.span[0]]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.span[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            covering = [iv for iv in self.host if iv.start <= mid <= iv.end]
            name = (short_name(min(covering, key=lambda iv: iv.end - iv.start).name)
                    if covering else "host_outside_torch_operations")
            out.append([name, (b - a) * 1e-9])
        return out


def short_name(name: str, limit: int = 96) -> str:
    return re.sub(r"[^A-Za-z0-9_:.<>,\-]", "_", name)[:limit]


def _events(prof):
    return prof.profiler.kineto_results.events()


def _clip(e, lo: int, hi: int) -> Optional[Interval]:
    start, end = e.start_ns(), e.start_ns() + e.duration_ns()
    if end <= lo or start >= hi:
        return None
    return Interval(e.name(), max(start, lo), min(end, hi))


def device_summary(prof) -> Summary:
    """The device stretch: from the end of its first device interval (the
    opening marker) to the start of its last (the closing one)."""
    ivs = sorted((e for e in _events(prof)
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()), key=lambda e: e.start_ns())
    if len(ivs) < 2:
        raise RuntimeError("the device stretch recorded no markers")
    lo, hi = ivs[0].start_ns() + ivs[0].duration_ns(), ivs[-1].start_ns()
    device = [iv for iv in (_clip(e, lo, hi) for e in ivs[1:-1]) if iv is not None]
    return Summary((lo, hi), device, [])


def host_summary(prof) -> Summary:
    """The host stretch: the span of its annotation."""
    events = _events(prof)
    spans = [e for e in events if e.name() == ANNOTATION
             and e.device_type() == torch.autograd.DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the profile has no {ANNOTATION} annotation")
    lo, hi = spans[0].start_ns(), spans[0].start_ns() + spans[0].duration_ns()
    # a host span (record_function) is also drawn on the device's timeline,
    # over the kernels it launched: that is not work of its own
    spans_named = {e.name() for e in events if e.is_user_annotation()}
    device, host = [], []
    for e in events:
        iv = _clip(e, lo, hi)
        if iv is None or e.name() == ANNOTATION:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in spans_named:
                device.append(iv)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(iv)
    return Summary((lo, hi), device, host)


class Stretches:
    """The device stretch over units [first, first + n), the host stretch
    over the next n. `before(i)` is called before unit i (a step, a group
    of images) starts; the window may close once `done`. On a device
    other than a card only the host stretch is taken."""

    def __init__(self, first: int, n: int, device: torch.device):
        self.device_units = range(first, first + n)
        self.host_units = range(first + n, first + 2 * n)
        self.device = device
        self.on_card = device.type == "cuda"
        self.summary: Optional[Summary] = None          # the device stretch
        self.host: Optional[Summary] = None
        self.done = False
        self._prof = self._span = None
        self._marker = torch.zeros(1, device=device)

    def profiled(self, i: int) -> bool:
        return i in self.device_units or i in self.host_units

    def before(self, i: int) -> None:
        if i == self.device_units.start and self.on_card:
            self._sync()
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            self._marker.add_(1)
        elif i == self.device_units.stop:
            if self._prof is not None:
                self._marker.add_(1)
                self._sync()
                self._prof.stop()
                self.summary = device_summary(self._prof)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._span = torch.profiler.record_function(ANNOTATION)
            self._span.__enter__()
        elif i == self.host_units.stop:
            self._sync()
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self.host = host_summary(self._prof)
            self._prof = None
            self.done = True

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)
