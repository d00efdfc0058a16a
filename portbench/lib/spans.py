"""The program's own spans and counters (`segclip_tpu_torch.utils.profiling`)
read against the device stretch (lib/trace.py), whose bounds and busy
intervals are on the same clock as the spans' host times (kineto's).

A span belongs to the stretch when it closes inside it: a unit's first span
can open a few microseconds before the opening marker kernel ends on the
device, and every span of the units around the stretch closes outside it.
Device-idle time under a span: each gap between the stretch's busy
intervals is split across the innermost program span open on the host over
each part of it; a part under no span counts for none. A program that
records no spans or counters (one older than them) gives None, never an
error."""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Tuple


def _profiling():
    try:
        module = importlib.import_module("segclip_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return module if hasattr(module, "spans") and hasattr(module, "counters") else None


def _stretch(ctx, kind: str):
    """(summary, the program's spans) for a traced run of `kind`, or None."""
    summary = ctx.get("summary") if ctx.get("kind") == kind else None
    profiling = _profiling()
    if summary is None or not ctx.get("units_profiled") or profiling is None:
        return None
    return summary, profiling.spans()


def closed_in(span: Tuple[int, int], spans) -> list:
    lo, hi = span
    return [s for s in spans if s.end_ns is not None and lo < s.end_ns <= hi]


def device_ms(ctx, kind: str, names: Iterable[str]) -> Optional[float]:
    """Device ms per unit between the CUDA events of the spans named
    `names` that close in the stretch."""
    found = _stretch(ctx, kind)
    if found is None:
        return None
    names = set(names)
    times = [s.device_ms for s in closed_in(found[0].span, found[1])
             if s.name in names and s.device_ms is not None]
    return sum(times) / ctx["units_profiled"] if times else None


def gaps(summary) -> List[Tuple[int, int]]:
    """The stretch's device-idle intervals, ns."""
    lo, hi = summary.span
    out, t = [], lo
    for a, b in summary.busy_intervals():
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def idle_under(idle: List[Tuple[int, int]], spans, span: Tuple[int, int]
               ) -> Dict[Optional[str], int]:
    """ns of the intervals `idle` under each span name (innermost open span
    on the host; None: under no span), within `span`."""
    lo, hi = span
    live = [(s.start_ns, i, s) for i, s in enumerate(spans)
            if s.end_ns is not None and s.start_ns < hi and s.end_ns > lo]
    points = sorted({lo, hi} | {min(max(t, lo), hi) for _, _, s in live
                                for t in (s.start_ns, s.end_ns)})
    parts = []
    for a, b in zip(points, points[1:]):
        covering = [k for k in live if k[0] <= a and k[2].end_ns >= b]
        parts.append((a, b, max(covering)[2].name if covering else None))
    out: Dict[Optional[str], int] = {}
    i = 0
    for ga, gb in sorted(idle):
        while i < len(parts) and parts[i][1] <= ga:
            i += 1
        j = i
        while j < len(parts) and parts[j][0] < gb:
            a, b, name = parts[j]
            d = min(b, gb) - max(a, ga)
            if d > 0:
                out[name] = out.get(name, 0) + d
            j += 1
    return out


def idle_ms(ctx, kind: str, names: Iterable[str]) -> Optional[float]:
    """Device-idle ms per unit of the stretch under the spans named
    `names`; None where no such span closes in the stretch."""
    found = _stretch(ctx, kind)
    if found is None:
        return None
    summary, spans = found
    names = set(names)
    if not any(s.name in names for s in closed_in(summary.span, spans)):
        return None
    under = idle_under(gaps(summary), spans, summary.span)
    return 1e-6 * sum(under.get(n, 0) for n in names) / ctx["units_profiled"]


def per(ctx, kind: str, counter: str, unit_counter: str) -> Optional[float]:
    """counter / unit_counter over the process's run, in a run of `kind`."""
    profiling = _profiling() if ctx.get("kind") == kind else None
    if profiling is None:
        return None
    counts = profiling.counters()
    return counts.get(counter, 0) / counts[unit_counter] if counts.get(unit_counter) else None
