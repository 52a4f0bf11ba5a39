"""The program's spans (``presight_tpu_torch.utils.profiler.span``) as a
traced session (``harness.trace.Trace``) holds them: CPU events named by
the span, on the clock of the device's events.

A span's intervals are those of its outermost events (a span nested in one
of its own name counts once). Host calls count for a span where they start
inside it, from whatever thread (the autograd engine launches a backward
from its own). Device time inside a span reads the session's device
intervals moved later by the session's lead, where the profiler placed a
kernel before the launch call that queued it. Times are in microseconds,
as the profiler gives them, unless a name says seconds.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Sequence, Tuple

from harness.trace import LAUNCH_CALLS, _union

Intervals = List[Tuple[float, float]]


def union(intervals: Sequence[Tuple[float, float]]) -> Intervals:
    return _union(sorted(intervals))


def length(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def events(trace, name: str) -> list:
    """The CPU events of the spans named ``name``, outermost only, in order."""
    found = sorted((e for e in trace.cpu_events if e.name == name),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    out = []
    for e in found:
        if not out or e.time_range.start >= out[-1].time_range.end:
            out.append(e)
    return out


def intervals(trace, name: str) -> Intervals:
    return [(e.time_range.start, e.time_range.end) for e in events(trace, name)]


def lead_us(trace) -> float:
    """The most negative lead of a kernel's start over its launch call's
    start (matched by correlation id), or 0 where none is negative."""
    start: Dict[int, float] = {}
    for e in trace.events:
        start[e.id] = min(start.get(e.id, e.time_range.start), e.time_range.start)
    leads = [start[e.id] - e.time_range.start for e in trace.cpu_events
             if e.name in LAUNCH_CALLS and e.id in start]
    return min([0.0] + leads)


def overlap(spans: Intervals, busy: Intervals) -> float:
    """The length of ``spans`` (disjoint) that ``busy`` (disjoint, sorted) covers."""
    total, j = 0.0, 0
    for a, b in sorted(spans):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total


def idle_us(trace, name: str) -> float:
    """Time inside the spans named ``name`` in which the device ran nothing."""
    spans, shift = intervals(trace, name), -lead_us(trace)
    busy = [(a + shift, b + shift) for a, b in trace.intervals]
    return length(spans) - overlap(spans, busy)


def _within(spans: Intervals):
    """A test of whether a time lies inside ``spans`` (disjoint, sorted)."""
    starts = [a for a, _ in spans]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    return inside


def launches(trace, name: str) -> int:
    """Kernel launch calls, from any thread, that start inside the spans
    named ``name``."""
    inside = _within(intervals(trace, name))
    return sum(1 for e in trace.cpu_events
               if e.name in LAUNCH_CALLS and inside(e.time_range.start))


def device_s(trace, name: str) -> float:
    """Seconds of device work that host calls (CUDA runtime or driver calls,
    from any thread, matched to the device's events by correlation id)
    started inside the spans named ``name``."""
    inside = _within(intervals(trace, name))
    duration: Dict[int, float] = collections.defaultdict(float)
    for e in trace.events:
        duration[e.id] += e.time_range.end - e.time_range.start
    return sum(duration[e.id] for e in trace.cpu_events
               if e.name.startswith("cu") and e.id in duration
               and inside(e.time_range.start)) / 1e6
