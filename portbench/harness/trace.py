"""A traced window: torch.profiler over a few units of a cell's work.

The session is padded with spin kernels and 50 ms of host time at each
end: on an H100 the profiler has placed device events up to 13 ms before
their launches, and a session padded by spin kernels alone lost events.
Where a kernel launch that the trace holds on the host (a CUDA runtime or
driver launch call) has no device event of its correlation id, or the
trace holds fewer launch calls than the program's hand-kernel wrappers
made (``presight_tpu_torch.kernels.LAUNCHES``, each at least one), the
profiler lost events: the units run and are traced again, up to five
sessions, then the run fails. No kernel is known by its name.

``Trace`` gives the readers of per-layer metrics what the session saw: the
device's events, the busy time (the union of their intervals), the traced
window on the host's clock, the device time spent under a CPU op (an
autograd node or an aten op, through its launches), and a breakdown.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPIN = "spin_kernel"  # torch.cuda._sleep's kernel, the padding
PAD_S = 0.05
TRIES = 5
GAPS_TAGGED = 500  # the longest idle gaps tagged with a host op
SCAN = 4000  # host ops looked back over for the one that spans a gap

# The host calls that launch a kernel, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel")


def _pad():
    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(PAD_S)


class Trace:
    def __init__(self, prof, window_s: float):
        self.prof = prof
        self.window_s = window_s
        self.cpu_events = [e for e in prof.events() if e.device_type.name == "CPU"]
        # The device's own work: record_function ranges mirrored onto the
        # device's timeline (user annotations such as "Optimizer.step#...",
        # named as their host range) span idle gaps and are left out, as is
        # the padding.
        host_ranges = {e.name for e in self.cpu_events}
        self.events = [e for e in prof.events()
                       if e.device_type.name == "CUDA" and SPIN not in e.name
                       and not getattr(e, "is_user_annotation", False)
                       and e.name not in host_ranges]
        self.intervals = _union(sorted((e.time_range.start, e.time_range.end)
                                       for e in self.events))
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6
        self._averages = None

    def device_s_under(self, op: str) -> Optional[float]:
        """Seconds of device work launched under the CPU op named ``op``
        (an aten op, or an autograd node's
        ``autograd::engine::evaluate_function: <Node>``), its children
        included; None where no such op ran. Ops nested in one of the same
        name count once: the profiler's total already holds them."""
        if self._averages is None:
            self._averages = {a.key: a for a in self.prof.key_averages()}
        avg = self._averages.get(op)
        if avg is None:
            return None
        return avg.device_time_total / 1e6

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        """The ten device operations that took most time, and the ten longest
        idle gaps summed by the innermost host op that spans each."""
        ops: Dict[str, float] = collections.defaultdict(float)
        for e in self.events:
            ops[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e6
        gaps: Dict[str, float] = collections.defaultdict(float)
        cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in self.cpu_events)
        starts = [c[0] for c in cpu]
        idle = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in
                       zip(self.intervals, self.intervals[1:])), reverse=True)
        for length, a1, b0 in idle[:GAPS_TAGGED]:
            mid, name = (a1 + b0) / 2.0, "host (no op)"
            i = bisect.bisect_right(starts, mid)
            for s, e, n in reversed(cpu[max(0, i - SCAN):i]):  # latest start first
                if e >= mid:
                    name = n
                    break
            gaps[name[:120]] += length / 1e6
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in top(ops)],
                "idle_gaps": [[k, v] for k, v in top(gaps)]}


def _union(intervals):
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


@contextlib.contextmanager
def _session():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad()
        yield prof
        torch.cuda.synchronize()
        _pad()


def lost_events(prof, wrapper_calls: int) -> Dict[str, int]:
    """The session's launch calls, and what it lost: launch calls whose
    kernel has no device event (matched by correlation id), and launch
    calls missing against the hand-kernel wrappers' count."""
    events = prof.events()
    calls = [e.id for e in events if e.device_type.name == "CPU" and e.name in LAUNCH_CALLS]
    device = {e.id for e in events if e.device_type.name == "CUDA"}
    return {"launch_calls": len(calls), "wrapper_calls": wrapper_calls,
            "kernels_lost": sum(i not in device for i in calls),
            "launch_calls_lost": max(0, wrapper_calls - len(calls))}


def traced(fn: Callable[[], None]) -> Trace:
    """fn() in a padded profiler session, traced again where the profiler
    lost hand-kernel events."""
    from presight_tpu_torch import kernels

    for _ in range(TRIES):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with _session() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        seen = lost_events(prof, sum(kernels.LAUNCHES.values()))
        print(f"portbench: traced session {seen}", file=sys.stderr, flush=True)
        if not seen["kernels_lost"] and not seen["launch_calls_lost"]:
            return Trace(prof, window)
        print("portbench: the profiler lost device events; tracing again", file=sys.stderr,
              flush=True)
    raise RuntimeError(f"the profiler lost device events in {TRIES} sessions")
