"""Spans and counters at the port's layer boundaries.

``span(name)`` marks a phase of the host's work. With no torch.profiler
session active it costs one global read and returns a shared null context.
Inside a session it is ``torch.profiler.record_function(name)``: a CPU event
of that session, on the clock of the device's events, whose parent is the
span that encloses it on the same thread. In a closed loop one unit of work
runs at a time on the main thread, so the unit's span is what the spans of
its phases share.

``count(name, n)`` adds ``n`` to ``COUNTS[name]``: integer counters that
always run and add up over the life of the process, as
``kernels.LAUNCHES`` does. Callers count once per chunk or call, never per
element; readers take ratios of counters of one layer. A count that needs
a value from the device (a wait for the card) is taken only where
``profiling()``, inside a session.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

COUNTS: Counter = Counter()

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch.profiler session is active."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)


def count(name: str, n: int) -> None:
    COUNTS[name] += n
