"""Named-span wall-clock profiler (presight_tpu/utils/profiler.py):
``time_function`` and ``time_span`` add each call's host wall time to a
per-name total that ``summary`` prints. Callers that time device work
synchronise inside the span."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

_TOTALS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def time_span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TOTALS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def time_function(fn=None, *, name: Optional[str] = None):
    """Decorator recording wall-clock per call under ``name`` (or qualname)."""

    def wrap(f):
        span = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with time_span(span):
                return f(*args, **kwargs)

        return inner

    if fn is not None:
        return wrap(fn)
    return wrap


def summary() -> str:
    lines = ["profiler summary (total s | calls | mean ms):"]
    for name in sorted(_TOTALS, key=lambda n: -_TOTALS[n]):
        tot, cnt = _TOTALS[name], _COUNTS[name]
        lines.append(f"  {name:<45s} {tot:9.3f} | {cnt:6d} | {tot / cnt * 1e3:8.2f}")
    return "\n".join(lines)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()
