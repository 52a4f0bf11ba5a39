"""Set-up phases on standard error, each with the seconds since the last."""

from __future__ import annotations

import sys
import time


class Phases:
    def __init__(self, what: str):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"portbench: {self.what}: {phase} {now - self.t:.2f} s", file=sys.stderr, flush=True)
        self.t = now
