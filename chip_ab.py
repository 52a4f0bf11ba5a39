#!/usr/bin/env python3
"""Compare chip_smoke.py of two trees on one card, in turns.

    git archive <commit> | tar -x -C build/base   # in a checkout, before the call
    python3 chip_ab.py build/base [chip_smoke arguments, e.g. --occupancy-only]

Runs the base tree's chip_smoke.py, this tree's twice, then the base
tree's again (each builds its own kernels under its own build/), writes
each run's whole output to chiprun_out/ab/<n>_<tree>.log, and prints, per
run, its exit code and the lines that carry the numbers compared: the card
and its power limit, kernel times and bounds, K5 on training keys, the
profiled steps and renders of both profiles (device busy, per-kernel
device time), K1's L2-resident floor, K1 and K3 on a recorded render
chunk, the reference architecture's kernel timings, the 2^19 checks, peak
memory, the steady steps, render and extraction times, the phase headers,
phase 18's occupancy lines (S1's and S2's checks, times and reuse counts,
the frame times and the profiled frame) and the kernels JSON line. Exits
nonzero if any run failed. Arguments after the base tree go to every
chip_smoke.py run. To measure the base tree's kernels with this tree's
script, copy this chip_smoke.py into the base tree first: both then print
the same lines (the kernels' wrappers keep their signatures).
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
KEEP = re.compile(r"^NVIDIA|^\s+time \w+:|sorted_accum on (reference )?training keys"
                  r"|^\s+profiled (reference )?(step|render):"
                  r"|peak device memory|steady step|render again|two calls bitwise equal|FAIL"
                  r"|L2-resident floor|^\s+render chunk \w+|profiler lost|longer spin"
                  r"|2\^19.*(kernel|runs)"
                  r"|reference (chunk|microbatch).*kernel|^\s+render \d+x\d+|extraction:"
                  r"|reading |long rays|sass: .*prop_grid|^phase|^\{\"kernels\""
                  r"|^\s+rig:|bev_pool_fwd|stereo_cost_volume_fwd|forward per frame"
                  r"|profiled frame 2")


def main(argv) -> int:
    if len(argv) < 2 or not (Path(argv[1]) / "chip_smoke.py").exists():
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(argv[1]).resolve()
    out = HERE / "chiprun_out" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for i, (label, tree) in enumerate((("base", base), ("this", HERE), ("this", HERE),
                                       ("base", base))):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py", *argv[2:]], cwd=tree,
                              capture_output=True, text=True)
        log = out / f"{i}_{label}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        print(f"== run {i} {label} ({tree}): exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s -> {log}")
        for line in proc.stdout.splitlines():
            if KEEP.search(line):
                print(line if line.startswith('{"kernels"') else line[:480])
        failed |= proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
