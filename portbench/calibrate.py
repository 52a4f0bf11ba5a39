"""Readings that set a cell's limits: the compared numbers of sound runs of
the program over many seeds (the lower readings), and of the control and
the planted faults (the upper ones), all in one process on the card.

    python portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--seconds 2]

Each seed builds the cell as a run does, drives a short window at the
cell's own load (``--seconds``) and prints one JSON line: with --seeds the
run's own check (``kind`` "program"); with --control-seeds the driver's
``calibration()``: the control (the reference in the nearest lower
precision, put in the program's place) and the faults a planted copy of
the reference reads, each against the reference. Not part of a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import load  # noqa: E402
from harness.device import require_cards  # noqa: E402


def worst_leaves(got, want, top: int = 3):
    """The leaves with the largest relative gaps of each per-leaf reading:
    [leaf, gap, got, want, the reference's first-gradient norm]."""
    out = {}
    for key, values in want.items():
        if not isinstance(values, dict) or not all(isinstance(v, float) for v in values.values()):
            continue
        gaps = sorted(((abs(got[key][k] - v) / max(v, 1e-30), k) for k, v in values.items()),
                      reverse=True)[:top]
        out[key] = [[k, g, got[key][k], values[k], want["first_grad"].get(k)] for g, k in gaps]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    cell = load.cell(args.workload)
    config = load.config(cell["config"])
    require_cards(cell.get("chips", 1))
    driver = load.driver(cell["driver"])
    seeds = [("program", int(s)) for s in args.seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for kind, seed in seeds:
        t0 = time.perf_counter()
        session = driver.setup(cell, config, seed)
        driver.window(session, args.seconds)
        found = ({"program": session.check()} if kind == "program"
                 else session.calibration())
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0}
        line.update({name: {n: v for n, v, _ in readings} for name, readings in found.items()})
        if kind == "program" and hasattr(session, "want"):
            line["worst_leaves"] = worst_leaves(session.readings(), session.want)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
