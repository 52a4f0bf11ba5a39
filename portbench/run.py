"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``cells/<cell>.json`` names its
configuration (``configs/<config>.json``) and its driver
(``drivers/<driver>.py``); the metrics it reports are those that
BENCHMARK.json, at the root of the checkout, lists for it, and each
per-layer metric is read by ``metrics/<metric>.py``. This file knows none
of them.

A driver module has three functions:
  * ``setup(cell, config, seed)`` builds the program under test from the
    seed, drives it through the first units of its work (the ones the
    check follows) and warms up every shape the window uses; returns a
    session;
  * ``window(session, seconds)`` runs the measured window and returns
    (end-to-end values by metric name, attempted, failed);
  * ``trace(session)`` runs a short traced window and returns
    (harness.trace.Trace, work counts of the traced units);
and the session's ``check()`` frees the program's state, runs the plain
reference and returns the compared numbers as (name, value, limit).

The run fails, and prints no result, when no CUDA card is present or the
cell asks for more cards than there are, when a compared number exceeds
its limit it still prints the result with ``correct`` false, and when
jax, jaxlib, flax, optax, orbax or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell in a checkout builds (the program's own kernel
# library goes to <checkout>/build/kernels/).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"

from harness import load  # noqa: E402
from harness.device import device_info, forbidden_modules, require_cards  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = load.cell(args.workload)
    config = load.config(cell["config"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e_names, layer_names = load.cell_metrics(bench, args.workload)
    readers = {name: load.metric(name) for name in layer_names}
    require_cards(cell.get("chips", 1))
    driver = load.driver(cell["driver"])

    session = driver.setup(cell, config, args.seed)
    setup_s = time.perf_counter() - T_START
    extra = {}
    if args.trace:
        trace, work = driver.trace(session)
        metrics = {}
        for name, reader in readers.items():
            value = reader.read(trace, work)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        extra["breakdown"] = trace.breakdown()
        busy_s, window_s = trace.busy_s, trace.window_s
        attempted, failed = work["units"], 0
    else:
        values, attempted, failed = driver.window(session, args.seconds)
        values["setup_s"] = setup_s
        missing = [n for n in e2e_names if n not in values]
        if missing:
            raise RuntimeError(f"the driver reported no {missing}")
        metrics = {n: {"value": values[n], "unit": load.unit(bench, n)} for n in e2e_names}
    device = device_info(cell.get("chips", 1))
    if args.trace:
        device.update(busy_s=busy_s, window_s=window_s)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3

    t_check = time.perf_counter()
    compared = session.check()
    print(f"portbench: set-up {setup_s:.1f} s, window or trace {t_check - T_START - setup_s:.1f}"
          f" s, check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(value <= limit for _, value, limit in compared)
    checks = {name: {"value": value if math.isfinite(value) else repr(value), "limit": limit}
              for name, value, limit in compared}
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, **extra, "checks": checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
