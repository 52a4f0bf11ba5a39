"""run.py finds cells, configurations, drivers and metric readers by name
only, and what BENCHMARK.json names exists under those names."""

from __future__ import annotations

import json
import re

from tiny import HERE  # noqa: F401  (puts the benchmark on sys.path)

from harness import load

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_run_py_names_no_cell_config_driver_or_metric():
    source = (HERE / "run.py").read_text()
    names = ([w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if m["name"] != "setup_s"]  # every cell's, measured by run.py itself
             + [p.stem for p in (HERE / "drivers").glob("*.py")])
    assert not [n for n in names if re.search(rf"\b{re.escape(n)}\b", source)]


def test_every_cell_config_and_reader_is_found_by_its_name():
    for w in BENCH["workloads"]:
        cell = load.cell(w["name"])
        assert cell["config"] == w["config"] and cell.get("chips", 1) == w["chips"]
        assert cell["why"] == w["why"]
        load.config(cell["config"])
        assert hasattr(load.driver(cell["driver"]), "setup")
        e2e, layers = load.cell_metrics(BENCH, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert load.config(c["name"])["name"] == c["name"]
        assert load.config(c["name"])["reduced"] == c["reduced"]
    for m in BENCH["per_layer"]:
        reader = load.metric(m["name"])
        assert (reader.LAYER, reader.SOURCE, reader.MOVES, reader.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"]), m["name"]
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))


def test_a_name_outside_the_rules_is_refused():
    for bad in ("../run", "a/b", "", "x" * 65):
        try:
            load.cell(bad)
        except ValueError:
            continue
        raise AssertionError(f"{bad!r} was taken")
