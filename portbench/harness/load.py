"""Find a cell, a configuration, a driver or a metric reader by its name.

A cell is ``cells/<name>.json``, a configuration ``configs/<name>.json``, a
driver ``drivers/<name>.py`` and a per-layer metric's reader
``metrics/<name>.py`` (names may hold dots, so readers load by path)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def cell(name: str) -> Dict:
    return json.loads(_path("cells", name, ".json").read_text())


def config(name: str) -> Dict:
    return json.loads(_path("configs", name, ".json").read_text())


def _module(kind: str, name: str):
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _module("drivers", name)


def metric(name: str):
    return _module("metrics", name)


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: Dict, workload: str) -> Tuple[List[str], List[str]]:
    """The end-to-end and the per-layer metrics BENCHMARK.json lists for a cell."""
    if workload not in {w["name"] for w in bench["workloads"]}:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    return ([m["name"] for m in bench["end_to_end"] if _applies(m, workload)],
            [m["name"] for m in bench["per_layer"] if _applies(m, workload)])


def unit(bench: Dict, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] + bench["per_layer"] if m["name"] == name)
