"""Checkpoints with the JAX package's directory rule
(presight_tpu/engine/checkpoints.py).

The port's own checkpoints are DIRECTORIES
``<run_dir>/nerfstudio_models/step-%09d.ckpt/`` holding one ``torch.save``
file, ``state.pt``: the model's parameters, each group's Adam state and
learning-rate scheduler, and the step. A ``step-*.ckpt`` FILE is a
reference PreSight checkpoint: ``load_checkpoint`` imports its weights
through engine/import_reference.py (its optimizer state has no mapping, so
the optimizers stay fresh: a warm start), and keep-only-latest never
deletes it. The JAX package's orbax directories are not read.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..bridge import _map
from ..models.nerfacto_ms import NerfactoNuscMS
from .import_reference import load_reference_checkpoint
from .optimizers import GroupOptimizer

STATE_FILE = "state.pt"


def _ckpt_dir(run_dir: Path) -> Path:
    return Path(run_dir) / "nerfstudio_models"


def save_checkpoint(run_dir: Path, step: int, model: NerfactoNuscMS,
                    optimizers: Dict[str, GroupOptimizer], keep_only_latest: bool = True) -> Path:
    """Write step-%09d.ckpt/ (through a temporary directory renamed into
    place) and, by default, delete every other checkpoint directory."""
    d = _ckpt_dir(run_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step-{step:09d}.ckpt"
    tmp = d / f".{path.name}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({
        "params": model.state_dict(),
        "optimizers": {name: {"adam": opt.adam.state_dict(),
                              "scheduler": opt.scheduler.state_dict()}
                       for name, opt in optimizers.items()},
        "step": int(step),
    }, tmp / STATE_FILE)
    if path.is_dir():
        shutil.rmtree(path)
    os.replace(tmp, path)
    if keep_only_latest:
        for f in sorted(d.glob("step-*.ckpt")):
            if f != path and f.is_dir():
                shutil.rmtree(f)
    return path


def latest_checkpoint(run_dir: Path) -> Optional[Path]:
    d = _ckpt_dir(run_dir)
    if not d.exists():
        return None
    ckpts = sorted(d.glob("step-*.ckpt"))
    return ckpts[-1] if ckpts else None


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(tree, out.append)
    return out


def load_checkpoint(path: Path, model: NerfactoNuscMS,
                    optimizers: Dict[str, GroupOptimizer]) -> int:
    """Restore ``model`` and ``optimizers`` in place; returns the step."""
    path = Path(path)
    device = next(model.parameters()).device
    if path.is_file():
        params, step = load_reference_checkpoint(path, model.config, device=device)
        new, old = _leaves(params), list(model.leaves)
        if len(new) != len(old) or any(a.shape != b.shape for a, b in zip(new, old)):
            raise ValueError(f"{path}: the reference checkpoint does not match the model "
                             "config's parameter tree (wrong config for this run?)")
        with torch.no_grad():
            for a, b in zip(new, old):
                b.copy_(a)
        if step is None:
            m = re.fullmatch(r"step-(\d+)\.ckpt", path.name)
            step = int(m.group(1)) if m else 0
        return int(step)
    state = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
    model.load_state_dict(state["params"])
    if set(state["optimizers"]) != set(optimizers):
        raise ValueError(f"{path}: optimizer groups {sorted(state['optimizers'])}, the run "
                         f"has {sorted(optimizers)}")
    for name, opt in optimizers.items():
        opt.adam.load_state_dict(state["optimizers"][name]["adam"])
        opt.scheduler.load_state_dict(state["optimizers"][name]["scheduler"])
    return int(state["step"])
