"""Event writer (presight_tpu/utils/writer.py): metrics to the console and
an append-only ``events.jsonl`` per run, plus TensorBoard
(torch.utils.tensorboard, under <run_dir>/tensorboard) and Weights & Biases
when those packages are importable; a backend that is not installed is a
no-op, so a config's ``vis`` never stops an offline run.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional


class EventName:
    ITER_TRAIN_TIME = "Train Iter (time)"
    TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
    TRAIN_RAYS_PER_SEC_PER_CHIP = "Train Rays / Sec / Chip"
    TEST_RAYS_PER_SEC = "Test Rays / Sec"
    ETA = "ETA (time)"
    TOTAL_TRAIN_TIME = "Total Train Time"


class _TensorboardBackend:
    def __init__(self, log_dir: Path):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=str(log_dir))

    def put_scalar(self, name: str, value: float, step: int) -> None:
        self._w.add_scalar(name, value, step)

    def close(self) -> None:
        self._w.close()


class _WandbBackend:
    def __init__(self, log_dir: Path):
        import wandb

        self._wandb = wandb
        self._run = wandb.init(dir=str(log_dir), project="presight-tpu",
                               reinit=True)

    def put_scalar(self, name: str, value: float, step: int) -> None:
        self._wandb.log({name: value}, step=step)

    def close(self) -> None:
        self._run.finish()


def _make_backends(vis: str, log_dir: Optional[Path]):
    backends = []
    if log_dir is None:
        return backends
    wanted = {v.strip() for v in vis.split("+") if v.strip()}
    if "tensorboard" in wanted:
        try:
            backends.append(_TensorboardBackend(log_dir / "tensorboard"))
        except Exception as e:  # noqa: BLE001 - optional backend
            print(f"tensorboard writer unavailable: {type(e).__name__}: {e}", flush=True)
    if "wandb" in wanted:
        try:
            backends.append(_WandbBackend(log_dir))
        except Exception as e:  # noqa: BLE001 - optional backend
            print(f"wandb writer unavailable: {type(e).__name__}: {e}", flush=True)
    return backends


class Writer:
    def __init__(self, log_dir: Optional[Path] = None, steps_per_log: int = 10,
                 max_buffer: int = 20, vis: str = "local"):
        self.log_dir = Path(log_dir) if log_dir else None
        self.steps_per_log = steps_per_log
        self._jsonl = None
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "events.jsonl", "a")
        self._backends = _make_backends(vis, self.log_dir)
        self._times = deque(maxlen=max_buffer)
        self._start = time.time()

    def put_scalar(self, name: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "name": name,
                                          "value": float(value)}) + "\n")
        for b in self._backends:
            b.put_scalar(name, float(value), step)

    def put_dict(self, scalars: Dict[str, float], step: int) -> None:
        for k, v in scalars.items():
            self.put_scalar(k, v, step)

    def announce(self, prefix: str, scalars: Dict[str, float], step: int) -> None:
        """put_dict + one console line — eval events route through the
        writer (backends + console) rather than raw prints in the trainer."""
        self.put_dict(scalars, step)
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(scalars.items()))
        print(f"{prefix} @ step {step}: {msg}", flush=True)
        if self._jsonl is not None:
            self._jsonl.flush()

    def log_step(self, step: int, metrics: Dict[str, float], num_rays: int,
                 iter_time: float, max_steps: int, num_devices: int = 1) -> None:
        self._times.append(iter_time)
        self.put_dict(metrics, step)
        rays_per_sec = num_rays / iter_time if iter_time > 0 else 0.0
        self.put_scalar(EventName.TRAIN_RAYS_PER_SEC, rays_per_sec, step)
        if num_devices > 1:
            self.put_scalar(EventName.TRAIN_RAYS_PER_SEC_PER_CHIP,
                            rays_per_sec / num_devices, step)
        if step % self.steps_per_log == 0:
            avg = sum(self._times) / len(self._times)
            eta = avg * (max_steps - step)
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            per_chip = (
                f" ({num_rays / avg / num_devices:,.0f}/chip)"
                if num_devices > 1 else ""
            )
            print(
                f"step {step:>7d} | {msg} | {num_rays / avg:,.0f} rays/s"
                f"{per_chip} | eta {eta/60:.1f}m",
                flush=True,
            )
        if self._jsonl is not None and step % self.steps_per_log == 0:
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        for b in self._backends:
            try:
                b.close()
            except Exception:  # noqa: BLE001
                pass
