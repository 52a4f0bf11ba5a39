"""The training loop (presight_tpu/engine/trainer.py ``Trainer.train``) over
a device-resident ray store.

Per step: the next batch (``BatchOrder``, the JAX DataManager's rule), the
host schedules (anneal, line-of-sight, the proposal update schedule), a
refresh of the cached proposal grid when ``prop_grid_refresh_due`` says so,
and one ``train_step``. Checkpoints, eval cadence, the writer and the
multi-device mesh are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs import TrainerConfig
from ..data.cameras import CameraParams
from ..data.device_store import DeviceRayStore
from ..models.nerfacto_ms import (
    ProposalUpdateSchedule,
    anneal_at,
    init_model,
    line_of_sight_mult_at,
    line_of_sight_sigma_at,
    prop_grid_refresh_due,
)
from .optimizers import make_optimizers
from .train_step import StepScalars, train_step


class BatchOrder:
    """Row indices of each batch, by presight_tpu/data/datamanager.py's
    rule with the whole in-memory dataset as every chunk: the chunk counter
    starts at ``seed``; the i-th chunk is shuffled by
    ``np.random.default_rng(seed + 2 + i)`` (the DataManager has scheduled
    the next chunk's load when it draws the permutation); batches are
    contiguous slices of the permutation, and a chunk that cannot fill the
    next batch is dropped for a fresh one."""

    def __init__(self, num_rows: int, batch_size: int, seed: int = 0):
        if batch_size > num_rows:
            raise ValueError(f"batch of {batch_size} rays from a dataset of {num_rows}")
        self.num_rows, self.batch_size = num_rows, batch_size
        self._chunk_step = seed
        self._order: Optional[np.ndarray] = None
        self._cursor = 0

    def next(self) -> np.ndarray:
        if self._order is None or self._cursor + self.batch_size > self.num_rows:
            self._chunk_step += 1  # the chunk just loaded
            rng = np.random.default_rng(self._chunk_step + 1)  # after scheduling the next
            self._order = rng.permutation(self.num_rows)
            self._cursor = 0
        sel = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return sel


def step_scalars(config, step: int) -> StepScalars:
    """The schedule values of ``step``, rounded to f32 as JAX feeds them."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return StepScalars(anneal=f32(anneal_at(config, step)),
                       sigma=f32(line_of_sight_sigma_at(config, step)),
                       los_mult=f32(line_of_sight_mult_at(config, step)))


class Trainer:
    """Trains a freshly initialised model on ``store`` with ``cameras``.

    ``aabbs`` and ``centroids`` place the experts; the model, its optimizer
    state, the store and the draws live on ``device`` (the CUDA card unless
    the caller passes another)."""

    def __init__(self, config: TrainerConfig, store: DeviceRayStore, cameras: CameraParams,
                 aabbs, centroids, num_train_cameras: int, num_train_videos: int,
                 device=None):
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        self.model_config = config.pipeline.model
        self.store = store
        if store.device != self.device:
            raise ValueError(f"the ray store is on {store.device}, the trainer on {self.device}")
        self.cameras = cameras.to(self.device)
        self.model = init_model(torch.Generator().manual_seed(config.seed), self.model_config,
                                aabbs, centroids, num_train_cameras, num_train_videos,
                                device=self.device)
        self.optimizers = make_optimizers(self.model.groups(), config.optimizers)
        self.batches = BatchOrder(len(store), config.pipeline.datamanager.train_num_rays_per_batch,
                                  seed=config.seed)
        self.update_sched = ProposalUpdateSchedule(self.model_config)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.prop_grid: Optional[torch.Tensor] = None
        self.step = 0

    def train(self, num_steps: Optional[int] = None,
              callback: Optional[Callable[[int, Dict[str, float]], None]] = None) -> None:
        """Run ``num_steps`` steps (default: up to max_num_iterations).
        ``callback(step, metrics)`` sees each step's metrics plus
        ``step_seconds`` (host clock, synchronised) and ``grid_refreshed``."""
        cfg, mcfg = self.config, self.model_config
        end = cfg.max_num_iterations if num_steps is None else self.step + num_steps
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        while self.step < min(end, cfg.max_num_iterations):
            step = self.step
            t0 = time.perf_counter()
            batch = self.store.batch(self.store.ray_index(self.batches.next()),
                                     with_features=mcfg.use_semantics)
            updated = self.update_sched.updated(step)
            refreshed = mcfg.use_prop_grid and (self.prop_grid is None
                                                or prop_grid_refresh_due(mcfg, step))
            if refreshed:
                self.prop_grid = self.model.make_prop_grid()
            metrics = train_step(self.model, self.optimizers, self.cameras, batch,
                                 step_scalars(mcfg, step), stop_prop_grad=not updated,
                                 microbatch_rays=cfg.microbatch_rays, prop_grid=self.prop_grid,
                                 generator=self.generator)
            self.update_sched.step_cb(step, updated)
            sync()
            metrics["step_seconds"] = time.perf_counter() - t0
            metrics["grid_refreshed"] = float(refreshed)
            self.step += 1
            if callback is not None:
                callback(step, metrics)
