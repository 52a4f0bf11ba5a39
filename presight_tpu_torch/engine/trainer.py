"""Trainer: config -> setup -> train loop -> checkpoints and eval
(presight_tpu/engine/trainer.py).

``Trainer(config).setup()`` builds the run from disk as the JAX package
does: the run directory ``<output>/<experiment>/<method>/<timestamp>/``
with its config.yml, the dataparser's train split, the chunked dataset and
its DataManager, the camera tables, the model and its optimizers, a device
store (the whole set on the device under the cap, else chunk by chunk), and
the latest checkpoint of the run (or of ``load_dir``). A resumed run
(start step s > 0) offsets the chunk stream to ``seed + s``, seeds the
draw generator from (seed + 1, s) and replays the proposal update
schedule, as the JAX Trainer does; it does not replay an uninterrupted
run.

``train()`` runs to max_num_iterations: per step the next batch, the host
schedules, a cached-grid refresh when due, one ``train_step``; then the
cadences of logging, eval batch, eval image and save (0 turns one off),
and the final save.

``Trainer.in_memory`` builds a trainer over a DeviceRayStore filled by the
caller, without a run directory: its batches follow the same DataManager
rule with the whole store as every chunk.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import TrainerConfig
from ..configs.config_io import load_config, save_config
from ..data import constants as K
from ..data.cameras import CameraParams, generate_rays
from ..data.datamanager import DataManager
from ..data.dataparser import DataparserOutputs, make_camera_params, parse
from ..data.dataset import PixelChunk, PixelChunkDataset
from ..data.device_store import ChunkDeviceStore, DeviceRayStore
from ..models.nerfacto_ms import (
    ProposalUpdateSchedule,
    anneal_at,
    compute_losses,
    init_model,
    line_of_sight_mult_at,
    line_of_sight_sigma_at,
    prop_grid_refresh_due,
)
from ..utils import profiler
from ..utils.writer import Writer
from .checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from .optimizers import make_optimizers
from .train_step import StepScalars, psnr, train_step


def step_scalars(config, step: int) -> StepScalars:
    """The schedule values of ``step``, rounded to f32 as JAX feeds them."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return StepScalars(anneal=f32(anneal_at(config, step)),
                       sigma=f32(line_of_sight_sigma_at(config, step)),
                       los_mult=f32(line_of_sight_mult_at(config, step)))


def draw_seed(seed: int, start_step: int) -> int:
    """Seed of the draw generator of a run (re)started at ``start_step``:
    ``seed + 1`` from scratch, else (seed + 1, start_step) folded."""
    if start_step == 0:
        return seed + 1
    state = np.random.SeedSequence([seed + 1, start_step]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


class _WholeStore:
    """The whole in-memory store as every chunk: its rows' ray indices."""

    def __init__(self, store: DeviceRayStore):
        self.chunk = PixelChunk({K.RAY_INDEX: store.ray_index(np.arange(len(store)))})

    def load_chunk(self, step: int) -> PixelChunk:
        return self.chunk


class Trainer:
    def __init__(self, config: TrainerConfig, device=None):
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        self.run_dir: Optional[Path] = None
        self.writer: Optional[Writer] = None
        self.store: Optional[DeviceRayStore] = None
        self._chunk_store: Optional[ChunkDeviceStore] = None
        self._eval_dm: Optional[DataManager] = None
        self.eval_items, self.eval_cameras = [], None
        self.prop_grid: Optional[torch.Tensor] = None
        self.start_step = self.step = 0

    # ---------------------------------------------------------------- set-up

    def _check_supported(self) -> None:
        cfg = self.config
        ndev = cfg.num_devices
        if ndev == 0:
            ndev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if ndev != 1:
            raise NotImplementedError(f"num_devices={cfg.num_devices}: the port runs on one "
                                      "device (multi-GPU is not ported yet: ROADMAP Queue 1 "
                                      "item 7)")
        if cfg.camera_optimizer_mode == "so3xr3":
            raise NotImplementedError("camera_optimizer_mode='so3xr3' is not ported yet")
        if cfg.camera_optimizer_mode != "off":
            raise ValueError(f"camera_optimizer_mode must be 'off' or 'so3xr3', got "
                             f"{cfg.camera_optimizer_mode!r}")
        if cfg.gradient_accumulation_steps != 1:
            raise NotImplementedError(f"gradient_accumulation_steps="
                                      f"{cfg.gradient_accumulation_steps}: only 1 is ported")

    def _init_state(self, model_config, aabbs, centroids, num_train_cameras: int,
                    num_train_videos: int) -> None:
        cfg = self.config
        self.model_config = model_config
        self.model = init_model(torch.Generator().manual_seed(cfg.seed), model_config, aabbs,
                                centroids, num_train_cameras, num_train_videos,
                                device=self.device)
        self.optimizers = make_optimizers(self.model.groups(), cfg.optimizers)
        self.update_sched = ProposalUpdateSchedule(model_config)
        self.generator = torch.Generator(device=self.device).manual_seed(draw_seed(cfg.seed, 0))

    @classmethod
    def in_memory(cls, config: TrainerConfig, store: DeviceRayStore, cameras: CameraParams,
                  aabbs, centroids, num_train_cameras: int, num_train_videos: int,
                  device=None) -> "Trainer":
        """A freshly initialised model trained on ``store`` with ``cameras``;
        ``aabbs`` and ``centroids`` place the experts; the model, its
        optimizer state, the store and the draws live on ``device`` (the
        CUDA card unless the caller passes another)."""
        self = cls(config, device)
        if store.device != self.device:
            raise ValueError(f"the ray store is on {store.device}, the trainer on {self.device}")
        self._check_supported()
        self.store = store
        self.cameras = cameras.to(self.device)
        self._load_features = config.pipeline.model.use_semantics
        self._init_state(config.pipeline.model, aabbs, centroids, num_train_cameras,
                         num_train_videos)
        self.datamanager = DataManager(_WholeStore(store),
                                       config.pipeline.datamanager.train_num_rays_per_batch,
                                       seed=config.seed)
        return self

    def setup(self, run_dir: Optional[Path] = None, write_config: bool = True) -> None:
        """``run_dir`` overrides config.run_dir() (eval_setup passes the
        directory the config was loaded from); ``write_config=False``
        leaves the run's config.yml untouched."""
        self._check_supported()
        cfg = self.config
        pcfg = cfg.pipeline
        self.run_dir = Path(run_dir) if run_dir is not None else cfg.run_dir()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        if write_config:
            save_config(cfg, self.run_dir / "config.yml")

        self.train_outputs: DataparserOutputs = parse(pcfg.dataparser, split="train")
        model_cfg = dataclasses.replace(
            pcfg.model, pose_scale_factor=self.train_outputs.pose_scale_factor)
        outputs = self.train_outputs
        labels = None
        if outputs.predicted_labels is not None:
            train_mask = [not it.is_val for it in outputs.all_items]
            labels = outputs.predicted_labels[np.nonzero(train_mask)[0]]
        self._load_features = pcfg.datamanager.load_features and model_cfg.use_semantics
        dm = pcfg.datamanager
        self.dataset = PixelChunkDataset(
            outputs.items, labels, split="train", images_per_chunk=dm.images_per_chunk,
            chunk_ratio=dm.chunk_ratio, group_balanced=dm.group_balanced,
            load_features=self._load_features, mask_seg_classes=dm.mask_seg_classes,
            num_threads=dm.num_threads)
        self.cameras = make_camera_params(outputs.items, self.device)

        # The eval split (empty when train_split_fraction == 1.0, as in the
        # tile configs; image-eval cadence is then skipped).
        self.eval_items = [it for it in outputs.all_items if it.is_val]
        self.eval_cameras = (make_camera_params(self.eval_items, self.device)
                             if self.eval_items else None)
        if self.eval_items and cfg.steps_per_eval_batch > 0:
            eval_labels = None
            if outputs.predicted_labels is not None:
                val_mask = [it.is_val for it in outputs.all_items]
                eval_labels = outputs.predicted_labels[np.nonzero(val_mask)[0]]
            eval_ds = PixelChunkDataset(
                outputs.all_items, eval_labels, split="val",
                images_per_chunk=min(dm.images_per_chunk, len(self.eval_items)),
                chunk_ratio=dm.chunk_ratio, group_balanced=False,
                load_features=self._load_features, mask_seg_classes=dm.mask_seg_classes,
                num_threads=dm.num_threads)
            self._eval_dm = DataManager(eval_ds, batch_size=dm.eval_num_rays_per_batch,
                                        seed=cfg.seed + 7)

        self._init_state(model_cfg, outputs.aabbs, outputs.centroids,
                         num_train_cameras=len(outputs.items),
                         num_train_videos=outputs.num_videos)
        self.writer = Writer(self.run_dir, vis=cfg.vis)

        if cfg.device_ray_store_mb > 0:
            self.store = DeviceRayStore.maybe_build(outputs.items, self._load_features,
                                                    cfg.device_ray_store_mb, device=self.device)
            if self.store is not None:
                print(f"device ray store staged on {self.device}", flush=True)
            else:
                # Over the whole-set cap (or images of several sizes): the
                # active chunk's rows on the device, the next one staged
                # behind the current one's steps.
                self._chunk_store = ChunkDeviceStore(cfg.device_ray_store_mb, device=self.device)
                print(f"chunk-granularity device store attached (cap "
                      f"{cfg.device_ray_store_mb} MB)", flush=True)

        ckpt = latest_checkpoint(Path(cfg.load_dir) if cfg.load_dir is not None
                                 else self.run_dir)
        if ckpt is not None:
            self.start_step = load_checkpoint(ckpt, self.model, self.optimizers)
            print(f"resumed from {ckpt} at step {self.start_step}", flush=True)
        self.step = self.start_step
        # Resume: the chunk stream from a step-offset position (not the one
        # steps 0..start already consumed), the draws from (seed + 1,
        # start), and the proposal-update counter at its uninterrupted value.
        self.generator.manual_seed(draw_seed(cfg.seed, self.start_step))
        self.datamanager = DataManager(self.dataset, batch_size=dm.train_num_rays_per_batch,
                                       seed=cfg.seed + self.start_step,
                                       chunk_store=self._chunk_store)
        for s in range(self.start_step):
            self.update_sched.step_cb(s, self.update_sched.updated(s))

    # ---------------------------------------------------------------- training

    def train(self, num_steps: Optional[int] = None,
              callback: Optional[Callable[[int, Dict[str, float]], None]] = None) -> None:
        """Train to max_num_iterations, or ``num_steps`` steps (no final save
        or close then, so the caller may train on). ``callback(step,
        metrics)`` sees each step's metrics plus ``step_seconds`` (host
        clock, synchronised) and ``grid_refreshed``."""
        cfg, mcfg = self.config, self.model_config
        rays = cfg.pipeline.datamanager.train_num_rays_per_batch
        end = (cfg.max_num_iterations if num_steps is None
               else min(self.step + num_steps, cfg.max_num_iterations))
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        while self.step < end:
            with profiler.span("trainer.step"):
                step = self.step
                t0 = time.perf_counter()
                with profiler.span("trainer.batch"):
                    batch = self._make_batch(self.datamanager.next_batch())
                updated = self.update_sched.updated(step)
                refreshed = mcfg.use_prop_grid and (self.prop_grid is None
                                                    or prop_grid_refresh_due(mcfg, step))
                if refreshed:
                    self.prop_grid = self.model.make_prop_grid()
                metrics = train_step(self.model, self.optimizers, self.cameras, batch,
                                     step_scalars(mcfg, step), stop_prop_grad=not updated,
                                     microbatch_rays=cfg.microbatch_rays,
                                     prop_grid=self.prop_grid, generator=self.generator)
                self.update_sched.step_cb(step, updated)
                sync()
                metrics["step_seconds"] = time.perf_counter() - t0
                metrics["grid_refreshed"] = float(refreshed)
                self.step += 1
                if callback is not None:
                    callback(step, metrics)
                if self.run_dir is not None:
                    self._cadences(step, metrics, rays)
        if num_steps is None and self.run_dir is not None:
            # The final checkpoint, labelled with the step the state holds;
            # none when no step ran (a rerun below the trained step), so the
            # newest checkpoint is neither mislabelled nor deleted.
            if self.step > self.start_step or latest_checkpoint(self.run_dir) is None:
                save_checkpoint(self.run_dir, self.step, self.model, self.optimizers)
            self.close()

    def _cadences(self, step: int, metrics: Dict[str, float], rays: int) -> None:
        cfg = self.config
        if step % self.writer.steps_per_log == 0:
            logged = {k: v for k, v in metrics.items() if k not in ("step_seconds",
                                                                     "grid_refreshed")}
            self.writer.log_step(step, logged, rays, metrics["step_seconds"],
                                 cfg.max_num_iterations)
        if self._eval_dm is not None and step > 0 and step % cfg.steps_per_eval_batch == 0:
            self._eval_batch(step)
        if (self.eval_cameras is not None and cfg.steps_per_eval_image > 0 and step > 0
                and step % cfg.steps_per_eval_image == 0):
            self._eval_image(step)
        if cfg.steps_per_save > 0 and step > 0 and (step + 1) % cfg.steps_per_save == 0:
            save_checkpoint(self.run_dir, step + 1, self.model, self.optimizers)

    def _make_batch(self, batch: Dict, use_store: bool = True) -> Dict[str, torch.Tensor]:
        """The step's batch on the device. Chunk-store batches arrive as
        device tensors; whole-store batches gather by ray_index; host values
        are copied. The whole store holds TRAIN images only (image indices
        are split-local), so eval batches pass use_store=False."""
        use_sem = self.model_config.use_semantics
        if use_store and isinstance(batch.get(K.RAY_INDEX), torch.Tensor):
            if K.FEATURES in batch and not use_sem:
                batch = {k: v for k, v in batch.items() if k != K.FEATURES}
            return batch
        if use_store and self.store is not None:
            return self.store.batch(batch[K.RAY_INDEX], with_features=(
                self.store.features is not None and self._load_features))
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        out = {"ray_index": put(batch[K.RAY_INDEX]), "rgb": put(batch[K.RGB]),
               "sky": put(batch[K.SKY]), "depth": put(batch[K.DEPTH])}
        if K.FEATURES in batch and use_sem:
            out["features"] = put(batch[K.FEATURES])
        return out

    @torch.no_grad()
    def _eval_batch(self, step: int) -> None:
        """Losses and PSNR on an eval-split pixel batch (eval mode: the mean
        appearance embedding), with the eval camera table."""
        mcfg = self.model_config
        batch = self._make_batch(self._eval_dm.next_batch(), use_store=False)
        scalars = step_scalars(mcfg, step)
        bundle = generate_rays(self.eval_cameras, batch["ray_index"])
        outputs = self.model(bundle, train=False, prop_grid=self.prop_grid,
                             anneal=scalars.anneal, stop_prop_grad=True)
        losses = compute_losses(outputs, batch, mcfg, scalars.sigma, scalars.los_mult)
        host = {f"eval_{k}": float(v) for k, v in losses.items()}
        host["eval_total_loss"] = sum(host.values())
        host["eval_psnr"] = psnr(float(torch.mean((outputs["rgb"] - batch["rgb"]) ** 2)))
        self.writer.announce("eval batch", host, step)

    def _eval_image(self, step: int) -> None:
        """Render one eval image and log PSNR / SSIM (and LPIPS if any)."""
        from .evaluator import ImageRenderer, image_metrics

        idx = (step // self.config.steps_per_eval_image) % len(self.eval_items)
        item = self.eval_items[idx]
        outputs = ImageRenderer(self.model_config).render(
            self.model, self.eval_cameras, idx, item.H, item.W, prop_grid=self.prop_grid)
        metrics = image_metrics(outputs["rgb"], item.load_image(),
                                with_lpips=self.config.eval_lpips, device=self.device)
        self.writer.announce(f"eval image {idx}",
                             {f"eval_{k}": v for k, v in metrics.items()}, step)

    def close(self) -> None:
        """Stop the prefetch threads and close the writer."""
        self.datamanager.close()
        if self._eval_dm is not None:
            self._eval_dm.close()
        if self.writer is not None:
            self.writer.close()


def eval_setup(config_path: Path, num_devices: Optional[int] = None,
               device=None) -> Tuple[TrainerConfig, Trainer]:
    """Rebuild a trained run from its config.yml and load its latest
    checkpoint; the run's config.yml is left as it is. ``num_devices``
    overrides the run's (setup refuses any width but one)."""
    config_path = Path(config_path)
    config: TrainerConfig = load_config(config_path)
    run_dir = config_path.parent
    config = dataclasses.replace(config, load_dir=run_dir)
    if num_devices is not None:
        config = dataclasses.replace(config, num_devices=num_devices)
    trainer = Trainer(config, device=device)
    trainer.setup(run_dir=run_dir, write_config=False)
    return config, trainer
