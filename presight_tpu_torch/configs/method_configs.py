"""Named method configs, the registry behind the train CLI
(presight_tpu/configs/method_configs.py, built the same way):

  {location}-{camera|monodepth}-dino-c{i}[-tpu]

for boston-seaport (8 tiles, 16 aabbs), singapore-queenstown (4, 12),
singapore-onenorth (4, 16) and singapore-hollandvillage (2, 8), 72 names,
plus ``synthetic-demo`` over the generated fixture.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

from . import (
    DataManagerConfig,
    DataParserConfig,
    NerfactoNuscMSConfig,
    OptimizerGroupConfig,
    PipelineConfig,
    TrainerConfig,
)

DATA_ROOT = Path("data/nuScenes")
POSE_RESCALE_FACTOR = 0.05
BS_SCALE = 8
MAX_ITERATIONS = 100_000
# location -> (number of tiles, number of AABB experts)
TILES = {
    "boston-seaport": (8, 16),
    "singapore-queenstown": (4, 12),
    "singapore-onenorth": (4, 16),
    "singapore-hollandvillage": (2, 8),
}


def tile_optimizers(max_iterations: int = MAX_ITERATIONS) -> Dict[str, OptimizerGroupConfig]:
    """Adam 1e-2 (eps 1e-15, wd 1e-5), 10% warmup, x0.33 at 25/50/75% of
    the run, for both groups."""
    common = dict(
        lr=1e-2, eps=1e-15, weight_decay=1e-5, max_steps=max_iterations,
        warmup_steps=max_iterations // 10,
        milestones=(max_iterations // 4, max_iterations // 2, max_iterations * 3 // 4),
        gamma=0.33,
    )
    return {"proposal_networks": OptimizerGroupConfig(**common),
            "fields": OptimizerGroupConfig(**common)}


def _base_model(max_iterations: int) -> NerfactoNuscMSConfig:
    return NerfactoNuscMSConfig(
        near_plane=0.1 * POSE_RESCALE_FACTOR,
        far_plane=1000.0 * POSE_RESCALE_FACTOR,
        piecewise_sampler_threshold=100.0 * POSE_RESCALE_FACTOR,
        proposal_weights_anneal_max_num_iters=max_iterations // 10,
        proposal_warmup=max_iterations // 10,
        pose_scale_factor=POSE_RESCALE_FACTOR,
    )


def _tile_config(location: str, tile: int, num_aabbs: int, depth: str,
                 max_iterations: int = MAX_ITERATIONS) -> TrainerConfig:
    name = f"{location}-{depth}-dino-c{tile}"
    if depth == "monodepth":
        model = dataclasses.replace(
            _base_model(max_iterations),
            use_lidar_loss=False,
            use_monodepth_loss=True,
            expected_depth_loss_mult=0.1,
            line_of_sight_mult=0.01,
            monodepth_depth_upperbound=25.0,
            line_of_sight_decay_steps=max_iterations,
            line_of_sight_start_step=max_iterations // 20,
            line_of_sight_end_step=max_iterations,
            line_of_sight_max_sigma=6.0,
            line_of_sight_min_sigma=4.0,
            distortion_loss_mult=0.01,
        )
        depth_type = "monodepth"
    elif depth == "camera":
        model = dataclasses.replace(_base_model(max_iterations), use_lidar_loss=False)
        depth_type = "none"
    else:
        raise ValueError(f"depth must be 'camera' or 'monodepth', got {depth!r}")
    return TrainerConfig(
        method_name=f"{location}-{depth}",
        experiment_name=name,
        output_dir=Path("outputs"),
        max_num_iterations=max_iterations,
        pipeline=PipelineConfig(
            dataparser=DataParserConfig(
                data_dir=DATA_ROOT,
                location=location,
                centroid_name=str(tile),
                num_aabbs=num_aabbs,
                depth_type=depth_type,
            ),
            datamanager=DataManagerConfig(train_num_rays_per_batch=8192 * BS_SCALE),
            model=model,
        ),
        optimizers=tile_optimizers(max_iterations),
    )


def _synthetic_demo() -> TrainerConfig:
    """The demo over the generated synthetic fixture (data/synthetic.py)."""
    iters = 200
    model = dataclasses.replace(
        _base_model(iters),
        num_levels=6, max_res=1024, log2_hashmap_size=14, features_per_level=2,
        hidden_dim=32, hidden_dim_color=32,
        num_proposal_samples_per_ray=(48, 24), num_nerf_samples_per_ray=24,
        proposal_net_args_list=(
            dict(features_per_level=1, log2_hashmap_size=12, num_levels=5,
                 base_res=16, max_res=256),
            dict(features_per_level=1, log2_hashmap_size=12, num_levels=5,
                 base_res=16, max_res=512),
        ),
        use_lidar_loss=True,
        proposal_warmup=iters // 4,
        proposal_weights_anneal_max_num_iters=iters // 4,
        line_of_sight_start_step=iters // 4,
        line_of_sight_end_step=iters,
        line_of_sight_decay_steps=iters,
    )
    return TrainerConfig(
        method_name="synthetic-demo",
        experiment_name="synthetic-demo",
        max_num_iterations=iters,
        steps_per_save=100,
        pipeline=PipelineConfig(
            dataparser=DataParserConfig(
                data_dir=Path("data/synthetic"),
                location="synthetic-city",
                num_aabbs=2,
                depth_type="lidar",
                centroids_dir=Path("data/synthetic/centroids"),
                train_split_fraction=0.9,
            ),
            datamanager=DataManagerConfig(
                train_num_rays_per_batch=2048,
                images_per_chunk=16,
                chunk_ratio=0.2,
            ),
            model=model,
        ),
        optimizers=tile_optimizers(iters),
    )


def _tpu_profile(cfg: TrainerConfig) -> TrainerConfig:
    """The -tpu variant of a tile config: 'shared' hash storage, a shared
    proposal MLP, no remat, 4 levels x 10 features at 2^17 rows, the
    cached 64^3 first proposal round, 64 + 32 proposal and 48 final
    samples, two-level proposal fields, microbatches of 1024 rays."""
    model = dataclasses.replace(
        cfg.pipeline.model,
        hash_storage="shared",
        prop_shared_mlp=True,
        remat=False,
        log2_hashmap_size=17,
        num_levels=4,
        features_per_level=10,
        prop_grid_res=64,
        num_proposal_samples_per_ray=(64, 32),
        num_nerf_samples_per_ray=48,
        proposal_net_args_list=(
            dict(features_per_level=4, log2_hashmap_size=16, num_levels=2,
                 base_res=16, max_res=1024),
            dict(features_per_level=4, log2_hashmap_size=16, num_levels=2,
                 base_res=16, max_res=4096),
        ),
    )
    return dataclasses.replace(
        cfg,
        experiment_name=cfg.experiment_name + "-tpu",
        method_name=cfg.method_name + "-tpu",
        microbatch_rays=1024,
        pipeline=dataclasses.replace(cfg.pipeline, model=model),
    )


def tile_trainer_config(location: str, tile: int, depth: str, tpu: bool = True,
                        max_iterations: int = MAX_ITERATIONS) -> TrainerConfig:
    """The config of ``{location}-{depth}-dino-c{tile}[-tpu]``: 65,536 rays
    per step (8192 x BS_SCALE); microbatches of 1024 rays on the -tpu
    profile, 4096 otherwise."""
    num_tiles, num_aabbs = TILES[location]
    if not 0 <= tile < num_tiles:
        raise ValueError(f"{location} has tiles 0..{num_tiles - 1}, got {tile}")
    cfg = _tile_config(location, tile, num_aabbs, depth, max_iterations)
    return _tpu_profile(cfg) if tpu else cfg


def tile_model_config(location: str, tile: int, depth: str, tpu: bool = True,
                      max_iterations: int = MAX_ITERATIONS) -> NerfactoNuscMSConfig:
    """The model config of ``{location}-{depth}-dino-c{tile}[-tpu]``. The
    tile selects centroids, not model shapes; its expert count is
    ``TILES[location][1]``."""
    return tile_trainer_config(location, tile, depth, tpu, max_iterations).pipeline.model


def build_method_configs() -> Dict[str, TrainerConfig]:
    configs: Dict[str, TrainerConfig] = {}
    for location, (num_tiles, _) in TILES.items():
        for depth in ("monodepth", "camera"):
            for i in range(num_tiles):
                for tpu in (False, True):
                    cfg = tile_trainer_config(location, i, depth, tpu)
                    configs[cfg.experiment_name] = cfg
    configs["synthetic-demo"] = _synthetic_demo()
    return configs


method_configs = build_method_configs()
