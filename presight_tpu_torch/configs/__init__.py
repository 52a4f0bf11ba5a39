"""Config dataclasses of the model, mirrored field for field.

These mirror ``presight_tpu``'s dataclasses (same names, fields and
defaults) instead of importing them, because importing them from the JAX
package pulls in jax, which the GPU machine does not have:

  * NerfactoNuscMSConfig  <- presight_tpu/models/nerfacto_ms.py:58-194
  * INGPFieldConfig       <- presight_tpu/fields/ingp_field.py:37-74
  * PropFieldConfig       <- presight_tpu/fields/prop_field.py:25-54
  * SkyFieldConfig        <- presight_tpu/fields/sky_field.py:22-28
  * HashEncodingConfig    <- presight_tpu/ops/hash_encoding.py:66-132
  * SpacingSpec           <- presight_tpu/ops/samplers.py:29-53
  * OptimizerGroupConfig  <- presight_tpu/engine/optimizers.py:25-34
  * DataParserConfig      <- presight_tpu/data/dataparser.py:64-78
  * DataManagerConfig     <- presight_tpu/data/datamanager.py:27-36
  * PipelineConfig        <- presight_tpu/engine/trainer.py:46-50
  * TrainerConfig         <- presight_tpu/engine/trainer.py:53-111

The named method registry is configs/method_configs.py and the config.yml
reader and writer configs/config_io.py. ``tile_model_config`` and
``tile_trainer_config`` (re-exported here) build a named tile's configs.
Parity tests hold both against the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.constants import DEFAULT_MASK_SEG_CLASSES, NUSCENES_CAMERAS


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    num_levels: int = 16
    min_res: int = 16
    max_res: int = 1024
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    hash_init_scale: float = 1e-4
    storage: str = "corner"

    @property
    def table_size(self) -> int:
        return 2 ** self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def row_features(self) -> int:
        return self.features_per_level * (
            8 if self.storage in ("cell", "shared") else 1
        )

    def scalings(self) -> np.ndarray:
        """Per-level grid resolutions; the power runs in float32, as the
        executed reference does (f64 shifts boundary levels)."""
        levels = np.arange(self.num_levels).astype(np.float32)
        if self.num_levels > 1:
            growth = np.exp(
                (np.log(self.max_res) - np.log(self.min_res)) / (self.num_levels - 1)
            )
        else:
            growth = 1.0
        return np.floor(
            (np.float32(self.min_res) * np.float32(growth) ** levels).astype(np.float32)
        ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class INGPFieldConfig:
    num_levels: int = 10
    base_res: int = 16
    max_res: int = 16384
    log2_hashmap_size: int = 20
    features_per_level: int = 4
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    appearance_embedding_dim: int = 16
    use_semantics: bool = True
    semantic_dim: int = 64
    hidden_dim_semantic_head: int = 64
    hash_init_scale: float = 1e-4
    hash_storage: str = "corner"

    @property
    def hash(self) -> HashEncodingConfig:
        return HashEncodingConfig(
            num_levels=self.num_levels,
            min_res=self.base_res,
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            features_per_level=self.features_per_level,
            hash_init_scale=self.hash_init_scale,
            storage=self.hash_storage,
        )

    @property
    def sem_dim(self) -> int:
        return self.semantic_dim if self.use_semantics else 0

    @property
    def base_out_dim(self) -> int:
        return 1 + self.geo_feat_dim + self.sem_dim


@dataclasses.dataclass(frozen=True)
class PropFieldConfig:
    num_levels: int = 8
    base_res: int = 16
    max_res: int = 1024
    log2_hashmap_size: int = 20
    features_per_level: int = 1
    num_layers: int = 2
    hidden_dim: int = 64
    hash_init_scale: float = 1e-4
    hash_storage: str = "corner"
    shared_mlp: bool = False

    @property
    def hash(self) -> HashEncodingConfig:
        return HashEncodingConfig(
            num_levels=self.num_levels,
            min_res=self.base_res,
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            features_per_level=self.features_per_level,
            hash_init_scale=self.hash_init_scale,
            storage=self.hash_storage,
        )


@dataclasses.dataclass(frozen=True)
class SkyFieldConfig:
    mlp_num_layers: int = 3
    mlp_layer_width: int = 32
    appearance_embedding_dim: int = 16
    use_semantics: bool = True
    semantic_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SpacingSpec:
    """Monotone spacing warp s = fn(t), t = fn_inv(s) (piecewise: uniform
    below ``threshold``, linear in disparity above)."""

    kind: str = "piecewise_threshold"
    threshold: float = 1.0

    def fn(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "uniform":
            return t
        thr = self.threshold
        return torch.where(t < thr, t / (2.0 * thr),
                           1.0 - thr / (2.0 * torch.clamp(t, min=1e-12)))

    def fn_inv(self, s: torch.Tensor) -> torch.Tensor:
        if self.kind == "uniform":
            return s
        thr = self.threshold
        return torch.where(s < 0.5, s * (2.0 * thr),
                           thr / torch.clamp(2.0 - 2.0 * s, min=1e-12))


@dataclasses.dataclass(frozen=True)
class NerfactoNuscMSConfig:
    eval_num_rays_per_chunk: int = 1 << 15
    near_plane: float = 0.1
    far_plane: float = 1000.0
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 10
    base_res: int = 16
    max_res: int = 16384
    log2_hashmap_size: int = 20
    features_per_level: int = 4
    num_proposal_samples_per_ray: Tuple[int, ...] = (128, 64)
    num_nerf_samples_per_ray: int = 64
    proposal_update_every: int = 5
    proposal_warmup: int = 1000
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[Dict, ...] = (
        dict(features_per_level=1, log2_hashmap_size=20, num_levels=8,
             base_res=16, max_res=1024),
        dict(features_per_level=1, log2_hashmap_size=20, num_levels=8,
             base_res=16, max_res=4096),
    )
    piecewise_sampler_threshold: float = 1.0
    interlevel_loss_mult: float = 1.0
    enable_z_anti_aliasing: bool = True
    pulse_width: Tuple[float, ...] = (0.03, 0.003)
    distortion_loss_mult: float = 0.002
    use_proposal_weight_anneal: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    appearance_embed_dim: int = 4
    video_embed_dim: int = 12
    use_sky_model: bool = True
    num_sky_mlp_layers: int = 3
    sky_mlp_dims: int = 32
    sky_loss_mult: float = 0.001
    use_lidar_loss: bool = True
    expected_depth_loss_mult: float = 1.0
    lidar_depth_upperbound: float = 75.0
    line_of_sight_mult: float = 0.1
    line_of_sight_decay_steps: int = 5000
    line_of_sight_start_step: int = 1000
    line_of_sight_end_step: int = 30000
    line_of_sight_max_sigma: float = 5.0
    line_of_sight_min_sigma: float = 2.0
    use_semantics: bool = True
    semantic_dim: int = 64
    semantic_loss_mult: float = 0.5
    use_monodepth_loss: bool = False
    monodepth_loss_inverse: bool = False
    monodepth_depth_upperbound: float = 40.0
    pose_scale_factor: float = 1.0
    prop_shared_mlp: bool = False
    prop_grid_res: int = 0
    prop_grid_update_every: int = 128
    prop_grid_warmup_steps: int = 1024
    prop_grid_warmup_every: int = 16
    compute_dtype: str = "float32"
    hash_storage: str = "corner"
    remat: bool = True

    @property
    def appearance_dim(self) -> int:
        return self.appearance_embed_dim + self.video_embed_dim

    @property
    def field(self) -> INGPFieldConfig:
        return INGPFieldConfig(
            num_levels=self.num_levels,
            base_res=self.base_res,
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            features_per_level=self.features_per_level,
            hidden_dim=self.hidden_dim,
            hidden_dim_color=self.hidden_dim_color,
            appearance_embedding_dim=self.appearance_dim,
            use_semantics=self.use_semantics,
            semantic_dim=self.semantic_dim,
            hash_storage=self.hash_storage,
        )

    @property
    def use_prop_grid(self) -> bool:
        return self.prop_grid_res > 0

    def prop(self, i: int) -> PropFieldConfig:
        args = self.proposal_net_args_list[min(i, len(self.proposal_net_args_list) - 1)]
        return PropFieldConfig(
            num_levels=args["num_levels"],
            base_res=args["base_res"],
            max_res=args["max_res"],
            log2_hashmap_size=args["log2_hashmap_size"],
            features_per_level=args["features_per_level"],
            hash_storage=self.hash_storage,
            shared_mlp=self.prop_shared_mlp,
        )

    @property
    def sky(self) -> SkyFieldConfig:
        return SkyFieldConfig(
            mlp_num_layers=self.num_sky_mlp_layers,
            mlp_layer_width=self.sky_mlp_dims,
            appearance_embedding_dim=self.appearance_dim,
            use_semantics=self.use_semantics,
            semantic_dim=self.semantic_dim,
        )

    @property
    def spacing(self) -> SpacingSpec:
        return SpacingSpec("piecewise_threshold", threshold=self.piecewise_sampler_threshold)


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    weight_decay: float = 1e-5
    max_steps: int = 100_000
    warmup_steps: int = 10_000
    milestones: Tuple[int, ...] = (25_000, 50_000, 75_000)
    gamma: float = 0.33
    warmup_start_factor: float = 0.01


@dataclasses.dataclass(frozen=True)
class DataParserConfig:
    data_dir: Path = Path("data/nuScenes")
    location: str = "singapore-onenorth"
    centroid_name: str = "0"
    scene_names: Optional[Tuple[str, ...]] = None  # overrides centroid json
    cameras: Tuple[str, ...] = NUSCENES_CAMERAS
    train_split_fraction: float = 1.0
    num_aabbs: int = 1
    image_downscale_factor: float = 1.0
    pose_scale_factor: float = 0.05
    pose_normalize: bool = True
    use_gt_masks: bool = False
    depth_type: str = "none"  # lidar | monodepth | none
    centroids_dir: Optional[Path] = None  # dir holding {location}_centroids.json


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    train_num_rays_per_batch: int = 65536
    eval_num_rays_per_batch: int = 8192
    images_per_chunk: int = 512
    chunk_ratio: float = 0.025
    group_balanced: bool = True
    load_features: bool = True
    mask_seg_classes: Tuple[str, ...] = DEFAULT_MASK_SEG_CLASSES
    num_threads: int = 8


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataparser: DataParserConfig = DataParserConfig()
    datamanager: DataManagerConfig = DataManagerConfig()
    model: NerfactoNuscMSConfig = NerfactoNuscMSConfig()


def _default_optimizers() -> Dict[str, OptimizerGroupConfig]:
    return {"proposal_networks": OptimizerGroupConfig(), "fields": OptimizerGroupConfig()}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX TrainerConfig's fields and defaults. The port's Trainer
    refuses (NotImplementedError from setup) what it does not run yet:
    num_devices other than 1, camera_optimizer_mode 'so3xr3' and
    gradient_accumulation_steps above 1; zero1 matters only with more than
    one device."""

    method_name: str = "presight"
    experiment_name: str = "default"
    output_dir: Path = Path("outputs")
    timestamp: str = ""
    max_num_iterations: int = 100_000
    steps_per_save: int = 2_500
    steps_per_eval_batch: int = 1_000
    steps_per_eval_image: int = 5_000
    seed: int = 42
    pipeline: PipelineConfig = PipelineConfig()
    optimizers: Dict[str, OptimizerGroupConfig] = dataclasses.field(
        default_factory=_default_optimizers)
    gradient_accumulation_steps: int = 1
    microbatch_rays: int = 4096
    camera_optimizer_mode: str = "off"
    num_devices: int = 1
    zero1: bool = True
    device_ray_store_mb: int = 512
    vis: str = "local"
    eval_lpips: bool = True
    load_dir: Optional[Path] = None

    def run_dir(self) -> Path:
        ts = self.timestamp or "run"
        return Path(self.output_dir) / self.experiment_name / self.method_name / ts


from .method_configs import (  # noqa: E402  (method_configs builds on the classes above)
    BS_SCALE,
    MAX_ITERATIONS,
    POSE_RESCALE_FACTOR,
    TILES,
    tile_model_config,
    tile_optimizers,
    tile_trainer_config,
)
