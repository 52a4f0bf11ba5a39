"""Prior consumption: load city priors and voxelize them into model inputs.

The port's copy of presight_tpu/prior/consume.py (numpy, on the host): the
stage-3 side of the prior contract, which reads the pickles that
scripts/extract_priors.py writes.

  * CityPriors — reference NuscPrior
    (occupancy/mmdet3d/datasets/prior_utils/city_prior.py:46-149, with the
    online-mapping near-copy): load per-tile pickles, add origin, negate x/y
    (nerfstudio -> nuScenes coords), normalize hits by mean; per-sample
    rotated-bbox crop then exact ego-frame filter.
  * VoxelizePriorPoints — reference transform
    (occupancy/mmdet3d/datasets/pipelines/prior_points.py:12-157): optional
    pose-error noise, BEV aug replay, first-come voxelization (native C++,
    native/voxelize.cpp),
    hit-weighted per-voxel feature mean + log(hit-sum) channel, xyz
    normalized to (0,1), random-drop augmentation. Every random draw comes
    from the caller's RandomState.
  * pad_prior_voxels — the model's padded (B, V, 68) / (B, V, 3) / (B, V)
    inputs, as the JAX package's Stage3OccDataset.batch pads them
    (data/stage3_pipeline.py:358-396).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .. import native


@dataclasses.dataclass
class PriorPoints:
    xyz: np.ndarray  # (N, 3)
    features: np.ndarray  # (N, D) f16
    hits: np.ndarray  # (N, 1) f32, mean-normalized

    def __len__(self) -> int:
        return len(self.xyz)

    @staticmethod
    def empty(feat_dim: int) -> "PriorPoints":
        return PriorPoints(
            xyz=np.zeros((0, 3), np.float64),
            features=np.zeros((0, feat_dim), np.float32),
            hits=np.zeros((0, 1), np.float32),
        )


def _quat_to_rotmat(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix (pyquaternion convention)."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


class CityPriors:
    """NuscPrior equivalent (city_prior.py:46-149)."""

    def __init__(self, data_root: str, prior_city_parts: Dict[str, int],
                 pc_range: Sequence[float], prior_type: str = "camera_priors"):
        self.pc_range = list(pc_range)
        self.priors: Dict[str, PriorPoints] = {}
        if prior_type not in ("camera_priors", "monodepth_priors", "priors"):
            raise ValueError(f"unknown prior type {prior_type}")
        start = time.time()
        feat_dim = 64
        for city, num_parts in prior_city_parts.items():
            xyzs, featss, hitss = [], [], []
            for i in range(num_parts):
                filename = os.path.join(data_root, prior_type, city, f"{city}-c{i}.pkl")
                with open(filename, "rb") as f:
                    p = pickle.load(f)
                xyz = p["points"].astype(np.float32) + p["origin"].astype(np.float32)
                xyz[:, 0:2] = -xyz[:, 0:2]  # nerfstudio -> nuScenes coords
                hits = p["hits"].astype(np.float32)
                hits = hits / hits.mean()
                xyzs.append(xyz)
                featss.append(p["features"].astype(np.float16))
                hitss.append(hits[:, None])
                feat_dim = featss[-1].shape[-1]
            self.priors[city] = PriorPoints(
                xyz=np.concatenate(xyzs) if xyzs else np.zeros((0, 3), np.float32),
                features=np.concatenate(featss) if featss else np.zeros((0, feat_dim), np.float16),
                hits=np.concatenate(hitss) if hitss else np.zeros((0, 1), np.float32),
            )
        self.n_dim_feats = feat_dim
        print(f"loaded priors in {time.time() - start:.2f}s")

    def get_prior_points(self, location: str, e2g_translation, e2g_rotation) -> PriorPoints:
        """Rotated-bbox crop + exact ego-frame filter (city_prior.py:81-149)."""
        if location not in self.priors:
            return PriorPoints.empty(self.n_dim_feats)

        rot = _quat_to_rotmat(e2g_rotation)
        t = np.asarray(e2g_translation, np.float64)
        pr = self.pc_range

        ego_box = np.array([
            [pr[3], pr[4], 0.0],
            [pr[3], pr[1], 0.0],
            [pr[0], pr[1], 0.0],
            [pr[0], pr[4], 0.0],
        ])
        global_box = np.einsum("lk,ik->il", rot, ego_box) + t
        gmin = global_box.min(axis=0)
        gmax = global_box.max(axis=0)

        prior = self.priors[location]
        sel = (
            (prior.xyz[:, 0] <= gmax[0]) & (prior.xyz[:, 0] >= gmin[0])
            & (prior.xyz[:, 1] <= gmax[1]) & (prior.xyz[:, 1] >= gmin[1])
        )
        xyz = prior.xyz[sel].astype(np.float64)
        feats = prior.features[sel]
        hits = prior.hits[sel]
        xyz = np.einsum("lk,ik->il", rot.T, xyz - t)
        sel2 = (
            (xyz[:, 0] <= pr[3]) & (xyz[:, 0] >= pr[0])
            & (xyz[:, 1] <= pr[4]) & (xyz[:, 1] >= pr[1])
            & (xyz[:, 2] <= pr[5]) & (xyz[:, 2] >= pr[2])
        )
        return PriorPoints(xyz[sel2], feats[sel2], hits[sel2])


@dataclasses.dataclass
class VoxelizePriorPoints:
    """prior_points.py:12-157 transform; numpy/C++ host-side (it feeds the
    data pipeline, not the device graph)."""

    pc_range: Sequence[float]
    voxel_size: Sequence[float]
    max_voxels: int = 20000
    max_points_per_voxel: int = 35
    load_features: bool = True
    random_drop: bool = False
    max_drop_rate: float = 1.0
    pose_error_scale: float = 0.0

    def __post_init__(self):
        pr = np.asarray(self.pc_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        assert np.all(np.ceil((pr[3:] - pr[:3]) / vs) == np.floor((pr[3:] - pr[:3]) / vs)), (
            f"voxel_size {self.voxel_size} does not evenly tile pc_range "
            f"{self.pc_range}; the BEV grid would have a fractional cell"
        )

    def __call__(self, prior_points: PriorPoints, rotate_bda: float = 0.0,
                 flip_dx: bool = False, flip_dy: bool = False,
                 scale_ratio: float = 1.0,
                 rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState()
        pr = np.asarray(self.pc_range, np.float64)

        if self.load_features:
            pts = np.concatenate([
                prior_points.xyz.astype(np.float64),
                prior_points.features.astype(np.float64),
                prior_points.hits.astype(np.float64),
            ], axis=-1)
        else:
            pts = np.concatenate([
                prior_points.xyz.astype(np.float64),
                prior_points.hits.astype(np.float64),
            ], axis=-1)

        if self.pose_error_scale > 0:
            pts[:, :3] += rng.normal(scale=self.pose_error_scale)

        valid = (
            (pts[:, 0] >= pr[0]) & (pts[:, 0] <= pr[3])
            & (pts[:, 1] >= pr[1]) & (pts[:, 1] <= pr[4])
            & (pts[:, 2] >= pr[2]) & (pts[:, 2] <= pr[5])
        )
        pts = pts[valid]
        if len(pts) == 0:
            return {
                "prior_voxels": pts.astype(np.float32),
                "prior_voxels_coords": np.zeros((0, 3), np.int32),
            }

        # BEV augmentation replay (prior_points.py:95-116).
        ang = rotate_bda / 180.0 * np.pi
        rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        scale = np.eye(3) * scale_ratio
        flip = np.eye(3)
        if flip_dx:
            flip = flip @ np.diag([-1.0, 1.0, 1.0])
        if flip_dy:
            flip = flip @ np.diag([1.0, -1.0, 1.0])
        mat = flip @ (scale @ rot)
        pts[:, :3] = np.einsum("ik,jk->ji", mat, pts[:, :3])

        rng.shuffle(pts)
        voxels, coords, _ = native.points_to_voxel(
            pts.astype(np.float32),
            voxel_size=self.voxel_size,
            coors_range=self.pc_range,
            max_points=self.max_points_per_voxel,
            max_voxels=self.max_voxels,
        )

        # Reduce each voxel's point stack to a single row: hit-count-weighted
        # mean of xyz+features, with the raw hit sum appended as its own
        # channel (log-compressed below). Matches prior_points.py:127-138.
        hits = voxels[:, :, -1:]
        weighted = (voxels[:, :, :-1] * hits).sum(axis=1)
        hit_sum = hits.sum(axis=1)
        out = np.concatenate([weighted / hit_sum, hit_sum], axis=-1)
        assert np.all(np.isfinite(out)), (
            "non-finite voxel features after hit-weighted reduction "
            "(zero hit sum or corrupt prior input)"
        )

        rng_xyz = pr[3:] - pr[:3]
        out[:, :3] = (out[:, :3] - pr[:3]) / rng_xyz
        assert out[:, -1:].min() > 0.0
        out[:, -1:] = np.log(out[:, -1:])

        if self.random_drop:
            keep_rate = 1 - rng.uniform(0, self.max_drop_rate)
            keep_idx = rng.choice(np.arange(len(out)), size=int(keep_rate * len(out)),
                                  replace=False)
            out = out[keep_idx]
            coords = coords[keep_idx]

        return {
            "prior_voxels": out.astype(np.float32),
            "prior_voxels_coords": coords.astype(np.int32),
        }


def pad_prior_voxels(samples: Sequence[Dict[str, np.ndarray]], pad_to: Optional[int] = None,
                     channels: int = 68) -> Dict[str, np.ndarray]:
    """VoxelizePriorPoints outputs of B samples -> the model's prior inputs
    (data/stage3_pipeline.py:375-396): prior_feats (B, V, C) f32,
    prior_coords (B, V, 3) int32 and prior_valid (B, V) bool, V = ``pad_to``
    (the voxelizer's max_voxels on the serving path) or the largest count;
    samples past V are cut."""
    counts = [len(s["prior_voxels"]) for s in samples]
    V = pad_to or max(max(counts), 1)
    C = samples[0]["prior_voxels"].shape[-1] if counts[0] else channels
    B = len(samples)
    feats = np.zeros((B, V, C), np.float32)
    coords = np.zeros((B, V, 3), np.int32)
    valid = np.zeros((B, V), bool)
    for b, s in enumerate(samples):
        n = min(len(s["prior_voxels"]), V)
        if n:
            feats[b, :n] = s["prior_voxels"][:n]
            coords[b, :n] = s["prior_voxels_coords"][:n]
            valid[b, :n] = True
    return {"prior_feats": feats, "prior_coords": coords, "prior_valid": valid}
