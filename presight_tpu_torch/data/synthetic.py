"""Synthetic nuScenes-schema fixture generator
(presight_tpu/data/synthetic.py): the same pkl, json and npz content as the
JAX package's ``generate_scene``, its JPEGs written by the port's codec
(native/jpeg.py), byte for byte what Pillow's ``Image.save`` writes.

The on-disk layout is the one the dataparser consumes: per-scene
``PreSight/{scene}.pkl`` lists of sample_data dicts, per-image
segmentation / depth / DINO npz files and jpgs, a
``{location}_centroids.json`` and ``dino_to_rgb.pkl``.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import List

import numpy as np

from ..native import jpeg
from .constants import SKY_CLASS_ID


def generate_scene(
    root: Path,
    location: str = "synthetic-city",
    scene_names: List[str] = ("scene-0001", "scene-0002"),
    num_frames: int = 6,
    height: int = 45,
    width: int = 80,
    feature_dim: int = 64,
    seed: int = 0,
    texture_detail: float = 0.0,
) -> Path:
    """Create a synthetic two-scene 'city' with 6 cameras per frame.

    ``texture_detail`` > 0 superimposes high-frequency pixel-keyed texture
    on the smooth gradients: every extra octave of image detail demands
    fine-level hash capacity."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / "PreSight").mkdir(parents=True, exist_ok=True)
    (root / "samples").mkdir(exist_ok=True)
    (root / "segmentation").mkdir(exist_ok=True)
    (root / "lidar_depth").mkdir(exist_ok=True)
    (root / "dino_features").mkdir(exist_ok=True)
    (root / "centroids").mkdir(exist_ok=True)

    cam_names = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
                 "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]
    # Camera yaw offsets around the ego vehicle.
    yaws = {"CAM_FRONT": 0.0, "CAM_FRONT_LEFT": 0.9, "CAM_FRONT_RIGHT": -0.9,
            "CAM_BACK": np.pi, "CAM_BACK_LEFT": np.pi - 0.9, "CAM_BACK_RIGHT": np.pi + 0.9}

    intrinsic = np.array(
        [[width * 0.9, 0, width / 2], [0, width * 0.9, height / 2], [0, 0, 1]],
        np.float64,
    )

    ts = 0
    for si, scene in enumerate(scene_names):
        sample_data = []
        for f in range(num_frames):
            # Ego drives along +x (scene 0) or +y (scene 1), world offset per scene.
            t = f * 8.0
            if si % 2 == 0:
                ego_xy = np.array([t, si * 120.0])
            else:
                ego_xy = np.array([si * 120.0, t])
            ego2global = np.eye(4)
            ego2global[:2, 3] = ego_xy
            ego2global[2, 3] = 1.5

            for cam in cam_names:
                yaw = yaws[cam]
                # cam2ego: camera at small offset, looking out at `yaw`,
                # OpenCV-style axes (x right, y down, z forward) relative to
                # ego (x forward, y left, z up).
                cy_, sy_ = np.cos(yaw), np.sin(yaw)
                fwd = np.array([cy_, sy_, 0.0])  # camera z (view dir) in ego frame
                right = np.array([sy_, -cy_, 0.0])  # camera x
                down = np.array([0.0, 0.0, -1.0])  # camera y
                cam2ego = np.eye(4)
                cam2ego[:3, 0] = right
                cam2ego[:3, 1] = down
                cam2ego[:3, 2] = fwd
                cam2ego[:3, 3] = fwd * 1.0  # 1 m out from ego center

                tag = f"{scene}_{cam}_{f:03d}"
                img_path = root / "samples" / f"{tag}.jpg"
                seg_path = root / "segmentation" / f"{tag}.npz"
                depth_path = root / "lidar_depth" / f"{tag}.npz"
                dino_path = root / "dino_features" / f"{tag}.npz"

                # Image: smooth gradient keyed by frame/camera (fit-able).
                yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
                img = np.stack([
                    0.5 + 0.4 * np.sin(xx / width * 3 + yaw),
                    0.5 + 0.4 * np.cos(yy / height * 2 + f * 0.3),
                    0.4 + 0.3 * np.sin((xx + yy) / (width + height) * 4 + si),
                ], axis=-1)
                if texture_detail > 0:
                    hf = (np.sin(xx * 0.9 + yaw * 5 + f * 2.1)
                          * np.cos(yy * 0.7 + si * 3)
                          + 0.5 * np.sin(xx * 2.3 - yy * 1.7 + f))
                    img += texture_detail * 0.18 * hf[..., None]
                jpeg.save(img_path, (np.clip(img, 0, 1) * 255).astype(np.uint8))

                # Segmentation: sky at top 1/4, a 'car' blob, road elsewhere.
                seg = np.zeros((height, width), np.uint8)  # road
                seg[: height // 4] = SKY_CLASS_ID
                seg[height // 2 : height // 2 + 5, width // 2 : width // 2 + 8] = 13  # car
                np.savez_compressed(seg_path, seg)

                # Depth: plausible ground-plane-ish ramp, -1 in sky.
                depth = 5.0 + 40.0 * (yy / height)
                depth[: height // 4] = -1.0
                np.savez_compressed(depth_path, depth.astype(np.float32))

                # DINO features: low-rank smooth field, f16.
                basis = rng.randn(4, feature_dim).astype(np.float32) * 0.2 + 0.5
                coefs = np.stack([
                    np.sin(xx / width * 2), np.cos(yy / height * 2),
                    np.full_like(xx, si), np.full_like(xx, np.sin(yaw)),
                ], axis=-1)
                feats = np.clip(coefs @ basis * 0.25 + 0.4, 0, 1).astype(np.float16)
                np.savez_compressed(dino_path, feats)

                sample_data.append(dict(
                    channel=cam,
                    filename=str(img_path),
                    segmentation_filename=str(seg_path),
                    lidar_depth_filename=str(depth_path),
                    dino_filename=str(dino_path),
                    ego2global=ego2global,
                    cam2ego=cam2ego,
                    cam_intrinsic=intrinsic,
                    height=height,
                    width=width,
                    timestamp=ts,
                    is_key_frame=(f % 2 == 0),
                    scene_name=scene,
                ))
                ts += 1

        with open(root / "PreSight" / f"{scene}.pkl", "wb") as fh:
            pickle.dump(sample_data, fh)

    with open(root / "centroids" / f"{location}_centroids.json", "w") as fh:
        json.dump({"0": list(scene_names)}, fh)

    # dino_to_rgb: feature -> RGB PCA projection (colormaps.py:212-234 schema).
    red = rng.randn(feature_dim, 3).astype(np.float32) * 0.3
    with open(root / "dino_features" / "dino_to_rgb.pkl", "wb") as fh:
        pickle.dump({
            "reduction_matrix": red,
            "rgb_min": np.full(3, -1.0, np.float32),
            "rgb_max": np.full(3, 1.0, np.float32),
            "mean": np.full(feature_dim, 0.4, np.float32),
        }, fh)

    return root
