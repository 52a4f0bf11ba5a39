"""nuScenes multi-scene dataparser (presight_tpu/data/dataparser.py).

Reads ``{location}_centroids.json`` (tile id -> scene names) and the
per-scene ``PreSight/{scene}.pkl`` sample_data lists, builds the camera
poses (ego2global @ cam2ego, rotated to the nerfstudio frame), clusters
the camera positions into ``num_aabbs`` experts by k-means with an AABB
per cluster, normalises and scales the poses, and splits train and eval
images by linspace, all as the JAX package does.

The k-means is a numpy port of the algorithm scikit-learn 1.9 runs for
``KMeans(n_clusters, random_state=0, n_init="auto", max_iter=500)`` on
float32 points (sklearn/cluster/_kmeans.py, _k_means_lloyd.pyx,
_k_means_common.pyx): the points centred on their mean; k-means++ seeding
from ``RandomState(0)`` (the first centre by ``choice``, then
``2 + int(log k)`` local trials a centre, distances in float64 from
float32 inputs); Lloyd iterations in float32 until the labels stop
changing or the centre shift falls within ``mean(var(X, 0)) * 1e-4``; a
final assignment to the last centres. ``predict`` assigns the uncentred
points to the centres, as the JAX dataparser's ``km.predict`` does.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import DataParserConfig
from .cameras import CameraParams
from .image_metadata import ImageMetadata

# Rotate the nuScenes world frame so cameras land in an OpenCV-style frame.
_TRANSFORM1 = np.array(
    [[0, -1, 0, 0],
     [0, 0, -1, 0],
     [1, 0, 0, 0],
     [0, 0, 0, 1]], dtype=np.float32)
# Rotate back to z-up for the viewer/world.
_TRANSFORM2 = np.array(
    [[0, 0, 1, 0],
     [0, 1, 0, 0],
     [-1, 0, 0, 0],
     [0, 0, 0, 1]], dtype=np.float32)


def opencv_to_nerfstudio(pose: np.ndarray) -> np.ndarray:
    """ego/cam pose -> nerfstudio camera pose."""
    pose = _TRANSFORM1 @ pose
    pose = pose.copy()
    pose[0:3, 1:3] *= -1
    pose = pose[np.array([1, 0, 2, 3]), :]
    pose[2, :] *= -1
    pose = _TRANSFORM2 @ pose
    return pose


@dataclasses.dataclass
class DataparserOutputs:
    items: List[ImageMetadata]  # this split's items
    all_items: List[ImageMetadata]
    pose_scale_factor: float
    pose_transformation: np.ndarray  # (3,) world mean subtracted pre-scale
    centroids: np.ndarray  # (E, 3) scaled
    aabbs: np.ndarray  # (E, 2, 3) scaled
    predicted_labels: Optional[np.ndarray]  # (num_images,) k-means tile per image
    dino_to_rgb: Optional[Dict]
    num_videos: int


# ---------------------------------------------------------------- k-means

_CHUNK = 256  # _k_means_lloyd.pyx CHUNK_SIZE


def _sq_distances_upcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sklearn's _euclidean_distances(a, b, squared=True) for float32 inputs:
    float64 products and norms, stored as float32, clipped at 0."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    return np.maximum(d.astype(np.float32), np.float32(0))


def kmeans_plusplus(X: np.ndarray, k: int, rs: np.random.RandomState) -> np.ndarray:
    n = X.shape[0]
    weight = np.ones(n, X.dtype)
    centers = np.empty((k, X.shape[1]), X.dtype)
    trials = 2 + int(np.log(k))
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = X[first]
    closest = _sq_distances_upcast(centers[0:1], X)
    pot = closest @ weight
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_distances_upcast(X[ids], X)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weight.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot = pots[best]
        closest = dist[best]
        centers[c] = X[ids[best]]
    return centers


def _assign(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest centre by ||c||^2 - 2 x.c in float32, the first on ties."""
    labels = np.empty(X.shape[0], np.int32)
    cn = np.einsum("ij,ij->i", centers, centers)
    for s in range(0, X.shape[0], _CHUNK):
        d = cn[None, :] + np.float32(-2.0) * (X[s:s + _CHUNK] @ centers.T)
        labels[s:s + _CHUNK] = np.argmin(d, axis=1)
    return labels


def _lloyd_step(X: np.ndarray, centers: np.ndarray):
    """One E and M step (lloyd_iter_chunked_dense): labels, new centres and
    each centre's shift, empty clusters relocated to the farthest points."""
    k, f = centers.shape
    labels = _assign(X, centers)
    new = np.zeros_like(centers)
    weight = np.zeros(k, X.dtype)
    np.add.at(new, labels, X)
    np.add.at(weight, labels, np.float32(1.0))
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        if dist.max() != 0:
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            for new_id, idx in zip(empty, far):
                old_id = labels[idx]
                new[old_id] -= X[idx]
                new[new_id] = X[idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    heaviest = int(np.argmax(weight))
    for j in range(k):
        if weight[j] > 0:
            new[j] *= np.float32(1.0) / weight[j]
        else:
            new[j] = new[heaviest]
    shift = np.sqrt(((new - centers) ** 2).sum(axis=1, dtype=X.dtype))
    return labels, new, shift


def kmeans(points: np.ndarray, k: int, seed: int = 0, max_iter: int = 500,
           tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray]:
    """(centres (k, D) float32, labels (N,) int64) as sklearn's KMeans fit
    and predict give them for float32 ``points``."""
    X = np.array(points, np.float32, order="C")
    if not 1 <= k <= X.shape[0]:
        raise ValueError(f"k-means of {X.shape[0]} points into {k} clusters")
    tol = np.mean(np.var(X, axis=0)) * tol
    mean = X.mean(axis=0)
    Xc = X - mean
    centers = kmeans_plusplus(Xc, k, np.random.RandomState(seed))
    labels_old = np.full(X.shape[0], -1, np.int32)
    strict = False
    for _ in range(max_iter):
        labels, centers_new, shift = _lloyd_step(Xc, centers)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(Xc, centers)
    centers = centers + mean
    return centers.astype(np.float32), _assign(X, centers).astype(np.int64)


def _kmeans_cluster(translations: np.ndarray, num_aabbs: int):
    """Deterministic k-means of the camera positions."""
    return kmeans(translations, num_aabbs, seed=0, max_iter=500)


def _cluster_aabbs(translations: np.ndarray, centroids: np.ndarray, labels: np.ndarray):
    """Per-cluster AABB from the 5% and 95% pose quantiles."""
    aabbs = []
    for i in range(centroids.shape[0]):
        p = translations[labels == i]
        hi = np.quantile(p, 0.95, axis=0)
        lo = np.quantile(p, 0.05, axis=0)
        aabb = np.array(
            [[lo[0] - 15, lo[1] - 15, lo[2] - 5],
             [hi[0] + 15, hi[1] + 15, hi[2] + 15]], dtype=np.float32)
        aabbs.append(aabb)
    return np.stack(aabbs)


def parse(config: DataParserConfig, split: str = "train") -> DataparserOutputs:
    data_dir = str(config.data_dir)

    if config.scene_names is not None:
        scene_names = list(config.scene_names)
    else:
        cdir = config.centroids_dir or Path(data_dir) / "centroids"
        with open(os.path.join(str(cdir), f"{config.location}_centroids.json")) as f:
            scene_names = json.load(f)[config.centroid_name]

    sample_data_list = []
    for scene_name in scene_names:
        with open(os.path.join(data_dir, "PreSight", f"{scene_name}.pkl"), "rb") as f:
            sample_data_list.extend(pickle.load(f))
    sample_data_list.sort(key=lambda x: x["timestamp"])

    dino_to_rgb = None
    for dname in ("dino_features", "dino_features_fp16"):
        p = os.path.join(data_dir, dname, "dino_to_rgb.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                dino_to_rgb = pickle.load(f)
            break

    cameras = [c if c.startswith("CAM_") else "CAM_" + c for c in config.cameras]

    all_items: List[ImageMetadata] = []
    for sd in sample_data_list:
        if sd["channel"] not in cameras:
            continue
        pose = np.asarray(sd["ego2global"], np.float32) @ np.asarray(sd["cam2ego"], np.float32)
        pose = opencv_to_nerfstudio(pose)

        depth_fpath = sd.get("lidar_depth_filename", None)
        if config.depth_type == "monodepth" and depth_fpath is not None:
            depth_fpath = depth_fpath.replace("lidar_depth", "monodepth")

        H = int(sd["height"] * config.image_downscale_factor)
        W = int(sd["width"] * config.image_downscale_factor)
        scale = np.array(
            [[W / sd["width"], 0, 0], [0, H / sd["height"], 0], [0, 0, 1]], np.float32
        )
        intrinsic = scale @ np.asarray(sd["cam_intrinsic"], np.float32)

        all_items.append(ImageMetadata(
            image_path=sd["filename"],
            c2w=pose,
            W=W,
            H=H,
            intrinsics=intrinsic,
            image_index=len(all_items),
            time=sd["timestamp"],
            video_id=scene_names.index(sd["scene_name"]),
            is_key_frame=bool(sd.get("is_key_frame", False)),
            mask_path=sd.get("mask_filename") if config.use_gt_masks else None,
            seg_path=sd.get("segmentation_filename"),
            depth_path=depth_fpath if config.depth_type != "none" else None,
            feature_path=sd.get("dino_filename"),
        ))

    poses = np.stack([it.c2w for it in all_items])  # (N, 4, 4)
    translations = poses[:, :3, 3]

    if split == "train":
        centroids, labels = _kmeans_cluster(translations, config.num_aabbs)
        aabbs = _cluster_aabbs(translations, centroids, labels)
    else:
        centroids = np.zeros((config.num_aabbs, 3), np.float32)
        aabbs = np.zeros((config.num_aabbs, 2, 3), np.float32)
        labels = None

    if config.pose_normalize:
        mean = translations.mean(axis=0)
    else:
        mean = np.zeros(3, np.float32)
    psf = config.pose_scale_factor
    poses[:, :3, 3] = (poses[:, :3, 3] - mean) * psf
    aabbs = (aabbs - mean) * psf
    centroids = (centroids - mean) * psf
    for i, it in enumerate(all_items):
        it.c2w = poses[i]

    # Linspace train/eval split over snapshots.
    n = len(all_items)
    n_train = math.ceil(n * config.train_split_fraction)
    i_train = np.linspace(0, n - 1, n_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(n), i_train)
    eval_set = set(i_eval.tolist())

    train_count, val_count = 0, 0
    for i, it in enumerate(all_items):
        if i in eval_set:
            it.is_val = True
            it.image_index = val_count
            val_count += 1
        else:
            it.is_val = False
            it.image_index = train_count
            train_count += 1

    if split == "train":
        idx = i_train
    elif split in ("val", "test"):
        idx = i_eval
    else:
        idx = np.arange(n)
    items = [all_items[i] for i in idx]

    return DataparserOutputs(
        items=items,
        all_items=all_items,
        pose_scale_factor=psf,
        pose_transformation=mean.astype(np.float32),
        centroids=centroids.astype(np.float32),
        aabbs=aabbs.astype(np.float32),
        predicted_labels=labels,
        dino_to_rgb=dino_to_rgb,
        num_videos=len(scene_names),
    )


def make_camera_params(items: List[ImageMetadata], device=None) -> CameraParams:
    """The camera table of this split's items, on ``device`` (the CUDA card
    unless the caller passes another)."""
    device = torch.device(device if device is not None else "cuda")
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return CameraParams(
        c2w=t(np.stack([it.c2w[:3, :4] for it in items]).astype(np.float32)),
        fx=t(np.array([it.intrinsics[0, 0] for it in items], np.float32)),
        fy=t(np.array([it.intrinsics[1, 1] for it in items], np.float32)),
        cx=t(np.array([it.intrinsics[0, 2] for it in items], np.float32)),
        cy=t(np.array([it.intrinsics[1, 2] for it in items], np.float32)),
        video_ids=t(np.array([it.video_id for it in items], np.int32)),
    )
