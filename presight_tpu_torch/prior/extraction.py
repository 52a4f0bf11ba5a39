"""Prior extraction: served tile NeRF -> voxelised city-prior pickle
(presight_tpu/prior/extraction.py).

Per sampled camera: segmentation-masked pixels -> rays -> chunked depth
render (forward_depth) -> world hit points filtered by depth and height ->
mean density over the proposal rounds and the main field plus clipped
semantic features at the hits (point_queries) -> density threshold -> PCA
colours -> voxel downsample -> hit-quantile filter -> pickle {points f32,
features f16, colors f32, hits, origin f32} and an ASCII PLY preview. A
camera's hits stay on the model's device up to the colours; only the kept
points, their f16 features and colours cross to the host.

Chunks are padded to the same power-of-two multiples of 4096 as the JAX
version, so both see the same batches (the expected depth clips to its
batch's step range). Items are duck-typed: each needs ``H``, ``W``,
``seg_path`` and ``load_segmentation()``.
"""

from __future__ import annotations

import pickle
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.cameras import CameraParams, generate_rays
from ..models.nerfacto_ms import NerfactoNuscMS
from ..utils.colormaps import colormap_on, feature_colormap
from ..utils.profiler import count, span
from .voxelize import hit_quantile_filter, make_streaming_accumulator

CAMERAS_PER_FRAME = 6

# presight_tpu/data/constants.py: Cityscapes classes and the dynamic classes
# masked out of the prior.
CITYSCAPE_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]
DEFAULT_MASK_SEG_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)


def _pad_to(n: int, multiple: int) -> int:
    """Round n up to a power-of-two multiple of ``multiple``."""
    units = max(1, -(-n // multiple))
    return (1 << (units - 1).bit_length()) * multiple


def _nearest_resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-exact resize (F.interpolate mode='nearest-exact')."""
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr
    rows = np.clip(np.round((np.arange(h) + 0.5) * arr.shape[0] / h - 0.5), 0,
                   arr.shape[0] - 1).astype(np.int64)
    cols = np.clip(np.round((np.arange(w) + 0.5) * arr.shape[1] / w - 0.5), 0,
                   arr.shape[1] - 1).astype(np.int64)
    return arr[rows][:, cols]


def _settle(device: torch.device) -> None:
    """Wait for the card's queued work, so that the span it ends holds it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> numpy arrays; from the card through pinned memory, all
    copies queued before one wait."""
    if tensors[0].device.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in hosts]


@torch.no_grad()
def extract_frame_points(model: NerfactoNuscMS, cameras: CameraParams, camera_idx: int,
                         H: int, W: int, seg_valid: Optional[np.ndarray],
                         pose_scale_factor: float, colormap: Dict[str, torch.Tensor],
                         density_threshold: float = 1.0, chunk: int = 1 << 17,
                         max_depth: float = 50.0, min_depth: float = 0.5,
                         depth_type: str = "expected_depth",
                         prop_grid: Optional[torch.Tensor] = None,
                         z_bounds=(-3.0, 6.0)):
    """One camera -> (kept world points f32, features f16, colours f32,
    hits), or None when no pixel hits inside the depth and height bounds.
    Hits are the points inside those bounds; kept are those of density above
    ``density_threshold``. The hits stay on the model's device through the
    threshold and the colours (``feature_colormap`` of ``colormap``, made by
    ``colormap_on``); only the kept rows cross to the host. Each step keeps
    numpy's f32 bits: points are divided by the scale as a true division,
    features rounded once to f16 (nearest even)."""
    device = cameras.c2w.device
    if seg_valid is not None:
        rows, cols = np.nonzero(seg_valid)
    else:
        rows, cols = np.nonzero(np.ones((H, W), bool))
    n = len(rows)
    if n == 0:
        return None
    ray_index = np.stack(
        [np.full(n, camera_idx, np.int32), rows.astype(np.int32), cols.astype(np.int32)],
        axis=-1)
    # A device scalar: CUDA divides by a host scalar as a product with its
    # reciprocal, which can differ from numpy's quotient in the last bit.
    psf = torch.tensor(pose_scale_factor, dtype=torch.float32, device=device)

    hits = 0
    points_list, feat_list, color_list = [], [], []
    for s in range(0, n, chunk):
        with span("extract.render"):
            idx = ray_index[s:s + chunk]
            idx_p = np.pad(idx, ((0, _pad_to(len(idx), 4096) - len(idx)), (0, 0)))
            count("extract.rays", len(idx))
            count("extract.rays_padded", len(idx_p))
            bundle = generate_rays(cameras, torch.from_numpy(idx_p).to(device))
            outputs = model.forward_depth(bundle, prop_grid=prop_grid)
            _settle(device)
        with span("extract.select"):
            depth = outputs[depth_type][: len(idx)] / psf
            origins = bundle.origins[: len(idx)] / psf
            world = origins + bundle.directions[: len(idx)] * depth[:, None]
            sel = ((depth < max_depth) & (depth > min_depth)
                   & (world[:, 2] > z_bounds[0]) & (world[:, 2] < z_bounds[1]))
            world = world[sel]
            m = len(world)
            if m == 0:
                continue
            world_p = torch.nn.functional.pad(world, (0, 0, 0, _pad_to(m, 4096) - m))
        with span("extract.query"):
            count("extract.points", m)
            count("extract.points_padded", len(world_p))
            dens, feats = model.point_queries(world_p * pose_scale_factor, prop_grid)
            _settle(device)
        with span("extract.colors"):
            hits += m
            keep = torch.nonzero(dens[:m] > density_threshold).squeeze(1)
            feats16 = feats.index_select(0, keep).to(torch.float16)
            points_list.append(world.index_select(0, keep))
            feat_list.append(feats16)
            color_list.append(feature_colormap(feats16, colormap))

    if not points_list:
        return None
    with span("extract.colors"):
        kept = [torch.cat(rows) for rows in (points_list, feat_list, color_list)]
        return (*_to_host(kept), hits)


@torch.no_grad()
def extract_voxels(model: NerfactoNuscMS, items, cameras: CameraParams,
                   pose_scale_factor: float, origin: np.ndarray, dino_to_rgb: Dict,
                   output_dir: Path, frame_interval: int = 1,
                   camera_scaling_factor: float = 1.0, voxel_size: float = 0.4,
                   max_depth: float = 50.0, min_depth: float = 0.5,
                   hit_thr_ratio: float = 0.2, depth_type: str = "depth",
                   use_segmentation_mask: bool = True,
                   mask_seg_classes=DEFAULT_MASK_SEG_CLASSES,
                   density_threshold: float = 1.0,
                   z_bounds=(-3.0, 6.0)) -> Dict[str, np.ndarray]:
    """Full extraction. Each frame's points are thresholded and spilled to a
    temporary directory, then folded into the O(voxels) accumulator once
    the grid origin (min of all points - 1) is known."""
    with span("extract.frame"):
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        depth_key = {"depth": "depth", "expected_depth": "expected_depth"}[depth_type]
        config = model.config

        if camera_scaling_factor != 1.0:
            cameras = CameraParams(
                c2w=cameras.c2w,
                fx=cameras.fx * camera_scaling_factor,
                fy=cameras.fy * camera_scaling_factor,
                cx=cameras.cx * camera_scaling_factor,
                cy=cameras.cy * camera_scaling_factor,
                video_ids=cameras.video_ids,
            )
        mask_ids = np.array([CITYSCAPE_CLASSES.index(c) for c in mask_seg_classes], np.uint8)

        num_frames = len(items) // CAMERAS_PER_FRAME + 1
        camera_indices: List[int] = []
        for f in range(0, num_frames, frame_interval):
            camera_indices.extend(
                range(CAMERAS_PER_FRAME * f, min(CAMERAS_PER_FRAME * (f + 1), len(items))))

        feat_dim = config.semantic_dim
        prop_grid = model.make_prop_grid()
        colormap = colormap_on(dino_to_rgb, cameras.c2w.device)
        spill_frames: List[Path] = []
        pts_min: Optional[np.ndarray] = None
        n_before = n_after = 0
        with tempfile.TemporaryDirectory(prefix="presight_extract_") as spill_name:
            spill_dir = Path(spill_name)
            for ci in camera_indices:
                item = items[ci]
                H = int(item.H * camera_scaling_factor)
                W = int(item.W * camera_scaling_factor)
                seg_valid = None
                if use_segmentation_mask and item.seg_path is not None:
                    seg = item.load_segmentation()
                    if camera_scaling_factor != 1.0:
                        seg = _nearest_resize(seg, H, W)
                    seg_valid = ~np.isin(seg, mask_ids)
                result = extract_frame_points(
                    model, cameras, ci, H, W, seg_valid, pose_scale_factor, colormap,
                    density_threshold=density_threshold, max_depth=max_depth,
                    min_depth=min_depth, depth_type=depth_key, prop_grid=prop_grid,
                    z_bounds=z_bounds)
                if result is None:
                    continue
                pts_s, feats_s, colors_s, hits = result
                n_before += hits
                n_after += len(pts_s)
                if len(pts_s) == 0:
                    continue
                with span("extract.spill"):
                    fpath = spill_dir / f"frame_{len(spill_frames):06d}.npz"
                    np.savez(fpath, points=pts_s.astype(np.float32), colors=colors_s,
                             features=feats_s)
                    spill_frames.append(fpath)
                    m = pts_s.astype(np.float32).min(axis=0)
                    pts_min = m if pts_min is None else np.minimum(pts_min, m)

            print(f"num hit points before density thr: {n_before}")
            print(f"num hit points after density thr: {n_after}")
            with span("extract.fold"):
                min_bound = (pts_min - np.float32(1.0) if pts_min is not None
                             else np.zeros(3, np.float32))
                accum = make_streaming_accumulator(voxel_size, min_bound, feature_dim=feat_dim)
                for fpath in spill_frames:
                    with np.load(fpath) as z:
                        accum.add(z["points"].astype(np.float64), z["colors"], z["features"])
                voxels = accum.finalize()
        print(f"num voxels after downsample to {voxel_size}: {len(voxels['points'])}")
        with span("extract.write"):
            voxels = hit_quantile_filter(voxels, hit_thr_ratio)
            print(f"num voxels after hit thr: {len(voxels['points'])}")

            result = {
                "points": voxels["points"].astype(np.float32),
                "features": voxels["features"].astype(np.float16),
                "colors": voxels["colors"].astype(np.float32),
                "hits": voxels["hits"],
                "origin": np.asarray(origin, np.float32),
            }
            out_path = output_dir / "extracted_priors.pkl"
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
            print(f"result saved to {out_path}")
            write_ply(result["points"], result["colors"], output_dir / "priors_for_vis.ply")
        return result


def write_ply(points: np.ndarray, colors: np.ndarray, out_path: Path) -> None:
    """ASCII PLY preview; the header's 'uint8' type name matches the
    reference's own file."""
    c = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(out_path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uint8 red\nproperty uint8 green\nproperty uint8 blue\n"
            "end_header\n"
        )
        for i in range(len(points)):
            f.write(f"{points[i, 0]:.3f} {points[i, 1]:.3f} {points[i, 2]:.3f} "
                    f"{c[i, 0]} {c[i, 1]} {c[i, 2]}\n")
