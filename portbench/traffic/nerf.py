"""Inputs of the city-tile NeRF cells, made from the seed on the card.

The scene is a copy of ``scene_at_camera_height`` of the repository's
chip_smoke.py (its verdict: a sound traffic maker): expert centroids on a
grid 10 units (200 m at pose scale 0.05) apart, each with a +-10 x +-10 x
+-2.5 AABB, raised to the cameras' height so that the rays' samples fall
inside the experts' boxes; six nuScenes-like 1600x900 cameras 1.5 m above
the ground looking round the horizon. Each sample of the rig moves the
cameras ``ego_step`` units along x, as a car drives through the tile; or,
``at_centroids``, sample t of the rig stands beside expert t's centroid
(mod the experts; a further ``ego_step`` along x each round), as the
source's chunks draw images balanced over the k-means clusters of the
drive's poses, which are the experts.

The training set is ``samples`` x 6 images of rgb in [0, 1), a sky mask
over the top quarter of each image, no depth (-1), and float16 DINO-like
features in [0, 1), drawn with a CUDA generator seeded by the seed.
Weights come from ``reference.nerf.param_shapes``: each leaf from its own
CUDA generator, seeded by (seed, leaf), so that one leaf can be made again
alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from reference import nerf as ref

FX, FY, CX, CY = 1266.0, 1266.0, 800.0, 450.0  # at 1600x900


def scene(num_experts: int, samples: int, ego_step: float, at_centroids: bool = False):
    """(aabbs (E, 2, 3), centroids (E, 3), c2w (samples * 6, 3, 4)), float32 numpy."""
    side = int(np.ceil(np.sqrt(num_experts)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    cent = np.stack([xs.ravel(), ys.ravel(), np.zeros(side * side)], -1)[:num_experts]
    cent = ((cent - (side - 1) / 2.0) * 10.0).astype(np.float32)
    half = np.array([10.0, 10.0, 2.5], np.float32)
    c2w = np.zeros((samples * 6, 3, 4), np.float32)
    for t in range(samples):
        if at_centroids:
            x, y = cent[t % num_experts, :2] + [1.0 + ego_step * (t // num_experts), 2.0]
        else:
            x, y = 1.0 + ego_step * t, 2.0
        for i in range(6):
            yaw = 2 * np.pi * i / 6
            fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            up = np.array([0.0, 0.0, 1.0])
            j = t * 6 + i
            c2w[j, :, 0], c2w[j, :, 1], c2w[j, :, 2] = np.cross(fwd, up), up, -fwd
            c2w[j, :, 3] = [x, y, 0.075]
    cent = cent + np.array([0.0, 0.0, 0.075], np.float32)  # at the cameras' height
    aabbs = np.stack([np.stack([c - half, c + half]) for c in cent]).astype(np.float32)
    return aabbs, cent, c2w


def cameras(c2w: np.ndarray, H: int, W: int, device) -> Dict[str, torch.Tensor]:
    """Pinhole intrinsics of a 1600x900 camera scaled to H x W, one video."""
    n, s = len(c2w), H / 900.0
    t = lambda v: torch.full((n,), v * s, dtype=torch.float32, device=device)  # noqa: E731
    return {"c2w": torch.as_tensor(c2w, device=device), "fx": t(FX), "fy": t(FY),
            "cx": t(CX), "cy": t(CY),
            "video_ids": torch.zeros(n, dtype=torch.int32, device=device)}


def images(seed: int, n: int, H: int, W: int, feature_dim: int, device) -> Dict[str, torch.Tensor]:
    """rgb (n, H, W, 3) f32, sky and depth (n, H, W) f32, features (n, H, W, D) f16."""
    g = torch.Generator(device=device).manual_seed(seed)
    sky = torch.zeros((n, H, W), dtype=torch.float32, device=device)
    sky[:, :H // 4] = 1.0
    return {"rgb": torch.rand((n, H, W, 3), generator=g, device=device),
            "sky": sky,
            "depth": torch.full((n, H, W), -1.0, device=device),
            "features": torch.rand((n, H, W, feature_dim), generator=g, device=device,
                                   dtype=torch.float16)}


def leaf(seed: int, index: int, spec: Tuple, device, table_scale: float = 1e-4) -> torch.Tensor:
    """Leaf ``index`` of the tree: 'table' U(-table_scale, table_scale) (the
    config's init, 1e-4, by default), 'linear' U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), 'normal' N(0, 1)."""
    kind, shape, fan_in = spec
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % (1 << 63))
    if kind == "normal":
        return torch.randn(shape, generator=g, device=device)
    bound = table_scale if kind == "table" else 1.0 / float(np.sqrt(fan_in))
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def weights(seed: int, shapes: Dict, aabbs, centroids, device, table_scale: float = 1e-4,
            density_bias: Optional[float] = None) -> Dict:
    """The whole tree: trainable leaves from the seed, buffers from the scene.
    ``table_scale`` and ``density_bias`` (every density logit's output bias,
    the main field's and the proposal fields') shape a field with structure
    in space, as a trained tile's."""
    order = {path: i for i, (path, _) in enumerate(ref.leaf_paths(shapes))}
    a = torch.as_tensor(aabbs, device=device)
    c = torch.as_tensor(centroids, device=device)

    def make(path, spec):
        if spec is None:
            return (a if path.endswith("aabbs") else c).clone()
        return leaf(seed, order[path], spec, device, table_scale)

    tree = ref.build_tree(shapes, make)
    if density_bias is not None:
        tree["field"]["base_mlp"][-1][1][:, 0] = density_bias
        for prop in tree["props"]:
            prop["mlp"][-1][1].fill_(density_bias)
    return tree
