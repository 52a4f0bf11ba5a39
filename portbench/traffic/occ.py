"""Inputs of the BEVDet-Occ cells, made from the seed.

The rig is a copy of ``occ_rig`` of the repository's chip_smoke.py (its
verdict: a sound traffic maker): six cameras at yaw 0, +-55, +-110 and 180
degrees, optical axes horizontal, 1.5 m above the ground, nuScenes
CAM_FRONT intrinsics and the reference's image pipeline for 1600x900
(resize by 0.44, crop the top 140 rows: 256x704), and the ego motion
between frames (1 m forward, 0.05 m left, 2 degrees of yaw).

Each frame's images are normalised-like values (standard normal), its
priors ``max_voxels`` distinct voxels of the prior grid ((z, y, x) < (Z,
Y, X)) with 68 channels, as the prior contract pads them; a training
frame adds labels of the 18 classes over the occupancy grid and a camera
mask that keeps about half of the voxels. Everything is drawn with a
generator seeded by (seed, frame).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

INTRINSICS = ((1266.417, 0.0, 816.267), (0.0, 1266.417, 491.507), (0.0, 0.0, 1.0))
RESIZE, CROP_TOP = 0.44, 140.0
YAWS_DEG = (0.0, -55.0, 55.0, -110.0, 110.0, 180.0)
EGO_MOTION = (1.0, 0.05, 2.0)  # metres forward, left, degrees of yaw between frames


def rig(batch: int, device) -> Dict[str, torch.Tensor]:
    """The geometry of ``batch`` frames: sensor2ego, cam2imgs, post_rots,
    post_trans, bda, and the ego motion's k2s_sensor and prev2curr."""
    n = len(YAWS_DEG)
    cam_to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    s2e = np.tile(np.eye(4), (batch, n, 1, 1))
    for i, yaw in enumerate(np.radians(YAWS_DEG)):
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        s2e[:, i, :3, :3] = rz @ cam_to_ego
        s2e[:, i, :3, 3] = [0.8 * np.cos(yaw) + 0.5, 0.5 * np.sin(yaw), 1.5]
    fwd, left, yaw = EGO_MOTION
    a = np.radians(yaw)
    curr_in_prev = np.eye(4)
    curr_in_prev[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    curr_in_prev[:2, 3] = [fwd, left]
    k2s = np.stack([np.linalg.inv(s2e[0, i]) @ curr_in_prev @ s2e[0, i] for i in range(n)])
    prev_to_curr = np.linalg.inv(curr_in_prev)
    p2c = np.eye(3)
    p2c[:2, :2], p2c[:2, 2] = prev_to_curr[:2, :2], prev_to_curr[:2, 3]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return {"sensor2ego": t(s2e), "cam2imgs": t(np.tile(np.asarray(INTRINSICS), (batch, n, 1, 1))),
            "post_rots": t(np.tile(np.diag([RESIZE, RESIZE, 1.0]), (batch, n, 1, 1))),
            "post_trans": t(np.tile([0.0, -CROP_TOP, 0.0], (batch, n, 1))),
            "bda": t(np.tile(np.eye(4), (batch, 1, 1))),
            "k2s_sensor": t(np.tile(k2s[None], (batch, 1, 1, 1))),
            "prev2curr": t(np.tile(p2c[None], (batch, 1, 1)))}


def frames(seed: int, first: int, count: int, model: Dict, train: bool,
           device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Frames first..first+count-1 of the seed's stream, each with a batch
    dimension of 1: imgs (1, 6, 3, H, W), priors, and with ``train`` the
    labels (1, X, Y, Z) and camera mask."""
    H, W = model["input_size"]
    gx, gy, gz = grid_size(model)
    pz, py, px = prior_resolution(model)[::-1]
    V = model["prior_max_voxels"]
    out = []
    for f in range(first, first + count):
        g = torch.Generator(device="cpu").manual_seed((seed * 7919 + f) % (1 << 63))
        frame = {"imgs": torch.randn((1, 6, 3, H, W), generator=g)}
        cells = torch.randperm(pz * py * px, generator=g)[:V]
        coords = torch.stack([cells // (py * px), (cells // px) % py, cells % px], -1)
        frame["prior_feats"] = torch.randn((1, V, model["prior_in_channels"]), generator=g)
        frame["prior_coords"] = coords.to(torch.int32)[None]
        frame["prior_valid"] = torch.ones((1, V), dtype=torch.bool)
        if train:
            frame["voxel_semantics"] = torch.randint(0, model["num_classes"], (1, gx, gy, gz),
                                                     generator=g, dtype=torch.int32)
            frame["mask_camera"] = (torch.rand((1, gx, gy, gz), generator=g) < 0.5).to(
                torch.float32)
        out.append({k: v.to(device) for k, v in frame.items()})
    return out


def stack(items: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Frames of batch 1 as one batch."""
    return {k: torch.cat([it[k] for it in items]) for k in items[0]}


def grid_size(model: Dict):
    g = model["grid_config"]
    return tuple(int(round((g[k][1] - g[k][0]) / g[k][2])) for k in ("x", "y", "z"))


def prior_resolution(model: Dict):
    """(X, Y, Z) cells of the prior grid."""
    pr = np.asarray(model["prior_pc_range"], np.float64)
    vs = np.asarray(model["prior_voxel_size"], np.float64)
    return tuple(int(v) for v in np.ceil((pr[3:] - pr[:3]) / vs))
