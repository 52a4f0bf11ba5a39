"""Inputs of the online-mapping cell, made from the seed.

The rig is the occupancy cells' (``traffic.occ.rig``): six cameras at yaw
0, +-55, +-110 and 180 degrees, optical axes horizontal, 1.5 m above the
ground, nuScenes CAM_FRONT intrinsics, and the same ego motion between
frames (1 m forward, 0.05 m left, 2 degrees of yaw). The mapping pipeline
resizes each 1600x900 image to the model's 480x800 without a crop
(presight_tpu/data/stage3_pipeline.py:481-520), so ``lidar2img`` =
diag(800 / 1600, 480 / 900, 1, 1) @ [K 0; 0 1] @ ego2cam, in float64, then
float32.

Each frame's images are standard normal (normalised images) at 480x800,
and its priors ``prior_max_voxels`` distinct voxels of the prior grid
((z, y, x) < (Z, Y, X)) with 68 standard-normal channels, as the prior
contract pads them. Everything is drawn with a generator seeded by
(seed, frame).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from traffic import occ

SOURCE_SIZE = (900, 1600)  # nuScenes images, (H, W)


def rig(model: Dict, device) -> Dict[str, torch.Tensor]:
    """lidar2img (6, 4, 4) of the resized images, and the 2D ego motion
    prev2curr (3, 3) between two frames."""
    geo = occ.rig(1, "cpu")
    H, W = model["img_size"]
    scale = np.diag([W / SOURCE_SIZE[1], H / SOURCE_SIZE[0], 1.0, 1.0])
    viewpad = np.eye(4)
    viewpad[:3, :3] = np.asarray(occ.INTRINSICS, np.float64)
    s2e = geo["sensor2ego"][0].double().numpy()
    l2i = np.stack([scale @ viewpad @ np.linalg.inv(s2e[i]) for i in range(len(s2e))])
    return {"lidar2img": torch.as_tensor(l2i.astype(np.float32), device=device),
            "prev2curr": geo["prev2curr"][0].to(device)}


def prior_resolution(model: Dict):
    """(X, Y, Z) cells of the prior grid."""
    pr = np.asarray(model["prior_pc_range"], np.float64)
    vs = np.asarray(model["prior_voxel_size"], np.float64)
    return tuple(int(v) for v in np.ceil((pr[3:] - pr[:3]) / vs))


def frames(seed: int, first: int, count: int, model: Dict, device="cpu"
           ) -> List[Dict[str, torch.Tensor]]:
    """Frames first..first+count-1 of the seed's stream: imgs (6, 3, H, W),
    prior_feats (V, 68), prior_coords (V, 3) int32 (z, y, x), prior_valid
    (V,)."""
    H, W = model["img_size"]
    pz, py, px = prior_resolution(model)[::-1]
    V = model["prior_max_voxels"]
    out = []
    for f in range(first, first + count):
        g = torch.Generator(device="cpu").manual_seed((seed * 7919 + f) % (1 << 63))
        frame = {"imgs": torch.randn((6, 3, H, W), generator=g)}
        cells = torch.randperm(pz * py * px, generator=g)[:V]
        frame["prior_feats"] = torch.randn((V, model["prior_voxel_channels"]), generator=g)
        frame["prior_coords"] = torch.stack([cells // (py * px), (cells // px) % py, cells % px],
                                            -1).to(torch.int32)
        frame["prior_valid"] = torch.ones((V,), dtype=torch.bool)
        out.append({k: v.to(device) for k, v in frame.items()})
    return out
