"""The whole per-pixel training set held on the device
(presight_tpu/data/device_store.py DeviceRayStore): each step's batch
values are gathered on the device by ``ray_index``, so only the index array
crosses from the host.

The store is built from numpy arrays of one image size: rgb (N_img, H, W, 3)
in [0, 1], sky (N_img, H, W) as 1.0 / 0.0, depth (N_img, H, W) and optional
features (N_img, H, W, D), kept in f16 on the device as the feature files
store them and handed out as f32. Image decoding and the disk dataset come
with the dataparser.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class DeviceRayStore:
    """Flat (N_img * H * W, C) per-pixel tensors, row
    ``(image_index * H + v) * W + u``."""

    def __init__(self, rgb: np.ndarray, sky: np.ndarray, depth: np.ndarray,
                 features: Optional[np.ndarray] = None, device=None):
        n, H, W, _ = rgb.shape
        if sky.shape != (n, H, W) or depth.shape != (n, H, W):
            raise ValueError("DeviceRayStore: rgb (N, H, W, 3), sky and depth (N, H, W) expected")
        self.device = torch.device(device if device is not None else "cuda")
        self.num_images, self.H, self.W = n, H, W

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        self.rgb = put(rgb.reshape(-1, 3), np.float32)
        self.sky = put(sky.reshape(-1), np.float32)
        self.depth = put(depth.reshape(-1), np.float32)
        self.features = (None if features is None
                         else put(features.reshape(n * H * W, -1), np.float16))

    def __len__(self) -> int:
        return self.num_images * self.H * self.W

    def ray_index(self, rows: np.ndarray) -> np.ndarray:
        """(image, v, u) int32 of flat rows."""
        rows = np.asarray(rows, np.int64)
        u = rows % self.W
        v = (rows // self.W) % self.H
        return np.stack([rows // (self.H * self.W), v, u], -1).astype(np.int32)

    def batch(self, ray_index: np.ndarray, with_features: bool = True) -> Dict[str, torch.Tensor]:
        """The batch of ``ray_index`` (R, 3): ray_index, rgb, sky, depth and,
        when asked and stored, f32 features, all on the device."""
        idx = torch.from_numpy(np.ascontiguousarray(ray_index, np.int32)).to(self.device)
        flat = (idx[:, 0].long() * self.H + idx[:, 1].long()) * self.W + idx[:, 2].long()
        out = {"ray_index": idx, "rgb": self.rgb[flat], "sky": self.sky[flat],
               "depth": self.depth[flat]}
        if with_features and self.features is not None:
            out["features"] = self.features[flat].float()
        return out
