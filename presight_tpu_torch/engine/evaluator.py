"""Whole-image rendering in fixed-size ray chunks
(presight_tpu/engine/evaluator.py ImageRenderer). The last chunk is padded
to the full chunk size, as in JAX, so every chunk sees the same shapes and
the batch-global clip of the expected depth matches the reference."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import NerfactoNuscMSConfig
from ..data.cameras import CameraParams, generate_rays
from ..models.nerfacto_ms import NerfactoNuscMS

RENDER_KEYS = ("rgb", "accumulation", "depth", "expected_depth", "semantics")


class ImageRenderer:
    def __init__(self, config: NerfactoNuscMSConfig, chunk: Optional[int] = None):
        self.config = config
        self.chunk = chunk or config.eval_num_rays_per_chunk

    @torch.no_grad()
    def render(self, model: NerfactoNuscMS, cameras: CameraParams, camera_idx: int,
               H: int, W: int, prop_grid: Optional[torch.Tensor] = None
               ) -> Dict[str, np.ndarray]:
        """Render camera ``camera_idx`` at H x W; ``cameras`` and the model
        live on the device the render runs on."""
        if prop_grid is None:
            prop_grid = model.make_prop_grid()
        device = cameras.c2w.device
        rows, cols = np.mgrid[0:H, 0:W]
        ray_index = np.stack(
            [np.full(H * W, camera_idx, np.int32),
             rows.reshape(-1).astype(np.int32),
             cols.reshape(-1).astype(np.int32)], axis=-1)
        outs: Dict[str, List[np.ndarray]] = {}
        for s in range(0, len(ray_index), self.chunk):
            idx = ray_index[s:s + self.chunk]
            idx_p = np.pad(idx, ((0, self.chunk - len(idx)), (0, 0)))
            bundle = generate_rays(cameras, torch.from_numpy(idx_p).to(device))
            res = model(bundle, train=False, prop_grid=prop_grid)
            for k in RENDER_KEYS:
                if k in res:
                    outs.setdefault(k, []).append(res[k][: len(idx)].cpu().numpy())
        stacked = {k: np.concatenate(v) for k, v in outs.items()}
        return {k: v.reshape(H, W, -1) if v.ndim > 1 else v.reshape(H, W)
                for k, v in stacked.items()}
