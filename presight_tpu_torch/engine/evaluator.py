"""Whole-image evaluation (presight_tpu/engine/evaluator.py): rendering in
fixed-size ray chunks (ImageRenderer; the last chunk is padded to the full
chunk size, as in JAX, so every chunk sees the same shapes and the
batch-global clip of the expected depth matches the reference), and the
PSNR / SSIM / LPIPS and depth-RMSE metrics of rendered images."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import NerfactoNuscMSConfig
from ..data.cameras import CameraParams, generate_rays
from ..models.nerfacto_ms import NerfactoNuscMS
from ..utils import metrics as M

RENDER_KEYS = ("rgb", "accumulation", "depth", "expected_depth", "semantics")


class ImageRenderer:
    def __init__(self, config: NerfactoNuscMSConfig, chunk: Optional[int] = None):
        self.config = config
        self.chunk = chunk or config.eval_num_rays_per_chunk

    @torch.no_grad()
    def render_rays(self, model: NerfactoNuscMS, cameras: CameraParams, ray_index: np.ndarray,
                    prop_grid: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """Eval-mode outputs (RENDER_KEYS) of the rays ``ray_index`` (N, 3)
        int32 rows of (camera, row, col), flat on the host; ``cameras`` and
        the model live on the device the render runs on."""
        if prop_grid is None:
            prop_grid = model.make_prop_grid()
        device = cameras.c2w.device
        outs: Dict[str, List[np.ndarray]] = {}
        for s in range(0, len(ray_index), self.chunk):
            idx = ray_index[s:s + self.chunk]
            idx_p = np.pad(idx, ((0, self.chunk - len(idx)), (0, 0)))
            bundle = generate_rays(cameras, torch.from_numpy(idx_p).to(device))
            res = model(bundle, train=False, prop_grid=prop_grid)
            for k in RENDER_KEYS:
                if k in res:
                    outs.setdefault(k, []).append(res[k][: len(idx)].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def render(self, model: NerfactoNuscMS, cameras: CameraParams, camera_idx: int,
               H: int, W: int, prop_grid: Optional[torch.Tensor] = None
               ) -> Dict[str, np.ndarray]:
        """Render camera ``camera_idx`` at H x W."""
        rows, cols = np.mgrid[0:H, 0:W]
        ray_index = np.stack(
            [np.full(H * W, camera_idx, np.int32),
             rows.reshape(-1).astype(np.int32),
             cols.reshape(-1).astype(np.int32)], axis=-1)
        flat = self.render_rays(model, cameras, ray_index, prop_grid)
        return {k: v.reshape(H, W, -1) if v.ndim > 1 else v.reshape(H, W)
                for k, v in flat.items()}


def image_metrics(pred_rgb: np.ndarray, gt_rgb: np.ndarray, with_lpips: bool = True,
                  device=None) -> Dict[str, float]:
    """PSNR and SSIM, and LPIPS (on ``device``, the CUDA card unless the
    caller passes another) when asked and available."""
    out = {"psnr": M.psnr(pred_rgb, gt_rgb), "ssim": M.ssim(pred_rgb, gt_rgb)}
    if with_lpips:
        fn = M.lpips_fn(device)
        if fn is not None:
            out["lpips"] = fn(pred_rgb.astype(np.float32), gt_rgb.astype(np.float32))
    return out


def evaluate_images(model: NerfactoNuscMS, config: NerfactoNuscMSConfig, cameras: CameraParams,
                    items, indices=None, with_lpips: bool = True,
                    with_depth: bool = False) -> Dict[str, float]:
    """Mean metrics over eval images; ``cameras`` is their table, on the
    device the model lives on. ``with_depth`` adds depth_rmse (meters)
    over pixels with valid ground-truth depth (> 0 and under the config's
    depth upper bound) against the rendered expected depth rescaled out of
    pose-normalised units."""
    renderer = ImageRenderer(config)
    prop_grid = model.make_prop_grid()  # depends only on the weights: once
    if indices is None:
        indices = range(len(items))
    all_metrics: List[Dict[str, float]] = []
    upper = (config.lidar_depth_upperbound if config.use_lidar_loss
             else config.monodepth_depth_upperbound)
    for i in indices:
        item = items[i]
        outputs = renderer.render(model, cameras, i, item.H, item.W, prop_grid=prop_grid)
        m = image_metrics(outputs["rgb"], item.load_image(), with_lpips,
                          device=cameras.c2w.device)
        if with_depth and item.depth_path is not None:
            gt_d = item.load_depth()
            pred_d = outputs["expected_depth"].reshape(gt_d.shape) / config.pose_scale_factor
            mask = (gt_d > 0) & (gt_d < upper)
            if mask.any():
                m["depth_rmse"] = float(np.sqrt(np.mean((pred_d[mask] - gt_d[mask]) ** 2)))
        all_metrics.append(m)
    keys = {k for m in all_metrics for k in m}
    return {k: float(np.mean([m[k] for m in all_metrics if k in m])) for k in keys}
