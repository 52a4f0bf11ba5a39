"""Streaming BEV memory: the ego-motion warp of the previous BEV, the port
of ``warp_bev`` in presight_tpu/mapping/conv_gru.py (BEVDet-Occ's temporal
align uses it, occupancy/bevdet_occ.py:210-235). The ConvGRU fuse of the
same JAX module comes with the mapping port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def warp_bev(prev_bev: torch.Tensor, prev2curr: torch.Tensor,
             roi_size: Tuple[float, float]) -> torch.Tensor:
    """Resample the previous BEV feature into the current ego frame:
    half-pixel bilinear with zeros padding, the JAX function's four taps
    and weights.

    prev_bev: (C, H, W), x (roi width) along W, y along H, ego-centred.
    prev2curr: (3, 3) 2D transform from previous-frame to current-frame
    ego coordinates (metres).
    """
    C, H, W = prev_bev.shape
    rw, rh = roi_size
    dev, dt = prev_bev.device, prev_bev.dtype
    xs = (torch.arange(W, device=dev, dtype=dt) + 0.5) / W * rw - rw / 2
    ys = (torch.arange(H, device=dev, dtype=dt) + 0.5) / H * rh - rh / 2
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cur = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    prev_pts = torch.einsum("ij,hwj->hwi", torch.linalg.inv(prev2curr.to(dt)), cur)
    px = (prev_pts[..., 0] + rw / 2) / rw * W - 0.5
    py = (prev_pts[..., 1] + rh / 2) / rh * H - 0.5
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    flat = prev_bev.reshape(C, H * W)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        return flat[:, idx].reshape(C, H, W) * valid[None].to(dt)

    return (tap(y0, x0) * ((1 - wy) * (1 - wx))[None]
            + tap(y0, x0 + 1) * ((1 - wy) * wx)[None]
            + tap(y0 + 1, x0) * (wy * (1 - wx))[None]
            + tap(y0 + 1, x0 + 1) * (wy * wx)[None])
