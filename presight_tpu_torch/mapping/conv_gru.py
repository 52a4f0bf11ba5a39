"""Streaming BEV memory: the ego-motion warp of the previous BEV and the
ConvGRU that fuses it with the current one, the port of
presight_tpu/mapping/conv_gru.py (reference online-mapping/plugin/models/
necks/gru.py:9-41 and StreamMapNet.update_bev_feature). BEVDet-Occ's
temporal align uses the warp too (occupancy/bevdet_occ.py:210-235).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv


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
    # inv_ex: linalg.inv's factorisation without its host read of the error code
    inv = torch.linalg.inv_ex(prev2curr.to(dt)).inverse
    prev_pts = torch.einsum("ij,hwj->hwi", inv, cur)
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


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis (epsilon 1e-6)."""

    EPS = 1e-6

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.EPS)


class ConvGRU(nn.Module):
    """gru.py:9-41: update and reset gates from 1x1 convs (no bias) over
    [h, x], the candidate from [r * h, x], then LayerNorm over the channels
    (flax's, epsilon 1e-6). h, x: (C, H, W)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.convz = Conv(2 * channels, channels, (1, 1), bias=False, device=device)
        self.convr = Conv(2 * channels, channels, (1, 1), bias=False, device=device)
        self.convq = Conv(2 * channels, channels, (1, 1), bias=False, device=device)
        self.LayerNorm_0 = LayerNorm(channels, device)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x])[None]
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = self.convq(torch.cat([r * h[None], x[None]], 1))
        out = (1 - z) * h[None] + z * q
        return self.LayerNorm_0(out[0].permute(1, 2, 0)).permute(2, 0, 1)
