"""Voxel prior fusion, the port of presight_tpu/models/prior_fusion.py
(reference occupancy/mmdet3d/models/necks/prior_fusion_module.py):
PriorFusion3DVoxel for BEVDet-Occ (:133-245) and PriorFusion2D for online
mapping (:11-131), with their shared parts.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense


def formulate_voxels(prior_feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                     voxel_resolution: Tuple[int, int, int]) -> torch.Tensor:
    """Dense grid scatter (prior_fusion_module.py:114-131): (V, C) voxel
    features at (V, 3) int (z, y, x) coords into an (rx, ry, rz, C) grid,
    indexed [z, y, x] -- the reference's quirk, kept bit for bit: a voxel
    survives only where z < rx, y < ry and x < rz. Padded rows (valid
    False) are dropped: every row is copied, a dropped one into a spare row
    past the grid that is sliced off, so the scatter's size does not depend
    on the data and nothing is read back to the host."""
    rx, ry, rz = voxel_resolution
    N, C = rx * ry * rz, prior_feats.shape[-1]
    i0, i1, i2 = coords.long().unbind(-1)
    keep = valid & (i0 >= 0) & (i0 < rx) & (i1 >= 0) & (i1 < ry) & (i2 >= 0) & (i2 < rz)
    rows = torch.where(keep, (i0 * ry + i1) * rz + i2, N)
    grid = prior_feats.new_zeros((N + 1, C)).index_copy_(0, rows, prior_feats)
    return grid[:N].reshape(rx, ry, rz, C)


class VoxelFeatureExtractor(nn.Module):
    """Linear-ReLU(-Dropout) x2 (prior_fusion_module.py:32-39); dropout is
    off in eval mode."""

    def __init__(self, in_channels: int, hidden: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, hidden, device)
        self.Dense_1 = Dense(hidden, hidden, device)

    def forward(self, x):
        return F.relu(self.Dense_1(F.relu(self.Dense_0(x))))


class _ConvBNReLU(nn.Module):
    """k x k conv (SAME, or VALID for k = 1) + BN (+ ReLU), NCHW."""

    def __init__(self, in_channels: int, features: int, kernel: int, use_relu: bool = True,
                 device=None):
        super().__init__()
        self.use_relu = use_relu
        self.Conv_0 = Conv(in_channels, features, (kernel, kernel),
                           padding="SAME" if kernel > 1 else "VALID", device=device)
        self.BatchNorm_0 = BatchNorm(features, device)

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.use_relu else x


def voxel_resolution(pc_range: Sequence[float], voxel_size: Sequence[float]) -> Tuple[int, ...]:
    pr = np.asarray(pc_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    return tuple(int(v) for v in np.ceil((pr[3:] - pr[:3]) / vs))


def _resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") of an NCHW tensor: half-pixel
    centres, edge-normalised (align_corners=False), antialiased when it
    shrinks."""
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=shrink)


class PriorFusion3DVoxel(nn.Module):
    """(prior_fusion_module.py:133-245): the voxelized prior, through a
    per-voxel MLP and a dense (hidden * z, y, x) grid, 2D convs, a 2x2
    max-pool and a bilinear resize to the BEV's size, is concatenated with
    the BEV volume (bs, c, h, w, z) and fused back by a 1x1x1 conv + BN,
    with a residual ReLU."""

    def __init__(self, prior_pc_range: Sequence[float], prior_voxel_size: Sequence[float],
                 bev_channels: int, out_num_z: int, out_channels: int,
                 bev_hidden_channels: int = 256, prior_in_channels: int = 68,
                 prior_voxel_hidden_channels: int = 64, residual: bool = True, device=None):
        super().__init__()
        self.resolution = voxel_resolution(prior_pc_range, prior_voxel_size)
        self.out_num_z, self.residual = out_num_z, residual
        hidden = prior_voxel_hidden_channels
        self.VoxelFeatureExtractor_0 = VoxelFeatureExtractor(prior_in_channels, hidden, device)
        self._ConvBNReLU_0 = _ConvBNReLU(hidden * self.resolution[2], bev_hidden_channels, 1,
                                         device=device)
        self._ConvBNReLU_1 = _ConvBNReLU(bev_hidden_channels, bev_hidden_channels, 3,
                                         device=device)
        self.Conv_0 = Conv(bev_channels + bev_hidden_channels // out_num_z, out_channels,
                           (1, 1, 1), device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)

    def forward(self, bev_feats, prior_feats, prior_coords, prior_valid):
        """bev_feats (bs, c, h, w, z); prior_feats (bs, V, 68), prior_coords
        (bs, V, 3) int (z, y, x), prior_valid (bs, V) bool."""
        bs, _, bev_h, bev_w, bev_z = bev_feats.shape
        assert self.out_num_z == bev_z
        feats = self.VoxelFeatureExtractor_0(prior_feats)
        grids = torch.stack([formulate_voxels(feats[b], prior_coords[b], prior_valid[b],
                                              self.resolution) for b in range(bs)])
        vox = grids.permute(0, 4, 3, 2, 1)  # (bs, hidden, z, y, x)
        x = vox.reshape(bs, -1, vox.shape[3], vox.shape[4])
        x = self._ConvBNReLU_1(self._ConvBNReLU_0(x))
        x = F.max_pool2d(x, 2, 2)
        if tuple(x.shape[-2:]) != (bev_h, bev_w):
            x = _resize_bilinear(x, (bev_h, bev_w))
        x = x.reshape(bs, -1, self.out_num_z, bev_h, bev_w).permute(0, 1, 3, 4, 2)
        y = self.BatchNorm_0(self.Conv_0(torch.cat([bev_feats, x], dim=1)))
        return F.relu(y + bev_feats) if self.residual else F.relu(y)


class PriorFusion2D(nn.Module):
    """(prior_fusion_module.py:11-131): the voxelized prior, through a
    per-voxel MLP and a dense grid, max-pooled over z into
    ``num_pool_buckets`` buckets, flattened to (hidden * buckets, y, x),
    two conv-BN-ReLU blocks, a bilinear resize to the BEV's size, then
    concatenated with the BEV (bs, c, h, w) and fused by two more."""

    def __init__(self, prior_pc_range: Sequence[float], prior_voxel_size: Sequence[float],
                 bev_feats_channels: int = 256, voxel_channels: int = 68,
                 num_pool_buckets: int = 4, hidden_channels: int = 256, device=None):
        super().__init__()
        self.resolution = voxel_resolution(prior_pc_range, prior_voxel_size)
        num_prior_z = int((prior_pc_range[5] - prior_pc_range[2]) / prior_voxel_size[2])
        self.buckets, self.z_pooled = num_pool_buckets, num_prior_z // num_pool_buckets
        hidden, bev_c = hidden_channels, bev_feats_channels
        self.VoxelFeatureExtractor_0 = VoxelFeatureExtractor(voxel_channels, hidden, device)
        self._ConvBNReLU_0 = _ConvBNReLU(hidden * num_pool_buckets, hidden, 1, device=device)
        self._ConvBNReLU_1 = _ConvBNReLU(hidden, hidden, 3, device=device)
        self._ConvBNReLU_2 = _ConvBNReLU(bev_c + hidden, bev_c, 1, device=device)
        self._ConvBNReLU_3 = _ConvBNReLU(bev_c, bev_c, 3, device=device)

    def forward(self, bev_feats, prior_feats, prior_coords, prior_valid):
        """bev_feats (bs, c, h, w); prior_feats (bs, V, C), prior_coords
        (bs, V, 3) int (z, y, x), prior_valid (bs, V) bool."""
        bs, _, bev_h, bev_w = bev_feats.shape
        rx, ry, rz = self.resolution
        feats = self.VoxelFeatureExtractor_0(prior_feats)
        grids = torch.stack([formulate_voxels(feats[b], prior_coords[b], prior_valid[b],
                                              self.resolution) for b in range(bs)])
        # the JAX package's (bs, hidden, y, x, buckets, z_pooled) max, taken
        # before the transpose (a max is exact in any order)
        pooled = grids.reshape(bs, rx, ry, self.buckets, self.z_pooled, -1).amax(4)
        x = pooled.permute(0, 4, 3, 2, 1).reshape(bs, -1, ry, rx)  # (bs, hidden * buckets, y, x)
        x = self._ConvBNReLU_1(self._ConvBNReLU_0(x))
        if tuple(x.shape[-2:]) != (bev_h, bev_w):
            x = _resize_bilinear(x, (bev_h, bev_w))
        x = torch.cat([bev_feats, x], 1)
        return self._ConvBNReLU_3(self._ConvBNReLU_2(x))
