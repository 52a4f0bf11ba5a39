"""bev_pool_v2: lift-splat pooling of depth-weighted image features into the
BEV voxel grid, the port of presight_tpu/occupancy/bev_pool.py.

Every frustum point adds ``depth[b,n,d,h,w] * feat[b,n,h,w,:]`` into voxel
``floor((coor - lb) / iv)``; points outside the grid are dropped. The JAX
package writes it as one segment_sum over all points with a dump row (an
XLA stand-in for the reference's bev_pool_v2 CUDA kernel,
occupancy/mmdet3d/ops/bev_pool_v2/src/bev_pool_cuda.cu). Here it is kernel
S1 (csrc/bev_pool.cu: a counting sort by voxel in its own passes, then the
reference's interval sum in point order) on CUDA tensors, and
:func:`bev_pool_v2_plain` (index_add_ of the materialised rows) on CPU
tensors or with ``plain=True``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import kernels


def _voxels(coor: torch.Tensor, lb, iv) -> torch.Tensor:
    lb = torch.as_tensor(lb, dtype=coor.dtype, device=coor.device)
    iv = torch.as_tensor(iv, dtype=coor.dtype, device=coor.device)
    return torch.floor((coor - lb) / iv).to(torch.int32)


def voxel_ranks(coor: torch.Tensor, grid_lower_bound, grid_interval,
                grid_size: Tuple[int, int, int]) -> torch.Tensor:
    """Flat (b, z, y, x) rank of each frustum point, B * Z * Y * X for a
    point outside the grid (the plain version's voxel arithmetic)."""
    B = coor.shape[0]
    gx, gy, gz = (int(g) for g in grid_size)
    vox = _voxels(coor, grid_lower_bound, grid_interval)
    inb = ((vox[..., 0] >= 0) & (vox[..., 0] < gx) & (vox[..., 1] >= 0) & (vox[..., 1] < gy)
           & (vox[..., 2] >= 0) & (vox[..., 2] < gz))
    b = torch.arange(B, dtype=torch.int32, device=coor.device).reshape(B, *[1] * (coor.dim() - 2))
    rank = ((b * gz + vox[..., 2]) * gy + vox[..., 1]) * gx + vox[..., 0]
    return torch.where(inb, rank, torch.full_like(rank, B * gz * gy * gx))


def bev_pool_v2_plain(depth, feat, coor, grid_lower_bound, grid_interval, grid_size):
    """Plain version of S1: index_add_ of the (B*N*D*H*W, C) rows of
    depth x feat into a flat (B*Z*Y*X + 1, C) buffer whose last row is the
    dump of out-of-range points."""
    B = depth.shape[0]
    C = feat.shape[-1]
    gx, gy, gz = (int(g) for g in grid_size)
    rank = voxel_ranks(coor, grid_lower_bound, grid_interval, grid_size).reshape(-1)
    weighted = (depth[..., None] * feat[:, :, None]).reshape(-1, C)
    out = torch.zeros((B * gz * gy * gx + 1, C), dtype=depth.dtype, device=depth.device)
    out.index_add_(0, rank.long(), weighted)
    return out[:-1].reshape(B, gz, gy, gx, C).permute(0, 4, 1, 2, 3).contiguous()


def bev_pool_v2(depth: torch.Tensor, feat: torch.Tensor, coor: torch.Tensor,
                grid_lower_bound: Sequence[float], grid_interval: Sequence[float],
                grid_size: Tuple[int, int, int], plain: bool = False) -> torch.Tensor:
    """Pool depth-weighted image features into the BEV voxel grid.

    depth (B, N, D, H, W) (softmaxed), feat (B, N, H, W, C), coor
    (B, N, D, H, W, 3) in ego coordinates; grid_size (X, Y, Z). Returns
    (B, C, Z, Y, X) f32. Wrapper of S1: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors or with ``plain=True``.
    """
    if plain or depth.device.type == "cpu":
        return bev_pool_v2_plain(depth, feat, coor, grid_lower_bound, grid_interval, grid_size)
    B, N, D, H, W = depth.shape
    C = feat.shape[-1]
    if feat.shape[:2] != (B, N) or feat.shape[2:4] != (H, W) or coor.shape != (B, N, D, H, W, 3):
        raise ValueError(f"bev_pool_v2: shapes depth {tuple(depth.shape)}, feat "
                         f"{tuple(feat.shape)}, coor {tuple(coor.shape)} do not agree")
    for t in (depth, feat, coor):
        if t.dtype != torch.float32:
            raise TypeError("bev_pool_v2: float32 depth, feat and coor expected")
    kernels.require_cuda("bev_pool_v2", depth, feat, coor)
    gx, gy, gz = (int(g) for g in grid_size)
    cells = B * gz * gy * gx
    n = depth.numel()
    if n >= 2**31 - 1 or cells >= 2**31 - 4096:
        raise ValueError("bev_pool_v2: more than 2^31 points or cells")
    lb = [float(v) for v in np.asarray(grid_lower_bound, np.float32)]
    iv = [float(v) for v in np.asarray(grid_interval, np.float32)]
    lib = kernels.lib()
    scratch = torch.empty(lib.bev_pool_scratch_ints(n, cells), dtype=torch.int32,
                          device=depth.device)
    out = torch.empty((B, C, gz, gy, gx), dtype=torch.float32, device=depth.device)
    code = lib.bev_pool_fwd(depth.data_ptr(), feat.data_ptr(), coor.data_ptr(), n, N * D * H * W,
                            D * H * W, H * W, C, B, *lb, *iv, gx, gy, gz, scratch.data_ptr(),
                            out.data_ptr(), kernels.stream())
    kernels.check("bev_pool_fwd", code)
    kernels.LAUNCHES["bev_pool_fwd"] += 1
    return out


def bev_pool_v2_reference(depth, feat, coor, grid_lower_bound, grid_interval,
                          grid_size) -> np.ndarray:
    """Numpy loop oracle of the reference kernel's semantics, for tests."""
    depth = np.asarray(depth)
    feat = np.asarray(feat)
    coor = np.asarray(coor)
    B, N, D, H, W = depth.shape
    C = feat.shape[-1]
    gx, gy, gz = (int(g) for g in grid_size)
    out = np.zeros((B, C, gz, gy, gx), np.float64)
    vox = np.floor(
        (coor - np.asarray(grid_lower_bound)) / np.asarray(grid_interval)
    ).astype(np.int64)
    for b in range(B):
        for n in range(N):
            for d in range(D):
                for h in range(H):
                    for w in range(W):
                        x, y, z = vox[b, n, d, h, w]
                        if 0 <= x < gx and 0 <= y < gy and 0 <= z < gz:
                            out[b, :, z, y, x] += depth[b, n, d, h, w] * feat[b, n, h, w]
    return out.astype(np.float32)
