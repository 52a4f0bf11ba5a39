"""bev_pool_v2: lift-splat pooling of depth-weighted image features into the
BEV voxel grid, the port of presight_tpu/occupancy/bev_pool.py.

Every frustum point adds ``depth[b,n,d,h,w] * feat[b,n,h,w,:]`` into voxel
``floor((coor - lb) / iv)``; points outside the grid are dropped. The JAX
package writes it as one segment_sum over all points with a dump row (an
XLA stand-in for the reference's bev_pool_v2 CUDA kernel,
occupancy/mmdet3d/ops/bev_pool_v2/src/bev_pool_cuda.cu). Here it is kernel
S1 (csrc/bev_pool.cu: a counting sort by voxel in its own passes, then the
reference's interval sum in point order) on CUDA tensors, and
:func:`bev_pool_v2_plain` (index_add_ of the materialised rows) where
``kernels.use_plain`` says so (CPU tensors).

Its gradient (the transpose of the segment sum is a gather) is kernel S1b
(csrc/bev_pool.cu ``bev_pool_bwd``), or :func:`bev_pool_v2_bwd_plain`
where the forward ran its plain version, through one autograd Function:
d depth[p] = sum_c feat[pix(p), c] * g[vox(p), c] and d feat[pix, c] =
sum_d depth[pix, d] * g[vox(pix, d), c], 0 for a point outside the grid.
``coor`` gets no gradient (in JAX the floor makes it zero).
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


def bev_pool_v2_bwd_plain(depth, feat, coor, g, grid_lower_bound, grid_interval, grid_size):
    """Plain version of S1b, written out (no autograd): g (B, C, Z, Y, X)
    -> (d depth (B, N, D, H, W), d feat (B, N, H, W, C)). Gathers g's rows by
    voxel rank from a (B*Z*Y*X + 1, C) buffer whose last row is a zero dump
    for the points outside the grid, then takes the two contractions."""
    B, N, D, H, W = depth.shape
    C = feat.shape[-1]
    rank = voxel_ranks(coor, grid_lower_bound, grid_interval, grid_size).reshape(-1)
    flat = torch.cat([g.permute(0, 2, 3, 4, 1).reshape(-1, C), g.new_zeros((1, C))])
    rows = flat.index_select(0, rank.long()).reshape(B, N, D, H, W, C)
    d_depth = (rows * feat[:, :, None]).sum(-1)
    d_feat = (depth[..., None] * rows).sum(2)
    return d_depth, d_feat


def _check_inputs(name, depth, feat, coor, grid_size):
    B, N, D, H, W = depth.shape
    if feat.shape[:2] != (B, N) or feat.shape[2:4] != (H, W) or coor.shape != (B, N, D, H, W, 3):
        raise ValueError(f"{name}: shapes depth {tuple(depth.shape)}, feat "
                         f"{tuple(feat.shape)}, coor {tuple(coor.shape)} do not agree")
    for t in (depth, feat, coor):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 depth, feat and coor expected")
    kernels.require_cuda(name, depth, feat, coor)
    gx, gy, gz = (int(g) for g in grid_size)
    cells = B * gz * gy * gx
    if depth.numel() >= 2**31 - 1 or cells >= 2**31 - 4096:
        raise ValueError(f"{name}: more than 2^31 points or cells")
    return cells


def _grid_args(grid_lower_bound, grid_interval):
    lb = [float(v) for v in np.asarray(grid_lower_bound, np.float32)]
    iv = [float(v) for v in np.asarray(grid_interval, np.float32)]
    return lb, iv


def bev_pool_fwd(depth, feat, coor, grid_lower_bound, grid_interval, grid_size) -> torch.Tensor:
    """S1 on CUDA tensors: (B, C, Z, Y, X) f32. Raises if it cannot launch."""
    cells = _check_inputs("bev_pool_v2", depth, feat, coor, grid_size)
    B, N, D, H, W = depth.shape
    C = feat.shape[-1]
    gx, gy, gz = (int(g) for g in grid_size)
    n = depth.numel()
    lb, iv = _grid_args(grid_lower_bound, grid_interval)
    scratch = torch.empty(kernels.lib().bev_pool_scratch_ints(n, cells), dtype=torch.int32,
                          device=depth.device)
    out = torch.empty((B, C, gz, gy, gx), dtype=torch.float32, device=depth.device)
    kernels.launch("bev_pool_fwd", depth.data_ptr(), feat.data_ptr(), coor.data_ptr(), n,
                   N * D * H * W, D * H * W, H * W, C, B, *lb, *iv, gx, gy, gz,
                   scratch.data_ptr(), out.data_ptr())
    return out


def bev_pool_bwd(depth, feat, coor, g, grid_lower_bound, grid_interval, grid_size):
    """S1b on CUDA tensors: g (B, C, Z, Y, X) contiguous -> (d depth, d feat),
    every element written. Raises if it cannot launch."""
    _check_inputs("bev_pool_v2 backward", depth, feat, coor, grid_size)
    B, N, D, H, W = depth.shape
    C = feat.shape[-1]
    gx, gy, gz = (int(v) for v in grid_size)
    if g.shape != (B, C, gz, gy, gx) or g.dtype != torch.float32:
        raise ValueError(f"bev_pool_v2 backward: g {tuple(g.shape)} {g.dtype}, expected "
                         f"{(B, C, gz, gy, gx)} float32")
    if C > 128:
        raise ValueError(f"bev_pool_v2 backward: C = {C} > 128, the most S1b takes")
    kernels.require_cuda("bev_pool_v2 backward", depth, g)
    lb, iv = _grid_args(grid_lower_bound, grid_interval)
    d_depth = torch.empty_like(depth)
    d_feat = torch.empty_like(feat)
    kernels.launch("bev_pool_bwd", depth.data_ptr(), feat.data_ptr(), coor.data_ptr(),
                   g.data_ptr(), B, N, D, H * W, C, *lb, *iv, gx, gy, gz, d_depth.data_ptr(),
                   d_feat.data_ptr())
    return d_depth, d_feat


class _BevPool(torch.autograd.Function):
    """S1 forward, S1b backward (their plain versions where
    ``kernels.use_plain`` was true at the forward)."""

    @staticmethod
    def forward(ctx, depth, feat, coor, lb, iv, grid_size):
        ctx.save_for_backward(depth, feat, coor)
        ctx.grid, ctx.plain = (lb, iv, grid_size), kernels.use_plain(depth)
        if ctx.plain:
            return bev_pool_v2_plain(depth, feat, coor, lb, iv, grid_size)
        return bev_pool_fwd(depth, feat, coor, lb, iv, grid_size)

    @staticmethod
    def backward(ctx, g):
        depth, feat, coor = ctx.saved_tensors
        # A slice of torch.cat's backward (the temporal branch) is strided.
        g = g.contiguous()
        if ctx.plain:
            d_depth, d_feat = bev_pool_v2_bwd_plain(depth, feat, coor, g, *ctx.grid)
        else:
            d_depth, d_feat = bev_pool_bwd(depth, feat, coor, g, *ctx.grid)
        return (d_depth if ctx.needs_input_grad[0] else None,
                d_feat if ctx.needs_input_grad[1] else None, None, None, None, None)


def bev_pool_v2(depth: torch.Tensor, feat: torch.Tensor, coor: torch.Tensor,
                grid_lower_bound: Sequence[float], grid_interval: Sequence[float],
                grid_size: Tuple[int, int, int]) -> torch.Tensor:
    """Pool depth-weighted image features into the BEV voxel grid.

    depth (B, N, D, H, W) (softmaxed), feat (B, N, H, W, C), coor
    (B, N, D, H, W, 3) in ego coordinates; grid_size (X, Y, Z). Returns
    (B, C, Z, Y, X) f32, differentiable in depth and feat. Wrapper of S1 and
    S1b: the CUDA kernels, or the plain versions where ``kernels.use_plain``.
    """
    return _BevPool.apply(depth, feat, coor, grid_lower_bound, grid_interval, grid_size)


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
