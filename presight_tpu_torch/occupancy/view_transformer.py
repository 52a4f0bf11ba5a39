"""LSS (lift-splat-shoot) view transformer with the BEVStereo temporal cost
volume, the port of presight_tpu/occupancy/view_transformer.py.

Reference spec (as the JAX module's): occupancy/mmdet3d/models/necks/
view_transformer.py -- frustum creation and lidar-coordinate projection
(:112-175), the camera-aware DepthNet (:505-727) and the BEVStereo cost
volume (gen_grid :585-613, calculate_cost_volumn :615-643): each frustum
point of the keyframe reprojects through k2s_sensor into the previous
sweep's image, the previous stereo features are bilinearly sampled there
(zeros padding, align_corners=True), and the channel-L1 mismatch over the
depth hypotheses, softmaxed over D, feeds the depth head.

:func:`stereo_cost_volume` is kernel S2 (csrc/stereo_cost.cu) on CUDA
tensors and :func:`stereo_cost_volume_plain` (``F.grid_sample`` per depth
bin) where ``kernels.use_plain`` says so; the splat is S1
(bev_pool.py). The public functions keep the JAX package's layouts
(channels last); the modules run NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from .bev_pool import bev_pool_v2
from ..models.layers import BatchNorm, Conv, Dense


def create_frustum(depth_cfg, input_size, downsample) -> np.ndarray:
    """(D, Hf, Wf, 3) frustum template (view_transformer.py:112-138): pixel
    coordinates in the input image's resolution and metric depth."""
    h_in, w_in = input_size
    h_feat, w_feat = h_in // downsample, w_in // downsample
    d = np.arange(*depth_cfg, dtype=np.float32)
    D = len(d)
    d = np.broadcast_to(d.reshape(-1, 1, 1), (D, h_feat, w_feat))
    x = np.broadcast_to(np.linspace(0, w_in - 1, w_feat, dtype=np.float32).reshape(1, 1, -1),
                        (D, h_feat, w_feat))
    y = np.broadcast_to(np.linspace(0, h_in - 1, h_feat, dtype=np.float32).reshape(1, -1, 1),
                        (D, h_feat, w_feat))
    return np.stack([x, y, d], axis=-1)


def _unproject(frustum, rot, trans, cam2imgs, post_rots, post_trans):
    """Undo the image augmentation, unproject through the inverse
    intrinsics, then rotate by ``rot`` (B, N, 3, 3) and add ``trans``
    (B, N, 3): the shared head of get_lidar_coor and gen_stereo_grid."""
    points = frustum[None, None] - post_trans[:, :, None, None, None, :]
    points = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rots), points)
    points = torch.cat([points[..., :2] * points[..., 2:3], points[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", rot, torch.linalg.inv(cam2imgs))
    points = torch.einsum("bnij,bndhwj->bndhwi", combine, points)
    return points + trans[:, :, None, None, None, :]


def get_lidar_coor(frustum, sensor2ego, cam2imgs, post_rots, post_trans, bda) -> torch.Tensor:
    """Frustum template (D, Hf, Wf, 3) -> ego coordinates (B, N, D, Hf, Wf, 3)
    (view_transformer.py:143-175), then the BEV-augmentation matrix."""
    points = _unproject(frustum, sensor2ego[:, :, :3, :3], sensor2ego[:, :, :3, 3], cam2imgs,
                        post_rots, post_trans)
    points = torch.einsum("bij,bndhwj->bndhwi", bda[:, :3, :3], points)
    return points + bda[:, None, None, None, None, :3, 3]


def gen_stereo_grid(frustum_cv, k2s_sensor, cam2imgs, post_rots, post_trans,
                    input_size: Tuple[int, int]) -> torch.Tensor:
    """Reproject the keyframe frustum (D, Hs, Ws, 3) into the previous
    sweep's image (view_transformer.py:585-613). Returns (B*N, D*Hs*Ws, 2)
    normalised sample coordinates, D-major; points behind the camera map
    to -2."""
    B, N = k2s_sensor.shape[:2]
    hi, wi = input_size
    points = _unproject(frustum_cv, k2s_sensor[:, :, :3, :3], k2s_sensor[:, :, :3, 3], cam2imgs,
                        post_rots, post_trans)
    neg_mask = points[..., 2] < 1e-3
    points = torch.einsum("bnij,bndhwj->bndhwi", cam2imgs, points)
    points = points[..., :2] / points[..., 2:3]
    points = (torch.einsum("bnij,bndhwj->bndhwi", post_rots[:, :, :2, :2], points)
              + post_trans[:, :, None, None, None, :2])
    px = points[..., 0] / (wi - 1.0) * 2.0 - 1.0
    py = points[..., 1] / (hi - 1.0) * 2.0 - 1.0
    px = torch.where(neg_mask, torch.full_like(px, -2.0), px)
    py = torch.where(neg_mask, torch.full_like(py, -2.0), py)
    return torch.stack([px, py], dim=-1).reshape(B * N, -1, 2)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling, zeros padding, align_corners=True
    (view_transformer.py:81): img (BN, H, W, C), grid (BN, P, 2) in
    [-1, 1] -> (BN, P, C)."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid[:, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0].permute(0, 2, 1)


def stereo_cost_volume_plain(prev_feat, curr_feat, grid, depth_bins: int, bias: float = 5.0,
                             return_cost: bool = False):
    """Plain version of S2: for each depth bin, ``F.grid_sample`` of the
    previous features, the channel-L1 cost to the current ones, ``+ bias``
    where the sample's channel 0 is exactly 0 (view_transformer.py:198);
    then softmax(-cost) over the bins. Returns (BN, Hs, Ws, D), and with
    ``return_cost`` also the costs (BN, Hs, Ws, D) and the bias mask."""
    BN, Hs, Ws, Cs = curr_feat.shape
    prev = prev_feat.permute(0, 3, 1, 2)
    curr = curr_feat.permute(0, 3, 1, 2)
    grid_d = grid.reshape(BN, depth_bins, Hs, Ws, 2)
    costs, masks = [], []
    for d in range(depth_bins):
        warped = F.grid_sample(prev, grid_d[:, d], mode="bilinear", padding_mode="zeros",
                               align_corners=True)
        cost = (curr - warped).abs().sum(dim=1)
        invalid = warped[:, 0] == 0.0
        if bias != 0.0:
            cost = cost + bias * invalid.to(cost.dtype)
        costs.append(cost)
        masks.append(invalid)
    cost = torch.stack(costs, dim=-1)
    prob = torch.softmax(-cost, dim=-1)
    if return_cost:
        return prob, cost, torch.stack(masks, dim=-1)
    return prob


def stereo_cost_volume(prev_feat: torch.Tensor, curr_feat: torch.Tensor, grid: torch.Tensor,
                       depth_bins: int, bias: float = 5.0, return_cost: bool = False):
    """Channel-L1 matching cost over depth hypotheses, softmaxed over D
    (view_transformer.py:168): prev_feat, curr_feat (BN, Hs, Ws, Cs), grid
    (BN, D*Hs*Ws, 2) from gen_stereo_grid. Returns (BN, Hs, Ws, D) (and,
    with ``return_cost``, the costs and the bias mask). Wrapper of S2: the
    CUDA kernel, or the plain version where ``kernels.use_plain``. The
    warped volume (BN, D, Hs, Ws, Cs) is never materialised."""
    if kernels.use_plain(curr_feat):
        return stereo_cost_volume_plain(prev_feat, curr_feat, grid, depth_bins, bias, return_cost)
    BN, Hs, Ws, Cs = curr_feat.shape
    if prev_feat.shape != curr_feat.shape or grid.shape != (BN, depth_bins * Hs * Ws, 2):
        raise ValueError(f"stereo_cost_volume: shapes prev {tuple(prev_feat.shape)}, curr "
                         f"{tuple(curr_feat.shape)}, grid {tuple(grid.shape)} do not agree")
    for t in (prev_feat, curr_feat, grid):
        if t.dtype != torch.float32:
            raise TypeError("stereo_cost_volume: float32 features and grid expected")
    kernels.require_cuda("stereo_cost_volume", prev_feat, curr_feat, grid)
    dev = curr_feat.device
    out = torch.empty((BN, Hs, Ws, depth_bins), dtype=torch.float32, device=dev)
    cost = mask = None
    if return_cost:
        cost = torch.empty_like(out)
        mask = torch.empty((BN, Hs, Ws, depth_bins), dtype=torch.uint8, device=dev)
    kernels.launch("stereo_cost_volume_fwd", prev_feat.data_ptr(), curr_feat.data_ptr(),
                   grid.data_ptr(), BN, Hs, Ws, Cs, depth_bins, float(bias), out.data_ptr(),
                   kernels.ptr(cost), kernels.ptr(mask))
    if return_cost:
        return out, cost, mask.bool()
    return out


def stereo_row_fetches(grid: torch.Tensor, height: int, width: int,
                       depth_bins: int) -> Dict[str, int]:
    """What S2's reuse rule (csrc/stereo_cost.cu) makes of ``grid`` (BN,
    D*H*W, 2): a pixel's bins are walked in order, holding the four corner
    rows of the bin in hand; a bin whose clamped top-left corner steps by at
    most one pixel on each axis loads only the rows it does not share with
    the last, any other bin all four, and a row outside the image is zeros,
    not a load. Returns the (pixel, bin) samples, the rows loaded
    (``fetches``), the inside corners (``corners``: what a design that
    reloads every bin's rows reads), and the bins that keep all four rows
    (``same``), step by one pixel (``step``) or load all four (``jump``,
    each pixel's first bin included)."""
    H, W, D = height, width, depth_bins
    g = grid.reshape(grid.shape[0], D, H * W, 2)
    x = (g[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (g[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.nan_to_num(torch.floor(x), nan=-2.0).clamp(-2, W)
    y0 = torch.nan_to_num(torch.floor(y), nan=-2.0).clamp(-2, H)
    dx = torch.diff(x0, dim=1, prepend=torch.full_like(x0[:, :1], -1e9))
    dy = torch.diff(y0, dim=1, prepend=torch.full_like(y0[:, :1], -1e9))
    near = (dx.abs() <= 1) & (dy.abs() <= 1)
    same = (dx == 0) & (dy == 0)
    fetches = corners = 0
    for a in (0, 1):
        for b in (0, 1):
            xa, yb = x0 + a, y0 + b
            inside = (xa >= 0) & (xa <= W - 1) & (yb >= 0) & (yb <= H - 1)
            need = ~near | (dx == (1 if a else -1)) | (dy == (1 if b else -1))
            fetches += int((need & inside).sum())
            corners += int(inside.sum())
    return {"samples": int(x0.numel()), "fetches": fetches, "corners": corners,
            "same": int(same.sum()), "step": int((near & ~same).sum()),
            "jump": int((~near).sum())}


class DepthNet(nn.Module):
    """Camera-aware depth/context head (view_transformer.py:208): conv
    trunk with an SE gate from the flattened camera parameters; with
    ``stereo`` the cost volume goes through ``cv_stages`` stride-2 convs and
    joins the depth branch. Emits D depth logits + C context channels."""

    def __init__(self, in_channels: int, mid_channels: int, depth_bins: int, out_channels: int,
                 stereo: bool = False, cv_stages: int = 2, mlp_channels: int = 33, device=None):
        super().__init__()
        self.stereo, self.cv_stages = stereo, cv_stages
        self.Conv_0 = Conv(in_channels, mid_channels, (3, 3), device=device)
        self.BatchNorm_0 = BatchNorm(mid_channels, device)
        self.Dense_0 = Dense(mlp_channels, mid_channels, device)
        self.Dense_1 = Dense(mid_channels, mid_channels, device)
        k = 1
        if stereo:
            for _ in range(cv_stages):
                self.add_module(f"Conv_{k}", Conv(depth_bins, depth_bins, (3, 3), 2, device=device))
                self.add_module(f"BatchNorm_{k}", BatchNorm(depth_bins, device))
                k += 1
        cat = mid_channels + (depth_bins if stereo else 0)
        self.add_module(f"Conv_{k}", Conv(cat, mid_channels, (3, 3), device=device))
        self.add_module(f"BatchNorm_{k}", BatchNorm(mid_channels, device))
        self.add_module(f"Conv_{k + 1}", Conv(mid_channels, depth_bins + out_channels, (1, 1),
                                              device=device))
        self.k = k

    def forward(self, x, mlp_input, cost_volume=None):
        """x (BN, Cin, Hf, Wf), mlp_input (BN, 33), cost_volume
        (BN, D, Hs, Ws) or None -> (BN, D + C, Hf, Wf)."""
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        se = self.Dense_1(F.relu(self.Dense_0(mlp_input)))
        h = h * torch.sigmoid(se)[:, :, None, None]
        if self.stereo:
            cv = cost_volume
            for k in range(1, 1 + self.cv_stages):
                cv = getattr(self, f"BatchNorm_{k}")(getattr(self, f"Conv_{k}")(cv))
            h = torch.cat([h, cv], dim=1)
        k = self.k
        h = F.relu(getattr(self, f"BatchNorm_{k}")(getattr(self, f"Conv_{k}")(h)))
        return getattr(self, f"Conv_{k + 1}")(h)


class LSSViewTransformer(nn.Module):
    """Lift-splat view transformer (view_transformer.py:246). grid_config
    keys 'x', 'y', 'z', 'depth', each (lo, hi, step)."""

    def __init__(self, grid_config: Dict[str, Tuple[float, float, float]],
                 input_size: Tuple[int, int], downsample: int = 16, in_channels: int = 512,
                 out_channels: int = 64, mid_channels: int = 64, collapse_z: bool = True,
                 stereo: bool = False, cv_downsample: int = 4, cv_bias: float = 5.0,
                 device=None):
        super().__init__()
        self.grid_config = grid_config
        self.input_size = tuple(input_size)
        self.downsample, self.collapse_z = downsample, collapse_z
        self.stereo, self.cv_downsample, self.cv_bias = stereo, cv_downsample, cv_bias
        self.DepthNet_0 = DepthNet(in_channels, mid_channels, self.depth_bins, out_channels,
                                   stereo=stereo,
                                   cv_stages=int(math.log2(downsample // cv_downsample)),
                                   device=device)

    @property
    def depth_bins(self) -> int:
        lo, hi, step = self.grid_config["depth"]
        return int(round((hi - lo) / step))

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(int(round((self.grid_config[k][1] - self.grid_config[k][0])
                               / self.grid_config[k][2])) for k in ("x", "y", "z"))

    def frustum(self, downsample: int, device) -> torch.Tensor:
        return torch.from_numpy(create_frustum(self.grid_config["depth"], self.input_size,
                                               downsample)).to(device)

    def forward(self, x, sensor2ego, cam2imgs, post_rots, post_trans, bda,
                stereo_metas: Optional[Dict] = None):
        """x (B, N, Cin, Hf, Wf). stereo_metas (with ``stereo``): 'curr_feat'
        and 'prev_feat' (B, N, Hs, Ws, Cs) at cv_downsample (prev_feat None
        on the first frame: a zero cost volume, view_transformer.py:652-659)
        and 'k2s_sensor' (B, N, 4, 4). Returns (bev (B, C, Z, Y, X), or (B, C*Z, Y, X) with
        collapse_z, and depth (B*N, D, Hf, Wf))."""
        B, N, Cin, Hf, Wf = x.shape
        D = self.depth_bins
        mlp_input = torch.cat([cam2imgs.reshape(B, N, 9), post_rots.reshape(B, N, 9),
                               post_trans.reshape(B, N, 3),
                               sensor2ego[:, :, :3, :].reshape(B, N, 12)], dim=-1)
        cost_volume = None
        if self.stereo:
            hs = self.input_size[0] // self.cv_downsample
            ws = self.input_size[1] // self.cv_downsample
            curr = stereo_metas["curr_feat"].reshape(B * N, hs, ws, -1)
            if stereo_metas.get("prev_feat") is None:
                cost_volume = torch.zeros((B * N, D, hs, ws), dtype=x.dtype, device=x.device)
            else:
                grid = gen_stereo_grid(self.frustum(self.cv_downsample, x.device),
                                       stereo_metas["k2s_sensor"], cam2imgs, post_rots,
                                       post_trans, self.input_size)
                prev = stereo_metas["prev_feat"].reshape(B * N, hs, ws, -1)
                with torch.no_grad():  # the matching prior carries no gradient (:645-664)
                    cv = stereo_cost_volume(prev.contiguous(), curr.contiguous(),
                                            grid.contiguous(), D, self.cv_bias)
                cost_volume = cv.permute(0, 3, 1, 2)
        feat = self.DepthNet_0(x.reshape(B * N, Cin, Hf, Wf), mlp_input.reshape(B * N, -1),
                               cost_volume)
        depth = torch.softmax(feat[:, :D], dim=1)  # (BN, D, Hf, Wf)
        tran_feat = feat[:, D:].permute(0, 2, 3, 1).reshape(B, N, Hf, Wf, -1)
        coor = get_lidar_coor(self.frustum(self.downsample, x.device), sensor2ego, cam2imgs,
                              post_rots, post_trans, bda)
        lb = [self.grid_config[k][0] for k in ("x", "y", "z")]
        iv = [self.grid_config[k][2] for k in ("x", "y", "z")]
        bev = bev_pool_v2(depth.reshape(B, N, D, Hf, Wf).contiguous(), tran_feat.contiguous(),
                          coor.contiguous(), lb, iv, self.grid_size)
        if self.collapse_z:
            # cat(unbind(dim=2), 1): z-major channel blocks (view_transformer.py:225-227)
            b, c, z, yy, xx = bev.shape
            bev = bev.permute(0, 2, 1, 3, 4).reshape(b, z * c, yy, xx)
        return bev, depth
