"""Plain PyTorch reference of BEVDet-Occ (stage-3 occupancy): serving and
one training step.

A frozen plain copy of ``presight_tpu_torch`` at commit db696f7:
models/layers.py, occupancy/backbones.py, occupancy/bev_pool.py
(``bev_pool_v2_plain``: the lift-splat as ``index_add_``, whose gradient
autograd takes, so no hand S1b), occupancy/view_transformer.py
(``stereo_cost_volume_plain``: ``F.grid_sample`` per depth bin), the
``warp_bev`` of mapping/conv_gru.py, models/prior_fusion.py and
occupancy/bevdet_occ.py (``BEVDetOcc``, ``occ_loss``), then the training
step of scripts/train_occ.py: optax's global-norm clipping, AdamW written
out (torch.optim.AdamW's arithmetic), and the MEGVII EMA of utils/ema.py.
Convolutions run in IEEE float32 (``ieee_convolutions``). The module
names, and so the state_dict keys, are the port's, so one state_dict
feeds both. Imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]


@contextlib.contextmanager
def ieee_convolutions(ieee: bool = True):
    """cuDNN convolutions in IEEE float32 inside the block, and matrix
    products too (both in TF32 with ``ieee`` False, the control's lower
    precision); the process's settings restored after it."""
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision, torch.backends.cuda.matmul.allow_tf32
    conv.fp32_precision = "ieee" if ieee else "tf32"
    torch.backends.cuda.matmul.allow_tf32 = not ieee
    try:
        yield
    finally:
        conv.fp32_precision, torch.backends.cuda.matmul.allow_tf32 = before


# ------------------------------------------------------------ models/layers.py


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dimension: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax.linen.Conv over NC(D)HW tensors with an (out, in, *kernel) weight."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Sequence[int],
                 stride: int = 1, padding: Padding = "SAME", bias: bool = True, device=None):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = int(stride)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels, *self.kernel),
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = len(self.kernel)
        if self.padding == "SAME":
            pads = [same_pads(n, k, self.stride) for n, k in zip(x.shape[2:], self.kernel)]
        elif self.padding == "VALID":
            pads = [(0, 0)] * dims
        else:
            pads = [tuple(p) for p in self.padding]
        conv = F.conv2d if dims == 2 else F.conv3d
        if all(lo == hi for lo, hi in pads):
            return conv(x, self.weight, self.bias, self.stride, [lo for lo, _ in pads])
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
        return conv(F.pad(x, flat), self.weight, self.bias, self.stride)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over channel dim 1.

    Train mode follows flax, not ``F.batch_norm(training=True)``: the mean
    and the biased variance over every axis but the channel, the variance
    as flax's ``use_fast_variance`` takes it (E[x^2] - E[x]^2, clamped at
    0), and the running update ``ra = 0.99 ra + 0.01 stat`` with that
    biased variance (torch would take the unbiased one and momentum 0.1).
    """

    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.empty(channels, device=device))
        self.register_buffer("running_var", torch.empty(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.EPS)
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.EPS) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class Dense(nn.Linear):
    """flax.linen.Dense: y = x @ kernel + bias, weight kept (out, in)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        nn.Module.__init__(self)  # not nn.Linear's: it draws random weights
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty((out_features, in_features), device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))


# ------------------------------------------------------------ occupancy/backbones.py


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + skip (backbones.py:32)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, (3, 3), stride, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device)
        self.Conv_1 = Conv(features, features, (3, 3), bias=False, device=device)
        self.BatchNorm_1 = BatchNorm(features, device)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.Conv_2 = Conv(in_channels, features, (1, 1), stride, bias=False, device=device)
            self.BatchNorm_2 = BatchNorm(features, device)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck, stride on the 3x3 (backbones.py:54); the
    output has 4 x ``features`` channels."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        out = features * 4
        self.Conv_0 = Conv(in_channels, features, (1, 1), bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device)
        self.Conv_1 = Conv(features, features, (3, 3), stride, bias=False, device=device)
        self.BatchNorm_1 = BatchNorm(features, device)
        self.Conv_2 = Conv(features, out, (1, 1), bias=False, device=device)
        self.BatchNorm_2 = BatchNorm(out, device)
        self.project = stride != 1 or in_channels != out
        if self.project:
            self.Conv_3 = Conv(in_channels, out, (1, 1), stride, bias=False, device=device)
            self.BatchNorm_3 = BatchNorm(out, device)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(h + identity)


RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def resnet_channels(depth: int, base_width: int) -> Tuple[int, ...]:
    """Output channels of the four stages."""
    factor = 4 if depth >= 50 else 1
    return tuple(base_width * 2 ** i * factor for i in range(4))


class ResNet(nn.Module):
    """torchvision-style ResNet trunk (backbones.py:85); returns the stage
    outputs at ``out_indices`` (stage i at stride 4 * 2^i)."""

    def __init__(self, depth: int = 50, out_indices: Tuple[int, ...] = (0, 2, 3),
                 base_width: int = 64, in_channels: int = 3, device=None):
        super().__init__()
        if depth not in RESNET_LAYERS:
            raise ValueError(f"unsupported ResNet depth {depth}")
        self.out_indices = tuple(out_indices)
        self.Conv_0 = Conv(in_channels, base_width, (7, 7), 2, padding=[(3, 3), (3, 3)],
                           bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(base_width, device)
        block = Bottleneck if depth >= 50 else BasicBlock
        factor = 4 if depth >= 50 else 1
        self.stages: List[List[str]] = []
        ch, k = base_width, 0
        for i, n_blocks in enumerate(RESNET_LAYERS[depth]):
            width = base_width * 2 ** i
            names = []
            for b in range(n_blocks):
                name = f"{block.__name__}_{k}"
                self.add_module(name, block(ch, width, (1 if i == 0 else 2) if b == 0 else 1,
                                            device=device))
                ch, k = width * factor, k + 1
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)  # -inf pad of 1, VALID 3x3/2
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if i in self.out_indices:
                outs.append(h)
        return outs


class CustomFPN(nn.Module):
    """FPN with nearest top-down upsampling (backbones.py:122); returns the
    ``out_ids`` outputs (one tensor when there is one)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 out_ids: Tuple[int, ...] = (0,), device=None):
        super().__init__()
        self.out_ids = tuple(out_ids)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv(c, out_channels, (1, 1), device=device))
        for i in self.out_ids:
            self.add_module(f"fpn_{i}", Conv(out_channels, out_channels, (3, 3), device=device))

    def forward(self, inputs: Sequence[torch.Tensor]):
        laterals = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            # jax.image.resize "nearest": source index floor((i + 0.5) * in / out)
            up = F.interpolate(laterals[i], size=laterals[i - 1].shape[2:], mode="nearest-exact")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [getattr(self, f"fpn_{i}")(laterals[i]) for i in self.out_ids]
        return outs[0] if len(outs) == 1 else outs


class BasicBlock3D(nn.Module):
    """Two 3x3x3 Conv3d+BN (ReLU after the first), a 3x3x3 conv (with bias,
    no BN) as the skip when the shape changes (backbones.py:146)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        k = (3, 3, 3)
        self.Conv_0 = Conv(in_channels, features, k, stride, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device)
        self.Conv_1 = Conv(features, features, k, bias=False, device=device)
        self.BatchNorm_1 = BatchNorm(features, device)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.Conv_2 = Conv(in_channels, features, k, stride, device=device)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        identity = self.Conv_2(x) if self.project else x
        return F.relu(h + identity)


class CustomResNet3D(nn.Module):
    """Per-stage BasicBlock3D chains (backbones.py:170); returns the outputs
    listed in ``output_ids`` (all stages by default)."""

    def __init__(self, in_channels: int, num_layer: Tuple[int, ...] = (1, 2, 4),
                 num_channels: Tuple[int, ...] = (32, 64, 128), stride: Tuple[int, ...] = (1, 2, 2),
                 output_ids: Optional[Tuple[int, ...]] = None, device=None):
        super().__init__()
        self.output_ids = tuple(range(len(num_layer))) if output_ids is None else output_ids
        self.stages: List[List[str]] = []
        ch, k = in_channels, 0
        for n, width, st in zip(num_layer, num_channels, stride):
            names = []
            for b in range(n):
                name = f"BasicBlock3D_{k}"
                self.add_module(name, BasicBlock3D(ch, width, st if b == 0 else 1, device))
                ch, k = width, k + 1
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.output_ids:
                outs.append(x)
        return outs


def trilinear_resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """align_corners=True trilinear resize of an NCDHW tensor
    (backbones.py:195 ``_trilinear_resize``)."""
    return F.interpolate(x, size=tuple(shape), mode="trilinear", align_corners=True)


class LSSFPN3D(nn.Module):
    """Upsample x16 and x32 to x8's size (trilinear, align_corners=True),
    concatenate channels, 1x1x1 Conv3d + BN + ReLU (backbones.py:225)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, out_channels, (1, 1, 1), bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device)

    def forward(self, feats: Sequence[torch.Tensor]):
        x8, x16, x32 = feats
        target = x8.shape[2:]
        h = torch.cat([x8, trilinear_resize(x16, target), trilinear_resize(x32, target)], dim=1)
        return F.relu(self.BatchNorm_0(self.Conv_0(h)))


# ------------------------------------------------------------ occupancy/bev_pool.py (plain S1; autograd gives S1b)


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


# ------------------------------------------------------------ occupancy/view_transformer.py (plain S2)


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
                    cv = stereo_cost_volume_plain(prev, curr, grid, D, self.cv_bias)
                cost_volume = cv.permute(0, 3, 1, 2)
        feat = self.DepthNet_0(x.reshape(B * N, Cin, Hf, Wf), mlp_input.reshape(B * N, -1),
                               cost_volume)
        depth = torch.softmax(feat[:, :D], dim=1)  # (BN, D, Hf, Wf)
        tran_feat = feat[:, D:].permute(0, 2, 3, 1).reshape(B, N, Hf, Wf, -1)
        coor = get_lidar_coor(self.frustum(self.downsample, x.device), sensor2ego, cam2imgs,
                              post_rots, post_trans, bda)
        lb = [self.grid_config[k][0] for k in ("x", "y", "z")]
        iv = [self.grid_config[k][2] for k in ("x", "y", "z")]
        bev = bev_pool_v2_plain(depth.reshape(B, N, D, Hf, Wf), tran_feat, coor, lb, iv,
                                self.grid_size)
        if self.collapse_z:
            # cat(unbind(dim=2), 1): z-major channel blocks (view_transformer.py:225-227)
            b, c, z, yy, xx = bev.shape
            bev = bev.permute(0, 2, 1, 3, 4).reshape(b, z * c, yy, xx)
        return bev, depth


# ------------------------------------------------------------ mapping/conv_gru.py


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


# ------------------------------------------------------------ models/prior_fusion.py


def formulate_voxels(prior_feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                     voxel_resolution: Tuple[int, int, int]) -> torch.Tensor:
    """Dense grid scatter (prior_fusion_module.py:114-131): (V, C) voxel
    features at (V, 3) int (z, y, x) coords into an (rx, ry, rz, C) grid,
    indexed [z, y, x] -- the reference's quirk, kept bit for bit: a voxel
    survives only where z < rx, y < ry and x < rz. Padded rows (valid
    False) are dropped."""
    rx, ry, rz = voxel_resolution
    C = prior_feats.shape[-1]
    i0, i1, i2 = coords.long().unbind(-1)
    keep = valid & (i0 >= 0) & (i0 < rx) & (i1 >= 0) & (i1 < ry) & (i2 >= 0) & (i2 < rz)
    grid = torch.zeros((rx * ry * rz, C), dtype=prior_feats.dtype, device=prior_feats.device)
    grid[((i0 * ry + i1) * rz + i2)[keep]] = prior_feats[keep]
    return grid.reshape(rx, ry, rz, C)


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


# ------------------------------------------------------------ occupancy/bevdet_occ.py


@dataclasses.dataclass(frozen=True)
class BEVDetOccConfig:
    """The fields of the JAX package's BEVDetOcc (bevdet_occ.py:119-164)."""

    grid_config: Dict[str, Tuple[float, float, float]]
    input_size: Tuple[int, int]
    downsample: int = 16
    view_out_channels: int = 64
    img_widths: Sequence[int] = (32, 64, 128, 256)
    neck_channels: int = 256
    backbone: str = "simple"
    """'simple' (strided-conv stand-in) or 'resnet' (ResNet out_indices
    (0, 2, 3) + CustomFPN, the reference topology)."""
    resnet_depth: int = 50
    resnet_base_width: int = 64
    bev_neck: str = "simple"
    """'simple' (BEVEncoder3D) or 'lssfpn3d' (CustomResNet3D + LSSFPN3D)."""
    bev_widths: Sequence[int] = (64, 128)
    bev_out_channels: int = 32
    occ_out_dim: int = 32
    num_classes: int = 18
    prior_pc_range: Optional[Sequence[float]] = None
    prior_voxel_size: Optional[Sequence[float]] = None
    prior_in_channels: int = 68
    prior_fusion: str = "voxel"
    """'voxel' (PriorFusion3D_voxel); 'crossattn' is not ported yet."""
    use_prior_only: bool = False
    temporal: bool = False
    stereo: bool = False
    stereo_stage: int = 2

    def grid_size(self) -> Tuple[int, int, int]:
        """(X, Y, Z) voxel counts."""
        g = self.grid_config
        return tuple(int(round((g[k][1] - g[k][0]) / g[k][2])) for k in ("x", "y", "z"))


class ConvStage(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, (3, 3), stride, device=device)
        self.BatchNorm_0 = BatchNorm(features, device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class ImageEncoder(nn.Module):
    """Strided conv backbone + 1x1 neck (the toy stand-in for ResNet +
    CustomFPN); stage ``stereo_stage`` doubles as the stereo feature."""

    def __init__(self, widths: Sequence[int], neck_channels: int, stereo_stage: int = 2,
                 device=None):
        super().__init__()
        self.stereo_stage = stereo_stage
        ch = 3
        for i, w in enumerate(widths):
            self.add_module(f"ConvStage_{2 * i}", ConvStage(ch, w, 2, device))
            self.add_module(f"ConvStage_{2 * i + 1}", ConvStage(w, w, 1, device))
            ch = w
        self.num_stages = len(widths)
        self.Conv_0 = Conv(ch, neck_channels, (1, 1), device=device)

    def forward(self, imgs, return_stereo: bool = False):
        x, stereo = imgs, None
        for i in range(self.num_stages):
            x = getattr(self, f"ConvStage_{2 * i + 1}")(getattr(self, f"ConvStage_{2 * i}")(x))
            if i + 1 == self.stereo_stage:
                stereo = x
        out = self.Conv_0(x)
        return (out, stereo) if return_stereo else out


class BEVEncoder3D(nn.Module):
    """3x3x3 conv stack on the (B, C, Z, Y, X) volume (the toy stand-in for
    CustomResNet3D + LSSFPN3D)."""

    def __init__(self, in_channels: int, widths: Sequence[int], out_channels: int, device=None):
        super().__init__()
        ch = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(ch, w, (3, 3, 3), device=device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(w, device))
            ch = w
        self.num_layers = len(widths)
        self.add_module(f"Conv_{len(widths)}", Conv(ch, out_channels, (3, 3, 3), device=device))

    def forward(self, x):
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return getattr(self, f"Conv_{self.num_layers}")(x)


class OccHead(nn.Module):
    """Final 3D conv + softplus predicter (bevdet_occ.py:27-42 of the
    reference): (B, C, Z, Y, X) -> (B, X, Y, Z, num_classes) logits."""

    def __init__(self, in_channels: int, out_dim: int = 32, num_classes: int = 18,
                 use_predicter: bool = True, device=None):
        super().__init__()
        self.use_predicter = use_predicter
        self.Conv_0 = Conv(in_channels, out_dim if use_predicter else num_classes, (3, 3, 3),
                           device=device)
        if use_predicter:
            self.Dense_0 = Dense(out_dim, out_dim * 2, device)
            self.Dense_1 = Dense(out_dim * 2, num_classes, device)

    def forward(self, x):
        h = self.Conv_0(x).permute(0, 4, 3, 2, 1)
        if self.use_predicter:
            h = self.Dense_1(F.softplus(self.Dense_0(h)))
        return h


class BEVDetOcc(nn.Module):
    """BEVDet-Occ with the PreSight prior-fusion hook. Built in eval mode;
    ``model.train()`` trains it.

    ``forward`` takes the JAX module's inputs: imgs (B, N, 3, H, W) and the
    per-camera geometry, the voxelized priors (``prior_feats`` (B, V, 68),
    ``prior_coords`` (B, V, 3), ``prior_valid`` (B, V)), and the previous
    frame's ``prev_bev`` (B, C, Z, Y, X) with ``prev2curr`` (B, 3, 3) and
    ``prev_stereo_feat`` (B, N, Hs, Ws, Cs) with ``k2s_sensor``
    (B, N, 4, 4). It returns (occ logits (B, X, Y, Z, classes), depth
    (B*N, D, Hf, Wf)) and, with stereo, the current stereo features
    (B, N, Hs, Ws, Cs) for the next frame.

    Its parameters live on ``device``, the card unless the caller names
    another. The prior fusion exists when ``with_prior_fusion`` (by default: when
    the config has a prior range), as the JAX module's parameters exist
    only when priors were traced at init.
    """

    def __init__(self, config: BEVDetOccConfig, device=None,
                 with_prior_fusion: Optional[bool] = None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        cfg = self.config = config
        C = cfg.view_out_channels
        if cfg.backbone == "resnet":
            chans = resnet_channels(cfg.resnet_depth, cfg.resnet_base_width)
            self.ResNet_0 = ResNet(cfg.resnet_depth, (0, 2, 3), cfg.resnet_base_width,
                                   device=device)
            self.CustomFPN_0 = CustomFPN(chans[2:], cfg.neck_channels, (0,), device)
            cv_downsample = 4
        elif cfg.backbone == "simple":
            self.ImageEncoder_0 = ImageEncoder(cfg.img_widths, cfg.neck_channels,
                                               cfg.stereo_stage, device)
            cv_downsample = 2 ** cfg.stereo_stage
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.LSSViewTransformer_0 = LSSViewTransformer(
            cfg.grid_config, cfg.input_size, cfg.downsample, cfg.neck_channels, C,
            collapse_z=False, stereo=cfg.stereo, cv_downsample=cv_downsample, device=device)
        if cfg.temporal:
            self.temporal_fuse = Conv(2 * C, C, (1, 1, 1), device=device)
        self.with_prior_fusion = (cfg.prior_pc_range is not None if with_prior_fusion is None
                                  else with_prior_fusion)
        gx, gy, gz = cfg.grid_size()
        if self.with_prior_fusion:
            if cfg.prior_fusion != "voxel":
                raise NotImplementedError(
                    f"prior_fusion={cfg.prior_fusion!r} needs models/window_attention.py, "
                    "which is not ported yet (ROADMAP Queue 1 item 4(c))")
            self.PriorFusion3DVoxel_0 = PriorFusion3DVoxel(
                cfg.prior_pc_range, cfg.prior_voxel_size, bev_channels=C, out_num_z=gz,
                out_channels=C, bev_hidden_channels=cfg.neck_channels,
                prior_in_channels=cfg.prior_in_channels, device=device)
        if cfg.bev_neck == "lssfpn3d":
            self.CustomResNet3D_0 = CustomResNet3D(C, (1, 2, 4), (C, 2 * C, 4 * C), (1, 2, 2),
                                                   device=device)
            self.LSSFPN3D_0 = LSSFPN3D(7 * C, C, device)
            head_in = C
        elif cfg.bev_neck == "simple":
            self.BEVEncoder3D_0 = BEVEncoder3D(C, cfg.bev_widths, cfg.bev_out_channels, device)
            head_in = cfg.bev_out_channels
        else:
            raise ValueError(f"unknown bev_neck {cfg.bev_neck!r}")
        self.OccHead_0 = OccHead(head_in, cfg.occ_out_dim, cfg.num_classes, device=device)
        self.eval()

    def forward(self, imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda,
                prior_feats=None, prior_coords=None, prior_valid=None,
                prev_bev=None, prev2curr=None, prev_stereo_feat=None, k2s_sensor=None):
        with ieee_convolutions():
            return self._forward(imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda,
                                 prior_feats, prior_coords, prior_valid, prev_bev, prev2curr,
                                 prev_stereo_feat, k2s_sensor)

    def _forward(self, imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda, prior_feats,
                 prior_coords, prior_valid, prev_bev, prev2curr, prev_stereo_feat, k2s_sensor):
        cfg = self.config
        B, N, _, H, W = imgs.shape
        x = imgs.reshape(B * N, 3, H, W)
        curr_stereo = None
        if cfg.backbone == "resnet":
            feats = self.ResNet_0(x)
            curr_stereo = feats[0] if cfg.stereo else None
            x = self.CustomFPN_0(feats[1:])
        elif cfg.stereo:
            x, curr_stereo = self.ImageEncoder_0(x, return_stereo=True)
        else:
            x = self.ImageEncoder_0(x)
        x = x.reshape(B, N, *x.shape[1:])
        stereo_metas = None
        if cfg.stereo:
            # (BN, Cs, Hs, Ws) -> (B, N, Hs, Ws, Cs): S2 gathers whole channel rows
            curr_stereo = curr_stereo.permute(0, 2, 3, 1).reshape(
                B, N, *curr_stereo.shape[2:], curr_stereo.shape[1]).contiguous()
            stereo_metas = dict(curr_feat=curr_stereo, prev_feat=prev_stereo_feat,
                                k2s_sensor=k2s_sensor)
        bev, depth = self.LSSViewTransformer_0(x, sensor2ego, cam2imgs, post_rots, post_trans,
                                               bda, stereo_metas)
        if cfg.temporal:
            # BEVDet4D: warp each z slice of the previous volume into the
            # current ego frame, concatenate, fuse back with a 1x1x1 conv.
            if prev_bev is None:
                prev_bev = torch.zeros_like(bev)
            if prev2curr is None:
                prev2curr = torch.eye(3, device=bev.device).expand(B, 3, 3)
            gx, gy = cfg.grid_config["x"], cfg.grid_config["y"]
            roi = (gx[1] - gx[0], gy[1] - gy[0])
            _, c, z, yy, xx = prev_bev.shape
            aligned = torch.stack([warp_bev(prev_bev[b].reshape(c * z, yy, xx), prev2curr[b], roi)
                                   for b in range(B)]).reshape(prev_bev.shape)
            bev = self.temporal_fuse(torch.cat([bev, aligned], dim=1))
        if prior_feats is not None:
            v = bev.permute(0, 1, 3, 4, 2)  # (B, C, Y, X, Z)
            if cfg.use_prior_only:
                v = torch.zeros_like(v)
            v = self.PriorFusion3DVoxel_0(v, prior_feats, prior_coords, prior_valid)
            bev = v.permute(0, 1, 4, 2, 3)
        if cfg.bev_neck == "lssfpn3d":
            bev = self.LSSFPN3D_0(self.CustomResNet3D_0(bev.contiguous()))
        else:
            bev = self.BEVEncoder3D_0(bev.contiguous())
        occ = self.OccHead_0(bev)
        if cfg.stereo:
            return occ, depth, curr_stereo
        return occ, depth


def occ_loss(logits: torch.Tensor, voxel_semantics: torch.Tensor,
             mask_camera: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Occupancy cross-entropy (bevdet_occ.py:286-301 of the JAX package):
    flat log-softmax CE of logits (B, X, Y, Z, classes) at the integer
    labels (B, X, Y, Z); with ``mask_camera`` (0/1) sum(ce * m) /
    max(sum(m), 1), else the mean."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, num_classes), dim=-1)
    labels = voxel_semantics.reshape(-1).long()
    ce = -logp.gather(1, labels[:, None])[:, 0]
    if mask_camera is not None:
        m = mask_camera.reshape(-1).to(ce.dtype)
        return (ce * m).sum() / m.sum().clamp_min(1.0)
    return ce.mean()


# ------------------------------------------------------------ the training step


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients, in place."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class AdamW:
    """torch.optim.AdamW's arithmetic written out: decoupled decay
    lr * wd * p, bias-corrected moments, eps outside the root."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.eps = list(params), lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + self.eps, value=-self.lr / bc1)


def ema_decay(t: int, decay: float = 0.9990, ramp: float = 2000.0) -> float:
    """The MEGVII ramp d(t) = decay * (1 - exp(-t / ramp)) in float32."""
    t32 = np.float32(t)
    return float(np.float32(decay) * (np.float32(1.0) - np.exp(-t32 / np.float32(ramp))))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, t: int,
               decay: float = 0.9990) -> None:
    """ema = d(t) ema + (1 - d(t)) state over the float state_dict, in place."""
    d = ema_decay(t, decay)
    one_minus = float(np.float32(1.0) - np.float32(d))
    state = model.state_dict()
    for k, v in ema.items():
        v.mul_(d).add_(state[k], alpha=one_minus)


MODEL_INPUTS = ("imgs", "sensor2ego", "cam2imgs", "post_rots", "post_trans", "bda")
PRIOR_INPUTS = ("prior_feats", "prior_coords", "prior_valid")


def train_step(model: nn.Module, opt: AdamW, ema: Dict[str, torch.Tensor], t: int,
               batch: Dict[str, torch.Tensor], grad_clip: float, ema_decay_: float,
               ieee: bool = True) -> float:
    """One step: train-mode forward, occ_loss, backward, a zero gradient
    where the graph did not reach, clipping, AdamW, the EMA's update ``t``.
    Returns the loss."""
    model.train()
    for p in model.parameters():
        p.grad = None
    priors = {k: batch[k] for k in PRIOR_INPUTS if k in batch}
    with ieee_convolutions(ieee):
        occ = model._forward(*[batch[k] for k in MODEL_INPUTS], *[priors.get(k) for k in
                             PRIOR_INPUTS], None, None, None, None)[0]
        loss = occ_loss(occ, batch["voxel_semantics"], batch.get("mask_camera"))
        loss.backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_(params, grad_clip)
    opt.step()
    ema_update(ema, model, t, ema_decay_)
    return float(loss.detach())
