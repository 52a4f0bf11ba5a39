"""Image and BEV backbones of BEVDet-Occ: ResNet + CustomFPN (2D) and
CustomResNet3D + LSSFPN3D (3D), the port of presight_tpu/occupancy/
backbones.py over NCHW / NCDHW tensors.

Reference specs (as the JAX module's): torchvision-style ResNet ('pytorch'
style, 7x7/2 stem + 3x3/2 max-pool, Bottleneck for depth >= 50) with
out_indices (0, 2, 3); CustomFPN (lateral 1x1 convs, nearest top-down sum,
3x3 output convs on ``out_ids``); CustomResNet3D (BasicBlock3D chains);
LSSFPN3D (trilinear x2/x4 with align_corners=True, concat, 1x1x1 conv).
Submodules carry flax's auto-names in flax's call order (models/layers.py), and
every strided conv pads by flax's "SAME" rule.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm, Conv


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
