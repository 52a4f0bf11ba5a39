"""Layers of the stage-3 port that keep flax.linen's arithmetic.

The port runs NCHW / NCDHW, and each layer's parameters carry the flax
auto-name of the layer they stand for (``Conv_0``, ``BatchNorm_1``,
``Dense_0``, ...), set by the module that holds them in flax's call order:
so ``bridge.occ_state_from_flax`` maps a flax tree onto a state_dict by
name alone.

* :class:`Conv` is ``flax.linen.Conv``: padding "SAME" is flax's rule,
  ``pad_total = max((ceil(n / s) - 1) * s + k - n, 0)`` split as
  ``(pad_total // 2, pad_total - pad_total // 2)``, so a stride-2 3x3 conv
  on an even size pads (0, 1), not (1, 1) (``nn.Conv2d(padding=1)`` would
  shift every strided feature by one pixel).
* :class:`BatchNorm` is ``flax.linen.BatchNorm`` (epsilon 1e-5, momentum
  0.99): in eval mode it normalises with the running statistics; in train
  mode with the batch's mean and biased variance, and updates the running
  statistics as flax's ``mutable=["batch_stats"]`` result does.
* :class:`Dense` is ``flax.linen.Dense``; its weight is stored (out, in) as
  ``nn.Linear``'s.

No layer draws random numbers: parameters are made with ``torch.empty`` and
filled by :func:`init_weights` from a ``torch.Generator`` (or by the bridge).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]


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

    def pads(self, spatial: Sequence[int]) -> List[Tuple[int, int]]:
        """(low, high) padding of each spatial dimension of an input of
        these sizes."""
        if self.padding == "SAME":
            return [same_pads(n, k, self.stride) for n, k in zip(spatial, self.kernel)]
        if self.padding == "VALID":
            return [(0, 0)] * len(self.kernel)
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = len(self.kernel)
        pads = self.pads(x.shape[2:])
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


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (a CPU generator, so a seed gives
    the same weights on every device), in flax's default distributions:
    conv and dense kernels normal with variance 1 / fan_in (LeCun), biases
    0, BatchNorm scale 1, bias 0, running mean 0 and variance 1. Modules
    are visited in registration order."""
    for sub in module.modules():
        if isinstance(sub, (Conv, Dense)):
            w = sub.weight
            fan_in = math.prod(w.shape[1:])
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, BatchNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
            sub.running_mean.zero_()
            sub.running_var.fill_(1.0)
    return module
