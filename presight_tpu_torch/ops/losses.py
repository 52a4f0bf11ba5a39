"""PreSight supervision losses (presight_tpu/ops/losses.py).

Masked means over boolean-indexed tensors are sum(mask * x) / sum(mask),
as in JAX. Every clip of a value that carries a gradient is ``math.clip``,
which splits the gradient at a tie the way jnp.clip does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .math import clip, masked_mean

URF_SIGMA_SCALE_FACTOR = 3.0
EPS = 1e-7


def normalize_depth(depth: torch.Tensor, upper_bound: float = 75.0) -> torch.Tensor:
    return clip(depth / upper_bound, 0.0, 1.0)


def _gaussian_pdf(x: torch.Tensor, sigma) -> torch.Tensor:
    """exp(Normal(0, sigma).log_prob(x))."""
    return torch.exp(-0.5 * (x / sigma) ** 2) / (sigma * math.sqrt(2.0 * math.pi))


def line_of_sight_loss(weights: torch.Tensor, termination_depth: torch.Tensor,
                       steps: torch.Tensor, sigma: float,
                       sky_mask: Optional[torch.Tensor] = None,
                       upper_bound: float = 75.0) -> torch.Tensor:
    """Urban-Radiance-Fields line-of-sight loss: near the target depth the
    weights match a Gaussian of sigma / 3, before it they are pushed to
    zero. Mean over rays with valid depth (and not sky)."""
    depth_mask = (termination_depth > 1.0) & (termination_depth < upper_bound)
    if sky_mask is not None:
        depth_mask = depth_mask & (sky_mask == 0.0)
    steps = steps.detach()
    td = termination_depth[..., None]
    target_sigma = sigma / URF_SIGMA_SCALE_FACTOR
    near_mask = (steps <= td + sigma) & (steps >= td - sigma)
    near = (weights - _gaussian_pdf(steps - td, target_sigma)) ** 2
    near = torch.sum(near_mask * near, dim=-1)
    empty_mask = steps < td - sigma
    empty = torch.sum(empty_mask * weights ** 2, dim=-1)
    return masked_mean(near + empty, depth_mask)


def expected_depth_loss(termination_depth: torch.Tensor, predicted_depth: torch.Tensor,
                        upper_bound: float = 75.0) -> torch.Tensor:
    """MSE on normalised expected depth over valid lidar rays."""
    depth_mask = (termination_depth > 1.0) & (termination_depth < upper_bound)
    td = normalize_depth(termination_depth, upper_bound)
    pd = normalize_depth(predicted_depth, upper_bound)
    return masked_mean((td - pd) ** 2, depth_mask)


def expected_monodepth_loss(termination_depth: torch.Tensor, predicted_depth: torch.Tensor,
                            sky_mask: torch.Tensor, upper_bound: float = 50.0,
                            inverse: bool = False) -> torch.Tensor:
    """Monodepth variant, optionally on inverse depth."""
    depth_mask = ((termination_depth > 1.0) & (termination_depth < upper_bound)
                  & (sky_mask == 0.0))
    if inverse:
        td = 1.0 / (termination_depth + 5.0)
        pd = 1.0 / (predicted_depth + 5.0)
    else:
        td = normalize_depth(termination_depth, upper_bound)
        pd = normalize_depth(predicted_depth, upper_bound)
    return masked_mean((td - pd) ** 2, depth_mask)


def sky_loss(accumulation: torch.Tensor, sky_mask: torch.Tensor,
             eps: float = EPS) -> torch.Tensor:
    """BCE between the ray accumulation and 1 - sky."""
    target = 1.0 - sky_mask
    acc = clip(accumulation, eps, 1.0 - eps)
    loss = -(target * torch.log(acc) + (1.0 - target) * torch.log(1.0 - acc))
    return torch.mean(loss)


def semantic_loss(pred: torch.Tensor, target: torch.Tensor, clip_target: bool = True
                  ) -> torch.Tensor:
    """MSE against the (clipped) DINO feature targets."""
    if clip_target:
        target = clip(target, 0.0, 1.0)
    return torch.mean((pred - target) ** 2)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)
