"""Pointwise math shared by fields and renderers (presight_tpu/ops/math.py).

The JAX package's ``searchsorted`` and ``take_batched`` are TPU
formulations of a batched binary search and a batched row take; here they
are ``torch.searchsorted`` and ``torch.gather``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Bound = Optional[Union[float, torch.Tensor]]


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with the backward g * exp(clamp(x, -15, 15)), so a large
    density logit cannot blow up its gradient."""
    return _TruncExp.apply(x)


def _bound(x: torch.Tensor, b: Union[float, torch.Tensor]) -> torch.Tensor:
    """A bound as a tensor of x's dtype on x's device; a number is filled
    in there, not copied from the host."""
    if isinstance(b, torch.Tensor):
        return b.to(dtype=x.dtype, device=x.device)
    return x.new_full((), b)


def clip(x: torch.Tensor, lo: Bound = None, hi: Bound = None) -> torch.Tensor:
    """jnp.clip as JAX differentiates it: min(max(x, lo), hi), so at a tie
    with a bound half the gradient goes to x (torch.clamp passes all of
    it). Use it wherever a clipped value carries a gradient."""
    if lo is not None:
        x = torch.maximum(x, _bound(x, lo))
    if hi is not None:
        x = torch.minimum(x, _bound(x, hi))
    return x


def masked_mean(values: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sum(mask * values) / sum(mask), mask broadcast against values: the
    shape-stable form of ``values[mask].mean()``."""
    mask_b = torch.broadcast_to(mask.to(values.dtype), values.shape)
    return torch.sum(values * mask_b) / torch.clamp(torch.sum(mask_b), min=eps)


def contract_linf(x: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 contraction with the L-inf norm: x inside the unit cube,
    (2 - 1/|x|) x/|x| outside."""
    mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    safe_mag = torch.clamp(mag, min=1e-12)
    contracted = (2.0 - 1.0 / safe_mag) * (x / safe_mag)
    return torch.where(mag < 1.0, x, contracted)


def normalize_aabb(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World positions -> the AABB frame in [-1, 1]; aabb (..., 2, 3)."""
    aabb_min = aabb[..., 0, :]
    aabb_max = aabb[..., 1, :]
    positions = (positions - aabb_min) / (aabb_max - aabb_min)
    return positions * 2.0 - 1.0


def contract_positions(positions: torch.Tensor, aabb: torch.Tensor):
    """AABB-normalise, contract, map [-2, 2] to [0, 1]; zero the coordinates
    outside (0, 1). Returns (unit positions, selector (...,) bool)."""
    positions = normalize_aabb(positions, aabb)
    positions = contract_linf(positions)
    positions = (positions + 2.0) / 4.0
    selector = torch.all((positions > 0.0) & (positions < 1.0), dim=-1)
    positions = positions * selector[..., None]
    return positions, selector


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis up to ``levels`` (levels**2 values) of
    unit directions (tiny-cuda-nn's deployed semantics)."""
    if not 1 <= levels <= 4:
        raise ValueError(f"SH levels must be in [1, 4], got {levels}")
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z

    comps = [torch.full(x.shape, 0.28209479177387814, dtype=directions.dtype,
                        device=directions.device)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    return torch.stack(comps, dim=-1)
