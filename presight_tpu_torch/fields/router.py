"""Nearest-centroid expert routing (presight_tpu/fields/router.py), with
plain index operations: sort samples by expert (stable), then, for the
padded layout, lay them out in per-expert slabs padded to whole blocks of
the grouped MLP. Sorting and unsorting are ``x[order]`` and
``x[inverse]``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.mlp import _blocked_layout, block_offsets


class Routing(NamedTuple):
    order: torch.Tensor  # (N,) int32: sorted_x = x[order]
    inverse: torch.Tensor  # (N,) int32: x = sorted_x[inverse]
    group_sizes: torch.Tensor  # (E,) int32
    expert_ids_sorted: torch.Tensor  # (N,) int32


class PaddedRouting(NamedTuple):
    to_slot: torch.Tensor  # (n_pad,) int32: padded[s] = x[to_slot[s]]
    from_slot: torch.Tensor  # (N,) int32: x[i] lives at padded slot from_slot[i]
    slot_valid: torch.Tensor  # (n_pad,) bool, False on padding slots
    block_expert: torch.Tensor  # (n_pad // block,) int32
    expert_of_slot: torch.Tensor  # (n_pad,) int32
    group_sizes: torch.Tensor  # (E,) int32


def assign_experts(positions: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each position (N, 3) -> (N,) int32; the first
    index wins on ties, as jnp.argmin. The squared distance is summed
    x, y, z left to right, as JAX and K4 sum it: torch.sum over a size-3
    dim on CUDA adds (x + z) + y, which moves a sample near the bisector of
    two centroids to the other expert."""
    d = positions[:, None, :] - centroids[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return torch.argmin(d2, dim=-1).to(torch.int32)


def build_routing(expert_ids: torch.Tensor, num_experts: int) -> Routing:
    order = torch.argsort(expert_ids, stable=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    group_sizes = torch.bincount(expert_ids.long(), minlength=num_experts)
    return Routing(
        order=order.to(torch.int32),
        inverse=inverse.to(torch.int32),
        group_sizes=group_sizes.to(torch.int32),
        expert_ids_sorted=expert_ids[order],
    )


def route_positions(positions: torch.Tensor, centroids: torch.Tensor) -> Routing:
    """Sort by nearest expert, unpadded (the per-expert proposal fields)."""
    return build_routing(assign_experts(positions, centroids), centroids.shape[0])


def build_padded_routing(expert_ids: torch.Tensor, num_experts: int,
                         block: int) -> PaddedRouting:
    """Sort by expert composed with the block-padded slab layout."""
    routing = build_routing(expert_ids, num_experts)
    n = expert_ids.shape[0]
    _, src, slot_valid, block_expert, _ = _blocked_layout(routing.group_sizes, n, block)
    _, pad_offsets, orig_offsets = block_offsets(routing.group_sizes.long(), block)
    eids = expert_ids.long()
    from_slot = pad_offsets[eids] + routing.inverse.long() - orig_offsets[eids]
    return PaddedRouting(
        to_slot=routing.order[src.long()],
        from_slot=from_slot.to(torch.int32),
        slot_valid=slot_valid,
        block_expert=block_expert,
        expert_of_slot=torch.repeat_interleave(block_expert, block),
        group_sizes=routing.group_sizes,
    )


def route_positions_padded(positions: torch.Tensor, centroids: torch.Tensor,
                           block: int) -> PaddedRouting:
    return build_padded_routing(assign_experts(positions, centroids),
                                centroids.shape[0], block)


def pad_rows(x: torch.Tensor, routing: PaddedRouting) -> torch.Tensor:
    """x (N, ...) -> (n_pad, ...), zeros on padding slots."""
    y = x[routing.to_slot.long()]
    valid = routing.slot_valid.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 1))
    return y * valid


def unpad_rows(h: torch.Tensor, routing: PaddedRouting) -> torch.Tensor:
    """(n_pad, ...) -> (N, ...) in the original row order."""
    return h[routing.from_slot.long()]
