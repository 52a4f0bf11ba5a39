"""Proposal density fields and the cached proposal grid
(presight_tpu/fields/prop_field.py).

Two proposal MLP layouts, as in JAX: per-expert MLPs (the reference's,
stacked (E, in, out)), evaluated on samples sorted by expert through the
grouped K2 (``prop_density_sorted``); or one MLP shared by all experts
(``shared_mlp``, the -tpu profile), evaluated without a sort. The -tpu
profile's first round reads a per-expert dense grid of cell rows that
``refresh_prop_grid`` builds from the fine proposal field.
``prop_grid_density`` is the wrapper of kernel K4 (csrc/prop_grid.cu): it
launches the kernel, or runs ``prop_grid_density_plain`` where
``kernels.use_plain`` says so (CPU tensors).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import kernels
from ..configs import PropFieldConfig
from ..ops.hash_encoding import _CORNER_BITS, hash_encode, init_hash_table, trilerp_weights
from ..ops.math import contract_positions, trunc_exp
from ..ops.mlp import apply_mlp, apply_mlp_grouped, init_mlp
from .router import Routing, assign_experts, route_positions


def init_prop_field(generator: torch.Generator, config: PropFieldConfig, num_experts: int,
                    aabbs: torch.Tensor, centroids: torch.Tensor) -> Dict:
    return {
        "hash_table": init_hash_table(generator, config.hash, num_experts),
        "mlp": init_mlp(generator, config.hash.out_dim, config.num_layers,
                        config.hidden_dim, 1, num_experts=0 if config.shared_mlp else num_experts),
        "aabbs": aabbs.clone(),
        "centroids": centroids.clone(),
    }


def prop_density_sorted(params: Dict, config: PropFieldConfig, positions_sorted: torch.Tensor,
                        routing: Routing) -> torch.Tensor:
    """Density of positions sorted by expert, with per-expert MLPs: contract
    in each sample's AABB, hash-encode with expert ids (K1), grouped MLP
    (K2)."""
    if config.shared_mlp:
        raise ValueError("prop_density_sorted takes per-expert MLPs; a shared MLP goes "
                         "through prop_density without a sort")
    e = routing.expert_ids_sorted
    unit, selector = contract_positions(positions_sorted, params["aabbs"][e.long()])
    feats = hash_encode(params["hash_table"], unit.contiguous(), config.hash, expert_ids=e)
    logit = apply_mlp_grouped(params["mlp"], feats, routing.group_sizes)[..., 0]
    return trunc_exp(logit) * selector


def prop_density(params: Dict, config: PropFieldConfig, positions: torch.Tensor) -> torch.Tensor:
    """Density of the proposal field at world positions (..., 3), routed to
    the nearest expert. A shared MLP needs no sort: contract in the
    expert's AABB, hash-encode with the expert mixed into the hash, one MLP.
    Per-expert MLPs sort the samples by expert and unsort the densities."""
    shape = positions.shape[:-1]
    flat = positions.reshape(-1, 3)
    if config.shared_mlp:
        eids = assign_experts(flat, params["centroids"])
        unit, selector = contract_positions(flat, params["aabbs"][eids.long()])
        feats = hash_encode(params["hash_table"], unit.contiguous(), config.hash,
                            expert_ids=eids)
        logit = apply_mlp(params["mlp"], feats)[..., 0]
        return (trunc_exp(logit) * selector).reshape(shape)
    routing = route_positions(flat, params["centroids"])
    dens = prop_density_sorted(params, config, flat[routing.order.long()], routing)
    return dens[routing.inverse.long()].reshape(shape)


def prop_grid_cells(corner_density: torch.Tensor) -> torch.Tensor:
    """(E, G+1, G+1, G+1) corner densities -> (E * G^3, 8) cell rows in
    _CORNER_BITS order."""
    e = corner_density.shape[0]
    g = corner_density.shape[1] - 1
    cols = [corner_density[:, bx:bx + g, by:by + g, bz:bz + g] for bx, by, bz in _CORNER_BITS]
    return torch.stack(cols, dim=-1).reshape(e * g * g * g, 8)


def refresh_prop_grid(params: Dict, config: PropFieldConfig, res: int,
                      num_experts: int) -> torch.Tensor:
    """Evaluate the proposal field on every grid corner of every expert, in
    contracted unit coordinates, and pack cell rows. The upper face is
    evaluated at 1 - 2^-12: a coordinate of exactly 1.0 would read the
    out-of-domain cell's rows, which no sample ever reaches."""
    device = params["mlp"][0][0].device
    n = (res + 1) ** 3
    lin = torch.arange(res + 1, dtype=torch.float32, device=device) / float(res)
    lin = torch.clamp(lin, max=1.0 - 2.0 ** -12)
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(n, 3).contiguous()
    corners = []
    for e in range(num_experts):
        eids = torch.full((n,), e, dtype=torch.int32, device=device)
        feats = hash_encode(params["hash_table"], pts, config.hash, expert_ids=eids)
        mlp = params["mlp"] if config.shared_mlp else [(w[e], b[e]) for w, b in params["mlp"]]
        corners.append(trunc_exp(apply_mlp(mlp, feats)[..., 0]))
    corners = torch.stack(corners).reshape(num_experts, res + 1, res + 1, res + 1)
    return prop_grid_cells(corners)


def prop_grid_density_plain(grid_cells: torch.Tensor, centroids: torch.Tensor,
                            aabbs: torch.Tensor, positions: torch.Tensor,
                            res: int) -> torch.Tensor:
    """Plain version of K4: route, contract, one cell-row gather, trilerp."""
    shape = positions.shape[:-1]
    flat = positions.reshape(-1, 3)
    eids = assign_experts(flat, centroids).long()
    unit, selector = contract_positions(flat, aabbs[eids])
    scaled = unit * res
    fl = torch.clamp(torch.floor(scaled), 0.0, res - 1)
    offset = torch.clamp(scaled - fl, 0.0, 1.0)
    cell = fl.to(torch.int64)
    cidx = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    rows = grid_cells[eids * (res * res * res) + cidx]
    dens = torch.sum(rows * trilerp_weights(offset), dim=-1)
    return (dens * selector).reshape(shape)


def prop_grid_density(grid_cells: torch.Tensor, centroids: torch.Tensor, aabbs: torch.Tensor,
                      positions: torch.Tensor, res: int) -> torch.Tensor:
    """Wrapper of K4: density of the cached grid at world positions (..., 3)."""
    if kernels.use_plain(positions):
        return prop_grid_density_plain(grid_cells, centroids, aabbs, positions, res)
    shape = positions.shape[:-1]
    flat = positions.reshape(-1, 3)
    e = centroids.shape[0]
    if (centroids.shape != (e, 3) or aabbs.shape != (e, 2, 3)
            or grid_cells.shape != (e * res ** 3, 8)):
        raise ValueError("prop_grid_density: centroids (E, 3), aabbs (E, 2, 3) and "
                         "grid (E * G^3, 8) do not agree")
    for t in (flat, centroids, aabbs, grid_cells):
        if t.dtype != torch.float32:
            raise TypeError("prop_grid_density: expected float32 inputs")
    kernels.require_cuda("prop_grid_density", flat, centroids, aabbs, grid_cells)
    out = torch.empty((flat.shape[0],), dtype=torch.float32, device=flat.device)
    kernels.launch("prop_grid_density_fwd", flat.data_ptr(), centroids.data_ptr(),
                   aabbs.data_ptr(), grid_cells.data_ptr(), flat.shape[0], e, res,
                   out.data_ptr())
    return out.reshape(shape)
