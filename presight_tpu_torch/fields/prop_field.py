"""Proposal density fields and the cached proposal grid
(presight_tpu/fields/prop_field.py).

The port serves the -tpu profile's proposal path: one MLP shared by all
experts (``shared_mlp``), and a first round read from a per-expert dense
grid of cell rows that ``refresh_prop_grid`` builds from the fine proposal
field. ``prop_grid_density`` is the wrapper of kernel K4
(csrc/prop_grid.cu): on CUDA tensors it launches the kernel, on CPU tensors
it runs ``prop_grid_density_plain``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import kernels
from ..configs import PropFieldConfig
from ..ops.hash_encoding import _CORNER_BITS, hash_encode, init_hash_table, trilerp_weights
from ..ops.math import contract_positions, trunc_exp
from ..ops.mlp import apply_mlp, init_mlp
from .router import assign_experts


def _require_shared_mlp(config: PropFieldConfig) -> None:
    if not config.shared_mlp:
        raise NotImplementedError(
            "per-expert proposal MLPs (prop_shared_mlp=False) are not ported yet")


def init_prop_field(generator: torch.Generator, config: PropFieldConfig, num_experts: int,
                    aabbs: torch.Tensor, centroids: torch.Tensor) -> Dict:
    _require_shared_mlp(config)
    return {
        "hash_table": init_hash_table(generator, config.hash, num_experts),
        "mlp": init_mlp(generator, config.hash.out_dim, config.num_layers,
                        config.hidden_dim, 1, num_experts=0),
        "aabbs": aabbs.clone(),
        "centroids": centroids.clone(),
    }


def prop_density(params: Dict, config: PropFieldConfig, positions: torch.Tensor) -> torch.Tensor:
    """Density of the proposal field at world positions (..., 3): route to
    the nearest expert, contract in its AABB, hash-encode with the expert
    mixed into the hash, shared MLP."""
    _require_shared_mlp(config)
    shape = positions.shape[:-1]
    flat = positions.reshape(-1, 3)
    eids = assign_experts(flat, params["centroids"])
    unit, selector = contract_positions(flat, params["aabbs"][eids.long()])
    feats = hash_encode(params["hash_table"], unit.contiguous(), config.hash, expert_ids=eids)
    logit = apply_mlp(params["mlp"], feats)[..., 0]
    return (trunc_exp(logit) * selector).reshape(shape)


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
    _require_shared_mlp(config)
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
        corners.append(trunc_exp(apply_mlp(params["mlp"], feats)[..., 0]))
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
    if positions.device.type == "cpu":
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
    code = kernels.lib().prop_grid_density_fwd(
        flat.data_ptr(), centroids.data_ptr(), aabbs.data_ptr(), grid_cells.data_ptr(),
        flat.shape[0], e, res, out.data_ptr(), kernels.stream())
    kernels.check("prop_grid_density_fwd", code)
    kernels.LAUNCHES["prop_grid_density_fwd"] += 1
    return out.reshape(shape)
