"""The main iNGP radiance/semantic field stacked over experts
(presight_tpu/fields/ingp_field.py), on the padded routing layout: hash
encoding (K1) and every MLP head (K2) run over block-padded slots, and
results stay in those slots for the other heads."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import INGPFieldConfig
from ..ops.hash_encoding import hash_encode, init_hash_table
from ..ops.math import contract_positions, sh_encoding, trunc_exp
from ..ops.mlp import apply_mlp_blocks, init_mlp
from .router import PaddedRouting


def init_ingp_field(generator: torch.Generator, config: INGPFieldConfig, num_experts: int,
                    aabbs: torch.Tensor, centroids: torch.Tensor) -> Dict:
    params = {
        "hash_table": init_hash_table(generator, config.hash, num_experts),
        "base_mlp": init_mlp(generator, config.hash.out_dim, config.num_layers,
                             config.hidden_dim, config.base_out_dim, num_experts),
        "rgb_head": init_mlp(generator, 16 + config.geo_feat_dim + config.appearance_embedding_dim,
                             config.num_layers_color, config.hidden_dim_color, 3, num_experts),
        "aabbs": aabbs.clone(),
        "centroids": centroids.clone(),
    }
    if config.use_semantics:
        params["semantic_head"] = init_mlp(generator, config.semantic_dim, 3,
                                           config.hidden_dim_semantic_head,
                                           config.semantic_dim, num_experts)
    return params


def density_and_embedding_padded(
    params: Dict, config: INGPFieldConfig, positions_padded: torch.Tensor,
    routing: PaddedRouting,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AABB-normalise, contract, hash-encode, base MLP; split the density
    logit from the geometry and semantic embeddings. Returns (density
    (n_pad,), geo (n_pad, 15), semantic embedding (n_pad, sem))."""
    e = routing.expert_of_slot
    aabb = params["aabbs"][e.long()]
    unit, selector = contract_positions(positions_padded, aabb)
    feats = hash_encode(params["hash_table"], unit.contiguous(), config.hash, expert_ids=e)
    h = apply_mlp_blocks(params["base_mlp"], feats, routing.block_expert)
    density = trunc_exp(h[..., 0]) * selector
    geo_feat = h[..., 1:1 + config.geo_feat_dim]
    sem_feat = h[..., 1 + config.geo_feat_dim:]
    return density, geo_feat, sem_feat


def rgb_padded(params: Dict, config: INGPFieldConfig, directions_padded: torch.Tensor,
               geo_feat_padded: torch.Tensor, appearance_padded: Optional[torch.Tensor],
               routing: PaddedRouting) -> torch.Tensor:
    """RGB head: SH(4) of the direction, geometry features and appearance
    embedding -> 3-layer MLP -> sigmoid."""
    parts = [sh_encoding(directions_padded, levels=4), geo_feat_padded]
    if appearance_padded is not None:
        parts.append(appearance_padded)
    h = torch.cat(parts, dim=-1)
    return apply_mlp_blocks(params["rgb_head"], h, routing.block_expert, sigmoid=True)


def semantics_padded(params: Dict, config: INGPFieldConfig, sem_feat_padded: torch.Tensor,
                     routing: PaddedRouting) -> torch.Tensor:
    return apply_mlp_blocks(params["semantic_head"], sem_feat_padded.contiguous(),
                            routing.block_expert)
