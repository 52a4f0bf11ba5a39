"""Direction-only sky field stacked over experts
(presight_tpu/fields/sky_field.py). Rays are routed on their origins; the
heads run through K2 on the rays' padded routing layout."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import SkyFieldConfig
from ..ops.math import sh_encoding
from ..ops.mlp import apply_mlp_blocks, init_mlp
from .router import PaddedRouting


def init_sky_field(generator: torch.Generator, config: SkyFieldConfig, num_experts: int,
                   centroids: torch.Tensor) -> Dict:
    params = {
        "rgb_head": init_mlp(generator, 16 + config.appearance_embedding_dim,
                             config.mlp_num_layers, config.mlp_layer_width, 3, num_experts),
        "centroids": centroids.clone(),
    }
    if config.use_semantics:
        params["semantic_head"] = init_mlp(generator, 16, config.mlp_num_layers,
                                           config.mlp_layer_width, config.semantic_dim,
                                           num_experts)
    return params


def sky_outputs_sorted(params: Dict, config: SkyFieldConfig, directions_padded: torch.Tensor,
                       appearance_padded: Optional[torch.Tensor], routing: PaddedRouting,
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-ray sky RGB (+ semantics) for rays in their padded routing slots
    (the JAX version takes rays sorted by expert; the padded layout is that
    order cut into per-expert blocks)."""
    d_enc = sh_encoding(directions_padded, levels=4)
    rgb_in = d_enc if appearance_padded is None else torch.cat([d_enc, appearance_padded], -1)
    rgb = apply_mlp_blocks(params["rgb_head"], rgb_in, routing.block_expert, sigmoid=True)
    semantics = None
    if config.use_semantics:
        semantics = apply_mlp_blocks(params["semantic_head"], d_enc, routing.block_expert)
    return rgb, semantics
