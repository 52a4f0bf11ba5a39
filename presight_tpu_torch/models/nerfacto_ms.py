"""NerfactoNuscMS, the PreSight city-tile NeRF, for serving
(presight_tpu/models/nerfacto_ms.py).

The functions take the parameter tree (the JAX package's layout: dicts,
lists of per-level tables, lists of (W (E, in, out), b (E, out)) layers)
and mirror the JAX functions of the same names. ``NerfactoNuscMS`` holds
the tree as an ``nn.Module`` so that ``.to(device)`` and ``state_dict``
work, and exposes the serving entry points.

Served here: the -tpu profile -- cached-grid first proposal round,
proposal MLP shared by all experts, 'shared' hash storage (the other
storages run too) -- in eval mode. Training, the per-expert proposal MLPs
and the hash-field first round raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..bridge import _map
from ..configs import NerfactoNuscMSConfig
from ..fields.ingp_field import (
    density_and_embedding_padded,
    init_ingp_field,
    rgb_padded,
    semantics_padded,
)
from ..fields.prop_field import init_prop_field, prop_density, prop_grid_density, refresh_prop_grid
from ..fields.router import (
    assign_experts,
    build_padded_routing,
    pad_rows,
    route_positions_padded,
    unpad_rows,
)
from ..fields.sky_field import init_sky_field, sky_outputs_sorted
from ..ops.mlp import GROUP_BLOCK
from ..ops.rays import RayBundle
from ..ops.renderers import volume_render
from ..ops.samplers import proposal_sample


def _check_served(config: NerfactoNuscMSConfig) -> None:
    if not config.use_prop_grid:
        raise NotImplementedError(
            "the hash-field first proposal round (prop_grid_res=0) is not ported yet")
    if not config.prop_shared_mlp:
        raise NotImplementedError(
            "per-expert proposal MLPs (prop_shared_mlp=False) are not ported yet")


def init_params(generator: torch.Generator, config: NerfactoNuscMSConfig, aabbs, centroids,
                num_train_cameras: int, num_train_videos: int) -> Dict:
    """The parameter tree with init_model's shapes and torch's default
    inits, drawn from ``generator`` (the values differ from JAX's)."""
    _check_served(config)
    aabbs = torch.as_tensor(aabbs, dtype=torch.float32)
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    num_experts = int(aabbs.shape[0])
    prop_rounds = list(range(1, config.num_proposal_iterations))
    if config.use_same_proposal_network:
        prop_rounds = prop_rounds[:1]
    params = {
        "field": init_ingp_field(generator, config.field, num_experts, aabbs, centroids),
        "props": [init_prop_field(generator, config.prop(i), num_experts, aabbs, centroids)
                  for i in prop_rounds],
    }
    if config.use_sky_model:
        params["sky"] = init_sky_field(generator, config.sky, num_experts, centroids)
    if config.appearance_embed_dim > 0:
        params["appearance_embedding"] = torch.randn(
            (num_train_cameras, config.appearance_embed_dim), generator=generator)
    if config.video_embed_dim > 0:
        params["video_embedding"] = torch.randn(
            (num_train_videos, config.video_embed_dim), generator=generator)
    return params


def apply_collider(bundle: RayBundle, config: NerfactoNuscMSConfig) -> RayBundle:
    """Constant near and far planes."""
    n = bundle.num_rays
    kw = dict(dtype=bundle.origins.dtype, device=bundle.origins.device)
    return bundle.replace(nears=torch.full((n,), config.near_plane, **kw),
                          fars=torch.full((n,), config.far_plane, **kw))


def _embed_appearance(params: Dict, config: NerfactoNuscMSConfig,
                      num_rays: int) -> Optional[torch.Tensor]:
    """Eval-mode appearance: the mean camera and video embeddings."""
    if config.appearance_dim == 0:
        return None
    parts = []
    for key, dim in (("appearance_embedding", config.appearance_embed_dim),
                     ("video_embedding", config.video_embed_dim)):
        if dim > 0:
            emb = params[key]
            parts.append(emb.mean(dim=0).expand(num_rays, emb.shape[-1]))
    return torch.cat(parts, dim=-1)


def _density_fns(params: Dict, config: NerfactoNuscMSConfig,
                 prop_grid: Optional[torch.Tensor]):
    """Round 0 reads the cached grid; round i >= 1 the fine proposal field
    (props[0] when the proposal network is shared across rounds)."""
    _check_served(config)
    if prop_grid is None:
        raise ValueError("config.prop_grid_res > 0 requires the cached grid "
                         "(prop_grid=make_prop_grid(...))")
    buffers = params["props"][0] if params["props"] else params["field"]

    def grid_fn(positions):
        return prop_grid_density(prop_grid, buffers["centroids"], buffers["aabbs"],
                                 positions.contiguous(), config.prop_grid_res)

    def field_fn(i):
        cfg_idx, list_idx = (1, 0) if config.use_same_proposal_network else (i, i - 1)
        return lambda positions: prop_density(params["props"][list_idx], config.prop(cfg_idx),
                                              positions)

    return [grid_fn] + [field_fn(i) for i in range(1, config.num_proposal_iterations)]


def _field_heads_padded(params: Dict, config: NerfactoNuscMSConfig, flat: torch.Tensor):
    routing = route_positions_padded(flat, params["field"]["centroids"], GROUP_BLOCK)
    density_p, geo_p, sem_p = density_and_embedding_padded(
        params["field"], config.field, pad_rows(flat, routing), routing)
    return density_p, geo_p, sem_p, routing


def forward(params: Dict, config: NerfactoNuscMSConfig, bundle: RayBundle,
            train: bool = False, prop_grid: Optional[torch.Tensor] = None) -> Dict:
    """Eval-mode forward: proposal sampling, main field on the padded
    routing layout, one K3 pass for weights, depths and the rgb+semantics
    composite, sky blending."""
    if train:
        raise NotImplementedError("training is not ported yet")
    bundle = apply_collider(bundle, config)
    ray_samples, weights_list, ray_samples_list = proposal_sample(
        bundle, _density_fns(params, config, prop_grid),
        config.num_proposal_samples_per_ray, config.num_nerf_samples_per_ray,
        config.spacing)
    # The cached-grid round is dropped from the loss lists, as in JAX.
    weights_list, ray_samples_list = weights_list[1:], ray_samples_list[1:]

    num_rays, num_samples = ray_samples.starts.shape
    positions = ray_samples.positions().reshape(-1, 3)
    fcfg = config.field
    app = _embed_appearance(params, config, num_rays)

    density_p, geo_p, sem_p, routing = _field_heads_padded(params, config, positions)
    ray_of_slot = routing.to_slot.long() // num_samples
    ray_inputs = bundle.directions if app is None else torch.cat([bundle.directions, app], -1)
    inputs_p = ray_inputs[ray_of_slot]
    app_p = None if app is None else inputs_p[:, 3:]
    rgb_p = rgb_padded(params["field"], fcfg, inputs_p[:, :3], geo_p, app_p, routing)
    payload = rgb_p
    if fcfg.use_semantics:
        payload = torch.cat([rgb_p, semantics_padded(params["field"], fcfg, sem_p, routing)], -1)
    density = unpad_rows(density_p, routing).reshape(num_rays, num_samples)
    render = volume_render(ray_samples.deltas().contiguous(), density.contiguous(),
                           ray_samples.steps().contiguous(), payload.contiguous(),
                           routing.from_slot)
    weights = render["weights"]
    rgb = render["composite"][:, :3]
    semantics = render["composite"][:, 3:] if fcfg.use_semantics else None
    accumulation = torch.clamp(render["accumulation"], 0.0, 1.0)

    outputs: Dict = {}
    if config.use_sky_model:
        sky = params["sky"]
        sky_routing = build_padded_routing(
            assign_experts(bundle.origins, sky["centroids"]), sky["centroids"].shape[0],
            GROUP_BLOCK)
        sky_rgb_p, sky_sem_p = sky_outputs_sorted(
            sky, config.sky, pad_rows(bundle.directions, sky_routing),
            None if app is None else pad_rows(app, sky_routing), sky_routing)
        rgb = rgb + (1.0 - accumulation)[:, None] * unpad_rows(sky_rgb_p, sky_routing)
        if sky_sem_p is not None:
            outputs["sky_semantics"] = unpad_rows(sky_sem_p, sky_routing)

    outputs.update(rgb=rgb, accumulation=accumulation, depth=render["depth"],
                   expected_depth=render["expected_depth"])
    if config.use_semantics:
        if "sky_semantics" in outputs:
            semantics = semantics + (1.0 - accumulation)[:, None] * outputs["sky_semantics"]
        outputs["semantics"] = semantics
    outputs["weights_list"] = weights_list + [weights]
    outputs["ray_samples_list"] = ray_samples_list + [ray_samples]
    return outputs


def make_prop_grid(params: Dict, config: NerfactoNuscMSConfig) -> Optional[torch.Tensor]:
    """The cached round-0 density grid, refreshed from the fine proposal
    field; None when the config does not use it."""
    if not config.use_prop_grid:
        return None
    if not params["props"]:
        raise ValueError("use_prop_grid requires a fine proposal field "
                         "(num_proposal_iterations >= 2)")
    num_experts = params["field"]["centroids"].shape[0]
    return refresh_prop_grid(params["props"][0], config.prop(1), config.prop_grid_res,
                             num_experts)


def forward_depth(params: Dict, config: NerfactoNuscMSConfig, bundle: RayBundle,
                  threshold: float = 0.5,
                  prop_grid: Optional[torch.Tensor] = None) -> Dict:
    """Density-only inference of prior extraction: proposal sampling,
    main-field density, median and expected depth."""
    bundle = apply_collider(bundle, config)
    ray_samples, _, _ = proposal_sample(
        bundle, _density_fns(params, config, prop_grid),
        config.num_proposal_samples_per_ray, config.num_nerf_samples_per_ray,
        config.spacing)
    num_rays, num_samples = ray_samples.starts.shape
    flat = ray_samples.positions().reshape(-1, 3)
    density_p, _, _, routing = _field_heads_padded(params, config, flat)
    density = unpad_rows(density_p, routing).reshape(num_rays, num_samples)
    render = volume_render(ray_samples.deltas().contiguous(), density.contiguous(),
                           ray_samples.steps().contiguous(), threshold=threshold)
    return {"depth": render["depth"], "expected_depth": render["expected_depth"]}


def point_queries(params: Dict, config: NerfactoNuscMSConfig, positions: torch.Tensor,
                  prop_grid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean density over (main field + every proposal round) and
    [0, 1]-clipped semantic features at world positions, sharing one main
    field routing."""
    shape = positions.shape[:-1]
    flat = positions.reshape(-1, 3)
    density_p, _, sem_p, routing = _field_heads_padded(params, config, flat)
    sem_p = semantics_padded(params["field"], config.field, sem_p, routing)
    densities: List[torch.Tensor] = [unpad_rows(density_p, routing)]
    for fn in _density_fns(params, config, prop_grid):
        densities.append(fn(flat))
    mean_density = sum(densities) / len(densities)
    feats = torch.clamp(unpad_rows(sem_p, routing), 0.0, 1.0)
    return mean_density.reshape(shape), feats.reshape(*shape, -1)


class NerfactoNuscMS(nn.Module):
    """The model's parameter tree as an nn.Module, with the serving entry
    points. ``params()`` rebuilds the JAX-layout tree from the registered
    tensors; ``bridge.from_jax_params`` gives a tree to start from."""

    def __init__(self, config: NerfactoNuscMSConfig, params: Dict):
        super().__init__()
        _check_served(config)
        self.config = config
        leaves: List[torch.Tensor] = []

        def index(t):
            leaves.append(t)
            return len(leaves) - 1

        self._skeleton = _map(params, index)
        self.leaves = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(t, dtype=torch.float32), requires_grad=False)
             for t in leaves])

    def params(self) -> Dict:
        return _map(self._skeleton, lambda i: self.leaves[i])

    @torch.no_grad()
    def forward(self, bundle: RayBundle, train: bool = False,
                prop_grid: Optional[torch.Tensor] = None) -> Dict:
        return forward(self.params(), self.config, bundle, train=train, prop_grid=prop_grid)

    @torch.no_grad()
    def forward_depth(self, bundle: RayBundle, threshold: float = 0.5,
                      prop_grid: Optional[torch.Tensor] = None) -> Dict:
        return forward_depth(self.params(), self.config, bundle, threshold, prop_grid)

    @torch.no_grad()
    def point_queries(self, positions: torch.Tensor,
                      prop_grid: Optional[torch.Tensor] = None):
        return point_queries(self.params(), self.config, positions, prop_grid)

    @torch.no_grad()
    def make_prop_grid(self) -> Optional[torch.Tensor]:
        return make_prop_grid(self.params(), self.config)


def init_model(generator: torch.Generator, config: NerfactoNuscMSConfig, aabbs, centroids,
               num_train_cameras: int, num_train_videos: int) -> NerfactoNuscMS:
    """A randomly initialised model (init_model's shapes) on the CPU."""
    return NerfactoNuscMS(config, init_params(generator, config, aabbs, centroids,
                                              num_train_cameras, num_train_videos))
