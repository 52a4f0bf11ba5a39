"""NerfactoNuscMS, the PreSight city-tile NeRF
(presight_tpu/models/nerfacto_ms.py).

The functions take the parameter tree (the JAX package's layout: dicts,
lists of per-level tables, lists of (W (E, in, out), b (E, out)) layers)
and mirror the JAX functions of the same names: the forward pass in train
and eval mode, the losses, the optimizer groups and the host-side
schedules. ``NerfactoNuscMS`` holds the tree as an ``nn.Module`` (trainable
leaves with ``requires_grad``, the aabb and centroid buffers frozen) and
exposes the entry points; the serving ones run under ``torch.no_grad``.

Both architectures run: the reference's (a hash-field first proposal
round, per-expert proposal MLPs, 'corner' hash storage; the JAX package's
defaults) and the -tpu profile's (a cached-grid first round, one proposal
MLP shared by all experts, 'shared' storage), and any mix of the two.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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
from ..ops import losses as L
from ..ops.math import clip
from ..ops.mlp import GROUP_BLOCK
from ..ops.rays import RayBundle, RaySamples
from ..ops.renderers import volume_render
from ..ops.samplers import proposal_sample
from ..ops.stepfun import distortion_loss, interlevel_loss, z_anti_aliasing_interlevel_loss


def init_params(generator: torch.Generator, config: NerfactoNuscMSConfig, aabbs, centroids,
                num_train_cameras: int, num_train_videos: int) -> Dict:
    """The parameter tree with init_model's shapes and torch's default
    inits, drawn from ``generator`` (the values differ from JAX's). With the
    cached grid, round 0 has no parameters and props[j] backs round j + 1."""
    aabbs = torch.as_tensor(aabbs, dtype=torch.float32)
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    num_experts = int(aabbs.shape[0])
    prop_rounds = list(range(1 if config.use_prop_grid else 0, config.num_proposal_iterations))
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


def _embed_appearance(params: Dict, config: NerfactoNuscMSConfig, bundle: RayBundle,
                      train: bool) -> Optional[torch.Tensor]:
    """Per-ray appearance: train gathers the camera and video embeddings by
    the rays' indices, eval takes their means."""
    if config.appearance_dim == 0:
        return None
    parts = []
    for key, dim, index in (("appearance_embedding", config.appearance_embed_dim,
                             bundle.camera_indices),
                            ("video_embedding", config.video_embed_dim, bundle.video_ids)):
        if dim > 0:
            emb = params[key]
            if train:
                parts.append(emb[index.long()])
            else:
                parts.append(emb.mean(dim=0).expand(bundle.num_rays, emb.shape[-1]))
    return torch.cat(parts, dim=-1)


def _density_fns(params: Dict, config: NerfactoNuscMSConfig,
                 prop_grid: Optional[torch.Tensor]):
    """One density function per proposal round. With the cached grid, round
    0 reads the grid and round i >= 1 the proposal field props[i - 1];
    without it, round i reads props[i]. A proposal network shared across
    rounds is props[0] in every field round, with the first field round's
    config."""
    first_round = 1 if config.use_prop_grid else 0

    def field_fn(i):
        cfg_idx, list_idx = ((first_round, 0) if config.use_same_proposal_network
                             else (i, i - first_round))
        return lambda positions: prop_density(params["props"][list_idx], config.prop(cfg_idx),
                                              positions)

    fns = [field_fn(i) for i in range(first_round, config.num_proposal_iterations)]
    if config.use_prop_grid:
        if prop_grid is None:
            raise ValueError("config.prop_grid_res > 0 requires the cached grid "
                             "(prop_grid=make_prop_grid(...))")
        buffers = params["props"][0] if params["props"] else params["field"]

        def grid_fn(positions):
            return prop_grid_density(prop_grid, buffers["centroids"], buffers["aabbs"],
                                     positions.contiguous(), config.prop_grid_res)

        fns.insert(0, grid_fn)
    return fns


def _field_heads_padded(params: Dict, config: NerfactoNuscMSConfig, flat: torch.Tensor):
    routing = route_positions_padded(flat, params["field"]["centroids"], GROUP_BLOCK)
    density_p, geo_p, sem_p = density_and_embedding_padded(
        params["field"], config.field, pad_rows(flat, routing), routing)
    return density_p, geo_p, sem_p, routing


def forward(params: Dict, config: NerfactoNuscMSConfig, bundle: RayBundle,
            train: bool = False, prop_grid: Optional[torch.Tensor] = None,
            anneal: float = 1.0, uniforms: Optional[Sequence[torch.Tensor]] = None,
            stop_prop_grad: bool = False) -> Dict:
    """Forward pass: proposal sampling, main field on the padded routing
    layout, one K3 pass for weights, depths and the rgb+semantics
    composite, sky blending. Train mode gathers the appearance embeddings
    by camera and video and samples with ``uniforms`` (one (R, 1) draw per
    round, single jitter; None samples deterministically); ``anneal`` and
    ``stop_prop_grad`` act on the proposal rounds."""
    bundle = apply_collider(bundle, config)
    ray_samples, weights_list, ray_samples_list = proposal_sample(
        bundle, _density_fns(params, config, prop_grid),
        config.num_proposal_samples_per_ray, config.num_nerf_samples_per_ray,
        config.spacing, anneal=anneal, uniforms=uniforms, stop_prop_grad=stop_prop_grad)
    if config.use_prop_grid:
        # The cached-grid round carries no gradient: it is dropped from the
        # loss lists, as in JAX.
        weights_list, ray_samples_list = weights_list[1:], ray_samples_list[1:]

    num_rays, num_samples = ray_samples.starts.shape
    positions = ray_samples.positions().reshape(-1, 3)
    fcfg = config.field
    app = _embed_appearance(params, config, bundle, train)

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
    accumulation = clip(render["accumulation"], 0.0, 1.0)

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


def field_density(params: Dict, config: NerfactoNuscMSConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Main-field density at world positions (..., 3)."""
    shape = positions.shape[:-1]
    density_p, _, _, routing = _field_heads_padded(params, config, positions.reshape(-1, 3))
    return unpad_rows(density_p, routing).reshape(shape)


def field_semantics(params: Dict, config: NerfactoNuscMSConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """Main-field semantic features at world positions (..., 3)."""
    shape = positions.shape[:-1]
    _, _, sem_p, routing = _field_heads_padded(params, config, positions.reshape(-1, 3))
    sem = semantics_padded(params["field"], config.field, sem_p, routing)
    return unpad_rows(sem, routing).reshape(*shape, -1)


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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def compute_losses(outputs: Dict, batch: Dict, config: NerfactoNuscMSConfig,
                   sigma: float, los_mult: float) -> Dict[str, torch.Tensor]:
    """Training losses; ``sigma`` and ``los_mult`` are the host-side
    line-of-sight schedule values."""
    loss_dict: Dict[str, torch.Tensor] = {}
    if "rgb" in batch:
        loss_dict["rgb_loss"] = L.rgb_loss(outputs["rgb"], batch["rgb"])
    if config.use_sky_model and "sky" in batch:
        loss_dict["sky_loss"] = config.sky_loss_mult * L.sky_loss(outputs["accumulation"],
                                                                  batch["sky"])
    if (config.use_lidar_loss or config.use_monodepth_loss) and "depth" in batch:
        final_samples: RaySamples = outputs["ray_samples_list"][-1]
        psf = config.pose_scale_factor
        ray_steps = final_samples.steps() / psf
        predicted_depth = outputs["expected_depth"] / psf
        upper = (config.lidar_depth_upperbound if config.use_lidar_loss
                 else config.monodepth_depth_upperbound)
        if config.use_lidar_loss:
            loss_dict["expected_depth_loss"] = config.expected_depth_loss_mult * \
                L.expected_depth_loss(batch["depth"], predicted_depth, upper)
            sky_mask = None
        else:
            loss_dict["expected_depth_loss"] = config.expected_depth_loss_mult * \
                L.expected_monodepth_loss(batch["depth"], predicted_depth, batch["sky"], upper,
                                          config.monodepth_loss_inverse)
            sky_mask = batch["sky"]
        loss_dict["line_of_sight_loss"] = los_mult * L.line_of_sight_loss(
            outputs["weights_list"][-1], batch["depth"], ray_steps, sigma, sky_mask, upper)
    if config.use_semantics and "features" in batch:
        loss_dict["semantic_loss"] = config.semantic_loss_mult * L.semantic_loss(
            outputs["semantics"], batch["features"])
    if config.enable_z_anti_aliasing:
        # With the cached grid, forward() drops round 0 from the lists; keep
        # the per-round pulse widths aligned.
        pulse_width = config.pulse_width[1:] if config.use_prop_grid else config.pulse_width
        il = z_anti_aliasing_interlevel_loss(outputs["weights_list"],
                                             outputs["ray_samples_list"], pulse_width)
    else:
        il = interlevel_loss(outputs["weights_list"], outputs["ray_samples_list"])
    loss_dict["interlevel_loss"] = config.interlevel_loss_mult * il
    loss_dict["distortion_loss"] = config.distortion_loss_mult * distortion_loss(
        outputs["weights_list"], outputs["ray_samples_list"])
    return loss_dict


_BUFFER_KEYS = ("aabbs", "centroids")


def param_groups(params: Dict) -> Dict:
    """Optimizer group labels: the proposal fields in 'proposal_networks',
    every other trainable leaf in 'fields', and every aabb and centroid
    buffer 'frozen' (left out of the optimizer). The JAX package labels the
    proposal fields' buffers 'proposal_networks', so its weight decay moves
    them; here they stay frozen like the other buffers."""

    def label(tree, group):
        if isinstance(tree, dict):
            return {k: "frozen" if k in _BUFFER_KEYS else label(v, group)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(label(v, group) for v in tree)
        return group

    return {name: label(sub, "proposal_networks" if name == "props" else "fields")
            for name, sub in params.items()}


# ---------------------------------------------------------------------------
# Host-side schedules
# ---------------------------------------------------------------------------


def prop_grid_refresh_due(config: NerfactoNuscMSConfig, step: int) -> bool:
    """Refresh the cached grid every warmup_every steps early, then every
    update_every."""
    if not config.use_prop_grid:
        return False
    every = (config.prop_grid_warmup_every if step < config.prop_grid_warmup_steps
             else config.prop_grid_update_every)
    return step % max(every, 1) == 0


def anneal_at(config: NerfactoNuscMSConfig, step: int) -> float:
    """Proposal-weight anneal exponent (zip-NeRF eq. 18)."""
    if not config.use_proposal_weight_anneal:
        return 1.0
    train_frac = float(np.clip(step / config.proposal_weights_anneal_max_num_iters, 0.0, 1.0))
    b = config.proposal_weights_anneal_slope
    return b * train_frac / ((b - 1.0) * train_frac + 1.0)


def line_of_sight_sigma_at(config: NerfactoNuscMSConfig, step: int) -> float:
    start, end = config.line_of_sight_start_step, config.line_of_sight_end_step
    frac = float(np.clip((step - start) / max(end - start, 1), 0.0, 1.0))
    return config.line_of_sight_max_sigma - frac * (
        config.line_of_sight_max_sigma - config.line_of_sight_min_sigma)


def line_of_sight_mult_at(config: NerfactoNuscMSConfig, step: int) -> float:
    if step <= config.line_of_sight_start_step:
        return 0.0
    return config.line_of_sight_mult / (2.0 ** (step // config.line_of_sight_decay_steps))


class ProposalUpdateSchedule:
    """Host-side proposal update bookkeeping: the proposal densities carry
    gradients only on 'updated' steps."""

    def __init__(self, config: NerfactoNuscMSConfig):
        self._cfg = config
        self._steps_since_update = 0

    def updated(self, step: int) -> bool:
        sched = float(np.clip(np.interp(step, [0, self._cfg.proposal_warmup],
                                        [0, self._cfg.proposal_update_every]),
                              1, self._cfg.proposal_update_every))
        return bool(self._steps_since_update > sched or step < 10)

    def step_cb(self, step: int, was_updated: bool) -> None:
        # The counter is reset before the after-iteration increment, so an
        # update step ends with it at 1.
        if was_updated:
            self._steps_since_update = 0
        self._steps_since_update += 1


class NerfactoNuscMS(nn.Module):
    """The model's parameter tree as an nn.Module, with the entry points.
    ``params()`` rebuilds the JAX-layout tree from the registered tensors;
    ``bridge.from_jax_params`` gives a tree to start from. Trainable leaves
    have ``requires_grad``; the aabb and centroid buffers are frozen."""

    def __init__(self, config: NerfactoNuscMSConfig, params: Dict):
        super().__init__()
        self.config = config
        leaves: List[torch.Tensor] = []

        def index(t):
            leaves.append(t)
            return len(leaves) - 1

        self._skeleton = _map(params, index)
        labels: List[str] = []
        _map(param_groups(params), labels.append)
        self.labels = labels
        self.leaves = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(t, dtype=torch.float32), requires_grad=lab != "frozen")
             for t, lab in zip(leaves, labels)])

    def params(self) -> Dict:
        return _map(self._skeleton, lambda i: self.leaves[i])

    def groups(self) -> Dict[str, List[nn.Parameter]]:
        """Trainable leaves by optimizer group."""
        out: Dict[str, List[nn.Parameter]] = {}
        for leaf, lab in zip(self.leaves, self.labels):
            if lab != "frozen":
                out.setdefault(lab, []).append(leaf)
        return out

    def forward(self, bundle: RayBundle, train: bool = False,
                prop_grid: Optional[torch.Tensor] = None, anneal: float = 1.0,
                uniforms: Optional[Sequence[torch.Tensor]] = None,
                stop_prop_grad: bool = False) -> Dict:
        """forward() of the module's tree; eval mode runs without autograd."""
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return forward(self.params(), self.config, bundle, train=train, prop_grid=prop_grid,
                           anneal=anneal, uniforms=uniforms, stop_prop_grad=stop_prop_grad)

    @torch.no_grad()
    def forward_depth(self, bundle: RayBundle, threshold: float = 0.5,
                      prop_grid: Optional[torch.Tensor] = None) -> Dict:
        return forward_depth(self.params(), self.config, bundle, threshold, prop_grid)

    @torch.no_grad()
    def point_queries(self, positions: torch.Tensor,
                      prop_grid: Optional[torch.Tensor] = None):
        return point_queries(self.params(), self.config, positions, prop_grid)

    @torch.no_grad()
    def field_density(self, positions: torch.Tensor) -> torch.Tensor:
        return field_density(self.params(), self.config, positions)

    @torch.no_grad()
    def field_semantics(self, positions: torch.Tensor) -> torch.Tensor:
        return field_semantics(self.params(), self.config, positions)

    @torch.no_grad()
    def make_prop_grid(self) -> Optional[torch.Tensor]:
        return make_prop_grid(self.params(), self.config)


def init_model(generator: torch.Generator, config: NerfactoNuscMSConfig, aabbs, centroids,
               num_train_cameras: int, num_train_videos: int,
               device=None) -> NerfactoNuscMS:
    """A randomly initialised model (init_model's shapes), drawn from the CPU
    ``generator`` and placed on ``device``: the CUDA card unless the caller
    asks for another device."""
    model = NerfactoNuscMS(config, init_params(generator, config, aabbs, centroids,
                                               num_train_cameras, num_train_videos))
    return model.to(torch.device(device if device is not None else "cuda"))
