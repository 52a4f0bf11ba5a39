"""Ray samplers (presight_tpu/ops/samplers.py): spaced initial sampling,
inverse-CDF resampling, and the proposal loop.

The random draws are arguments: ``None`` gives the deterministic
(non-stratified) samples the serving path uses; a tensor of uniform draws
gives stratified samples, so a caller can feed in JAX's draws and compare.
Training draws one (R, 1) tensor per round (single jitter), from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..configs import SpacingSpec
from .rays import RayBundle, RaySamples
from .renderers import volume_render

DensityFn = Callable[[torch.Tensor], torch.Tensor]


def spacing_to_euclidean(spacing_bins: torch.Tensor, nears: torch.Tensor,
                         fars: torch.Tensor, spec: SpacingSpec) -> torch.Tensor:
    s_near = spec.fn(nears)[..., None]
    s_far = spec.fn(fars)[..., None]
    return spec.fn_inv(spacing_bins * s_far + (1.0 - spacing_bins) * s_near)


def _make_ray_samples(ray_bundle: RayBundle, spacing_bins: torch.Tensor,
                      spec: SpacingSpec) -> RaySamples:
    euclidean_bins = spacing_to_euclidean(spacing_bins, ray_bundle.nears,
                                          ray_bundle.fars, spec)
    return RaySamples(
        origins=ray_bundle.origins,
        directions=ray_bundle.directions,
        starts=euclidean_bins[..., :-1],
        ends=euclidean_bins[..., 1:],
        spacing_starts=spacing_bins[..., :-1],
        spacing_ends=spacing_bins[..., 1:],
        camera_indices=ray_bundle.camera_indices,
        video_ids=ray_bundle.video_ids,
    )


def spaced_sample(ray_bundle: RayBundle, num_samples: int, spec: SpacingSpec,
                  uniform: Optional[torch.Tensor] = None) -> RaySamples:
    """Samples under a spacing warp. ``uniform``: None for bin edges at
    linspace(0, 1); (R, 1) or (R, S + 1) draws in [0, 1) for stratified
    jitter (single or per-bin)."""
    num_rays = ray_bundle.num_rays
    origins = ray_bundle.origins
    bins = torch.linspace(0.0, 1.0, num_samples + 1, dtype=origins.dtype,
                          device=origins.device)[None, :]
    if uniform is not None:
        bin_centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        bin_upper = torch.cat([bin_centers, bins[..., -1:]], dim=-1)
        bin_lower = torch.cat([bins[..., :1], bin_centers], dim=-1)
        bins = bin_lower + (bin_upper - bin_lower) * uniform
    else:
        bins = bins.expand(num_rays, num_samples + 1)
    return _make_ray_samples(ray_bundle, bins, spec)


def pdf_sample(ray_bundle: RayBundle, ray_samples: RaySamples, weights: torch.Tensor,
               num_samples: int, spec: SpacingSpec,
               uniform: Optional[torch.Tensor] = None,
               histogram_padding: float = 0.01, eps: float = 1e-5) -> RaySamples:
    """Inverse-CDF resampling of the previous round's weights (R, S_prev).
    ``uniform``: None for the midpoint rule, else (R, 1) or (R, S + 1) draws."""
    num_bins = num_samples + 1
    w = weights + histogram_padding
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(eps - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=weights.dtype,
                       device=weights.device).expand(*cdf.shape[:-1], num_bins)
    if uniform is not None:
        u = u + uniform / num_bins
    else:
        u = u + 1.0 / (2 * num_bins)
    u = u.contiguous()

    existing_bins = torch.cat(
        [ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, existing_bins.shape[-1] - 1)
    above = torch.clamp(inds, 0, existing_bins.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0)), 0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)
    return _make_ray_samples(ray_bundle, bins.detach(), spec)


def proposal_sample(ray_bundle: RayBundle, density_fns: Sequence[DensityFn],
                    num_proposal_samples: Tuple[int, ...], num_nerf_samples: int,
                    spec: SpacingSpec, anneal: float = 1.0,
                    uniforms: Optional[Sequence[torch.Tensor]] = None,
                    stop_prop_grad: bool = False,
                    ) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Proposal rounds (density + K3 weights + PDF resample), then the final
    bins. ``uniforms``: None (deterministic) or one draw tensor per round;
    ``anneal`` raises the proposal weights to a power before resampling;
    ``stop_prop_grad`` detaches the proposal densities (the steps between
    proposal updates). Returns (final samples, proposal weights list,
    proposal samples list)."""
    n_rounds = len(num_proposal_samples)
    weights_list: List[torch.Tensor] = []
    ray_samples_list: List[RaySamples] = []
    eps = float(torch.finfo(ray_bundle.origins.dtype).eps)
    weights = ray_samples = None
    for i_level in range(n_rounds + 1):
        is_prop = i_level < n_rounds
        num_samples = num_proposal_samples[i_level] if is_prop else num_nerf_samples
        uniform = None if uniforms is None else uniforms[i_level]
        if i_level == 0:
            ray_samples = spaced_sample(ray_bundle, num_samples, spec, uniform)
        else:
            annealed = torch.pow(weights, anneal)
            ray_samples = pdf_sample(ray_bundle, ray_samples, annealed, num_samples,
                                     spec, uniform, eps=eps)
        if is_prop:
            density = density_fns[i_level](ray_samples.positions())
            if stop_prop_grad:
                density = density.detach()
            weights = volume_render(ray_samples.deltas().contiguous(),
                                    density.contiguous())["weights"]
            weights_list.append(weights)
            ray_samples_list.append(ray_samples)
    return ray_samples, weights_list, ray_samples_list
