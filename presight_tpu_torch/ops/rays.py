"""Rays, samples and the plain volume-rendering weights
(presight_tpu/ops/rays.py). The fused CUDA version of ``get_weights`` is K3,
in ops/renderers.py."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RayBundle:
    """A batch of rays; every field is (R, ...)."""

    origins: torch.Tensor  # (R, 3)
    directions: torch.Tensor  # (R, 3), unit norm
    nears: torch.Tensor  # (R,)
    fars: torch.Tensor  # (R,)
    camera_indices: Optional[torch.Tensor] = None  # (R,) int32
    video_ids: Optional[torch.Tensor] = None  # (R,) int32

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **kwargs) -> "RayBundle":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class RaySamples:
    """Dense samples along rays: euclidean bin edges (R, S) and the
    normalised [0, 1] bins before the spacing warp."""

    origins: torch.Tensor  # (R, 3)
    directions: torch.Tensor  # (R, 3)
    starts: torch.Tensor  # (R, S)
    ends: torch.Tensor  # (R, S)
    spacing_starts: torch.Tensor  # (R, S)
    spacing_ends: torch.Tensor  # (R, S)
    camera_indices: Optional[torch.Tensor] = None
    video_ids: Optional[torch.Tensor] = None

    @property
    def num_samples(self) -> int:
        return self.starts.shape[-1]

    def positions(self) -> torch.Tensor:
        """Frustum centres origin + direction * (start + end) / 2."""
        mids = (self.starts + self.ends) / 2.0
        return self.origins[..., None, :] + self.directions[..., None, :] * mids[..., None]

    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    def steps(self) -> torch.Tensor:
        """Midpoint distance of each sample, read by the depth renderers."""
        return (self.starts + self.ends) / 2.0


def get_weights(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """w_i = (1 - exp(-sigma_i delta_i)) exp(-sum_{j<i} sigma_j delta_j), with
    NaN flushed to 0 and +-inf to the largest finite float."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    csum = torch.cumsum(delta_density[..., :-1], dim=-1)
    csum = torch.cat([torch.zeros_like(delta_density[..., :1]), csum], dim=-1)
    transmittance = torch.exp(-csum)
    return torch.nan_to_num(alphas * transmittance)
