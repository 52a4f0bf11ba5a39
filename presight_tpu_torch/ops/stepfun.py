"""Step-function math: the distortion loss, the MipNeRF-360 interlevel loss
and the zip-NeRF anti-aliased interlevel loss (presight_tpu/ops/stepfun.py).

JAX's batched ``searchsorted`` and ``take_batched`` are
``torch.searchsorted`` and ``torch.gather`` here; ``blur_stepfun``'s joint
key/payload sort is a stable ``torch.sort`` followed by a gather.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .math import clip
from .rays import RaySamples


def _searchsorted(sorted_seq: torch.Tensor, values: torch.Tensor, right: bool) -> torch.Tensor:
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(), right=right)


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """Normalised bin edges (R, S + 1)."""
    return torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], dim=-1)


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 distortion in O(S) with prefix sums: for sorted
    midpoints, sum_ij w_i w_j |u_i - u_j| = 2 sum_i w_i (u_i csum_{j<i} w_j
    - csum_{j<i} w_j u_j), plus the intra-bin term."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    cw = torch.cumsum(w, dim=-1) - w
    cwu = torch.cumsum(w * ut, dim=-1) - w * ut
    loss_inter = 2.0 * torch.sum(w * (ut * cw - cwu), dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list: Sequence[torch.Tensor],
                    ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """Mean distortion of the final round."""
    return torch.mean(lossfun_distortion(ray_samples_to_sdist(ray_samples_list[-1]),
                                         weights_list[-1]))


def outer(t0_starts: torch.Tensor, t0_ends: torch.Tensor, t1_starts: torch.Tensor,
          t1_ends: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """Mass of the histogram (t1, y1) covering each [t0_start, t0_end] bin."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    idx_lo = torch.clamp(_searchsorted(t1_starts, t0_starts, right=True) - 1, 0, last)
    idx_hi = torch.clamp(_searchsorted(t1_ends, t0_ends, right=True), 0, last)
    cy1_lo = torch.gather(cy1[..., :-1], -1, idx_lo)
    cy1_hi = torch.gather(cy1[..., 1:], -1, idx_hi)
    return cy1_hi - cy1_lo


def lossfun_outer(t: torch.Tensor, w: torch.Tensor, t_env: torch.Tensor,
                  w_env: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 proposal loss: penalise proposal histograms (t_env,
    w_env) that underestimate the NeRF histogram (t, w)."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return clip(w - w_outer, 0.0) ** 2 / (w + 1e-7)


def interlevel_loss(weights_list: Sequence[torch.Tensor],
                    ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """Plain MipNeRF-360 interlevel loss."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    total = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        cp = ray_samples_to_sdist(ray_samples)
        total = total + torch.mean(lossfun_outer(c, w, cp, weights))
    return total


def blur_stepfun(x: torch.Tensor, y: torch.Tensor, r: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convolve a step function (knots x (R, N+1), values y (R, N)) with a
    box of half-width r. Returns (xr, yr), each (R, 2N + 2)."""
    xr_cat = torch.cat([x - r, x + r], dim=-1)
    zero = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zero], dim=-1) - torch.cat([zero, y], dim=-1)) / (2.0 * r)
    xr, order = torch.sort(xr_cat, dim=-1, stable=True)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, order)[..., :-1]
    yr = torch.cumsum((xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1), dim=-1)
    yr = clip(yr, 0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)


def sorted_interp_quad(x: torch.Tensor, xp: torch.Tensor, fpdf: torch.Tensor,
                       fcdf: torch.Tensor) -> torch.Tensor:
    """Quadratic interpolation of a CDF given by trapezoid-integrated pdf
    knots; every input sorted along the last axis."""
    last = xp.shape[-1] - 1
    i_right = _searchsorted(xp, x, right=True)
    idx0 = torch.clamp(i_right - 1, 0, last)
    idx1 = torch.clamp(i_right, 0, last)
    fcdf0, fcdf1 = torch.gather(fcdf, -1, idx0), torch.gather(fcdf, -1, idx1)
    fpdf0, fpdf1 = torch.gather(fpdf, -1, idx0), torch.gather(fpdf, -1, idx1)
    xp0, xp1 = torch.gather(xp, -1, idx0), torch.gather(xp, -1, idx1)
    offset = clip(torch.nan_to_num((x - xp0) / (xp1 - xp0)), 0.0, 1.0)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset + fpdf0 * (1.0 - offset)) / 2.0


def z_anti_aliasing_interlevel_loss(weights_list: Sequence[torch.Tensor],
                                    ray_samples_list: Sequence[RaySamples],
                                    pulse_width: Tuple[float, ...] = (0.03, 0.003)
                                    ) -> torch.Tensor:
    """zip-NeRF anti-aliased interlevel loss: the final round's normalised
    histogram is blurred with each proposal round's pulse width, and each
    proposal round is penalised for underestimating the blurred mass in its
    bins."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    w_normalized = w / (c[..., 1:] - c[..., :-1])
    blurred = []
    for r in pulse_width:
        cb, wb = blur_stepfun(c, w_normalized, r)
        area = 0.5 * (wb[..., 1:] + wb[..., :-1]) * (cb[..., 1:] - cb[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, dim=-1)], dim=-1)
        blurred.append((cb, wb, cdf))
    loss = 0.0
    for i, (ray_samples, wp) in enumerate(zip(ray_samples_list[:-1], weights_list[:-1])):
        cp = ray_samples_to_sdist(ray_samples)
        cb, wb, cdf = blurred[i]
        w_s = torch.diff(sorted_interp_quad(cp, cb, wb, cdf), dim=-1)
        loss = loss + torch.mean(clip(w_s - wp, 0.0) ** 2 / (wp + 1e-5))
    return loss
