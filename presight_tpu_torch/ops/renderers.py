"""Volume rendering (presight_tpu/ops/renderers.py, ops/rays.py::get_weights
and the fused composite of models/nerfacto_ms.py::forward).

``volume_render`` is the wrapper of kernel K3 (csrc/volume_render.cu): from
per-sample deltas and densities it gives the weights and, on request, the
accumulation, the median and expected depths and the weighted composite of
a payload. On CUDA tensors it launches the kernel, on CPU tensors it runs
``volume_render_plain``, built from the plain functions below.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import kernels
from .rays import RaySamples, get_weights


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-1)


def _depth_median(weights: torch.Tensor, steps: torch.Tensor,
                  threshold: float) -> torch.Tensor:
    cumulative = torch.cumsum(weights, dim=-1)
    split = torch.full((*weights.shape[:-1], 1), threshold, dtype=weights.dtype,
                       device=weights.device)
    idx = torch.searchsorted(cumulative.contiguous(), split, right=False)
    idx = torch.clamp(idx, 0, steps.shape[-1] - 1)
    return torch.gather(steps, -1, idx)[..., 0]


def _depth_expected(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    depth = torch.sum(weights * steps, dim=-1) / (torch.sum(weights, dim=-1) + 1e-10)
    lo, hi = torch.aminmax(steps)
    return torch.clamp(depth, lo, hi)


def render_depth_median(weights: torch.Tensor, ray_samples: RaySamples,
                        threshold: float = 0.5) -> torch.Tensor:
    """Depth where the cumulative weight first reaches ``threshold``."""
    return _depth_median(weights, ray_samples.steps(), threshold)


def render_depth_expected(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """sum(w t) / (sum(w) + 1e-10), clipped to the batch's step range."""
    return _depth_expected(weights, ray_samples.steps())


def volume_render_plain(deltas: torch.Tensor, density: torch.Tensor,
                        steps: Optional[torch.Tensor] = None,
                        payload: Optional[torch.Tensor] = None,
                        payload_index: Optional[torch.Tensor] = None,
                        threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Plain version of K3. deltas, density, steps (R, S); payload (P, C)
    with payload_index (R * S,) naming each sample's payload row (None: row
    r * S + s). Returns 'weights', plus 'accumulation', 'depth',
    'expected_depth' when steps is given and 'composite' (R, C) when payload
    is given."""
    weights = get_weights(deltas, density)
    out = {"weights": weights}
    if steps is not None:
        out["accumulation"] = render_accumulation(weights)
        out["depth"] = _depth_median(weights, steps, threshold)
        out["expected_depth"] = _depth_expected(weights, steps)
    if payload is not None:
        rows = payload if payload_index is None else payload[payload_index.long()]
        r, s = weights.shape
        out["composite"] = torch.sum(
            rows.reshape(r, s, -1) * weights[..., None], dim=1)
    return out


def volume_render(deltas: torch.Tensor, density: torch.Tensor,
                  steps: Optional[torch.Tensor] = None,
                  payload: Optional[torch.Tensor] = None,
                  payload_index: Optional[torch.Tensor] = None,
                  threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Wrapper of K3 (see volume_render_plain for the contract)."""
    if deltas.device.type == "cpu":
        return volume_render_plain(deltas, density, steps, payload, payload_index,
                                   threshold)
    if deltas.dim() != 2 or density.shape != deltas.shape:
        raise ValueError("volume_render: deltas and density must be (R, S)")
    r, s = deltas.shape
    tensors = [deltas, density]
    if steps is not None:
        if steps.shape != deltas.shape:
            raise ValueError("volume_render: steps must be (R, S)")
        tensors.append(steps)
    c = 0
    if payload is not None:
        if payload.dim() != 2:
            raise ValueError("volume_render: payload must be (P, C)")
        c = payload.shape[1]
        tensors.append(payload)
        if payload_index is None:
            if payload.shape[0] != r * s:
                raise ValueError("volume_render: payload needs R * S rows")
        else:
            if payload_index.dtype != torch.int32 or payload_index.shape != (r * s,):
                raise ValueError("volume_render: payload_index must be int32 (R * S,)")
            tensors.append(payload_index)
    for t in tensors:
        if t is not payload_index and t.dtype != torch.float32:
            raise TypeError("volume_render: expected float32 inputs")
    kernels.require_cuda("volume_render", *tensors)
    device = deltas.device
    out = {"weights": torch.empty((r, s), dtype=torch.float32, device=device)}
    clip = None
    if steps is not None:
        clip = torch.stack(torch.aminmax(steps))
        for key in ("accumulation", "depth", "expected_depth"):
            out[key] = torch.empty((r,), dtype=torch.float32, device=device)
    if payload is not None:
        out["composite"] = torch.empty((r, c), dtype=torch.float32, device=device)
    code = kernels.lib().volume_render_fwd(
        deltas.data_ptr(), density.data_ptr(), kernels.ptr(steps), kernels.ptr(clip),
        kernels.ptr(payload), kernels.ptr(payload_index), r, s, c, float(threshold),
        out["weights"].data_ptr(), kernels.ptr(out.get("accumulation")),
        kernels.ptr(out.get("depth")), kernels.ptr(out.get("expected_depth")),
        kernels.ptr(out.get("composite")), kernels.stream())
    kernels.check("volume_render_fwd", code)
    kernels.LAUNCHES["volume_render_fwd"] += 1
    return out
