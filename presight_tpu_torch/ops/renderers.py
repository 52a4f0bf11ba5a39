"""Volume rendering (presight_tpu/ops/renderers.py, ops/rays.py::get_weights
and the fused composite of models/nerfacto_ms.py::forward).

``volume_render`` is a ``torch.autograd.Function``: from per-sample deltas
and densities it gives the weights and, on request, the accumulation, the
median and expected depths and the weighted composite of a payload. Its
forward is kernel K3 (csrc/volume_render.cu), its backward kernel K3b
(csrc/volume_render_bwd.cu), which takes the gradients of the weights,
accumulation, expected depth and composite to the densities and payload
rows (the median depth is stop-gradient). The kernels launch, or where
``kernels.use_plain`` says so (CPU tensors) the plain versions run:
``volume_render_plain``, built from the plain functions below, and
``volume_render_bwd_plain``, the backward's formula written out; the
Function's backward follows its forward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import kernels
from .math import clip as clip_
from .rays import RaySamples, get_weights

RENDER_KEYS = ("weights", "accumulation", "depth", "expected_depth", "composite")


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
    return clip_(depth, lo, hi)


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


def step_bounds(steps: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """{min, max} of the batch's steps, the expected depth's clip bounds
    (one device tensor, so the kernels read them without a host sync)."""
    return None if steps is None else torch.stack(torch.aminmax(steps))


def volume_render_fwd(deltas: torch.Tensor, density: torch.Tensor,
                      steps: Optional[torch.Tensor] = None,
                      payload: Optional[torch.Tensor] = None,
                      payload_index: Optional[torch.Tensor] = None,
                      threshold: float = 0.5,
                      clip: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Wrapper of K3 (see volume_render_plain for the contract); ``clip``:
    step_bounds(steps), computed here when not given. The kernel takes a ray
    of any length: it stages a ray's payload rows in shared memory where
    S * (C + 2) floats fit (58,112: S <= 842 at C = 67), reads them from
    device memory otherwise, and keeps the weights in the output where S
    weights and row indices do not fit either; the sums run in one order on
    every path."""
    if kernels.use_plain(deltas):
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
    if steps is not None:
        if clip is None:
            clip = step_bounds(steps)
        for key in ("accumulation", "depth", "expected_depth"):
            out[key] = torch.empty((r,), dtype=torch.float32, device=device)
    if payload is not None:
        out["composite"] = torch.empty((r, c), dtype=torch.float32, device=device)
    kernels.launch("volume_render_fwd", deltas.data_ptr(), density.data_ptr(),
                   kernels.ptr(steps), kernels.ptr(clip), kernels.ptr(payload),
                   kernels.ptr(payload_index), r, s, c, float(threshold),
                   out["weights"].data_ptr(), kernels.ptr(out.get("accumulation")),
                   kernels.ptr(out.get("depth")), kernels.ptr(out.get("expected_depth")),
                   kernels.ptr(out.get("composite")))
    return out


def _clip_grad(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """d/dx min(max(x, lo), hi) as JAX differentiates it: 0.5 at a tie."""
    a = (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)
    m = torch.maximum(x, lo)
    return a * ((m < hi).to(x.dtype) + 0.5 * (m == hi).to(x.dtype))


def volume_render_bwd_plain(deltas: torch.Tensor, density: torch.Tensor,
                            steps: Optional[torch.Tensor], payload: Optional[torch.Tensor],
                            payload_index: Optional[torch.Tensor], weights: torch.Tensor,
                            g_weights: torch.Tensor, g_acc: Optional[torch.Tensor],
                            g_expected: Optional[torch.Tensor],
                            g_composite: Optional[torch.Tensor]):
    """Plain version of K3b. With dd = delta sigma, alpha = 1 - exp(-dd),
    T_s = exp(-sum_{j<s} dd_j): the gradient of each weight gathers
    dL/dw, dL/dacc, dL/dcomposite . payload row and the expected depth's
    (t_s / b - a / b^2) times jnp.clip's derivative (a = sum w t,
    b = sum w + 1e-10); it passes where alpha T is finite; then
    dsigma_j = delta_j (gw_j T_j exp(-dd_j) - sum_{s>j} gw_s alpha_s T_s)
    and dpayload[row(s)] = w_s dL/dcomposite. Returns (d density, d payload
    or None)."""
    dd = deltas * density
    e_dd = torch.exp(-dd)
    alpha = 1.0 - e_dd
    csum = torch.cumsum(dd[..., :-1], dim=-1)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), csum], dim=-1))
    gw = g_weights
    if steps is not None:
        wsum = torch.sum(weights, dim=-1)
        a = torch.sum(weights * steps, dim=-1)
        b = wsum + 1e-10
        lo, hi = torch.aminmax(steps)
        ge = g_expected * _clip_grad(a / b, lo, hi)
        gw = gw + g_acc[:, None] + (ge[:, None] * steps / b[:, None] - (ge * a / (b * b))[:, None])
    d_payload = None
    if payload is not None:
        r, s = weights.shape
        index = (torch.arange(r * s, device=deltas.device) if payload_index is None
                 else payload_index.long())
        rows = payload[index].reshape(r, s, -1)
        gw = gw + torch.sum(rows * g_composite[:, None, :], dim=-1)
        d_payload = torch.zeros_like(payload)
        d_payload[index] = (weights[..., None] * g_composite[:, None, :]).reshape(r * s, -1)
    gw = torch.where(torch.isfinite(alpha * trans), gw, torch.zeros_like(gw))
    q = gw * alpha * trans
    after = torch.flip(torch.cumsum(torch.flip(q[..., 1:], [-1]), dim=-1), [-1])
    after = torch.cat([after, torch.zeros_like(q[..., :1])], dim=-1)
    return deltas * (gw * trans * e_dd - after), d_payload


def volume_render_bwd(deltas: torch.Tensor, density: torch.Tensor,
                      steps: Optional[torch.Tensor], payload: Optional[torch.Tensor],
                      payload_index: Optional[torch.Tensor], weights: torch.Tensor,
                      g_weights: torch.Tensor, g_acc: Optional[torch.Tensor],
                      g_expected: Optional[torch.Tensor], g_composite: Optional[torch.Tensor],
                      clip: Optional[torch.Tensor]):
    """Wrapper of K3b (see volume_render_bwd_plain for the contract);
    ``clip``: step_bounds(steps) as the forward used it (None without
    steps). The kernel zeroes the payload rows no sample reads. It takes a
    ray of any length: it stages a ray's payload rows in shared memory where
    4S + C + S * C floats fit (58,112: S <= 817 at C = 67), reads them from
    device memory otherwise, and where the per-sample arrays do not fit
    either keeps them in device memory, in a scratch buffer of R x S floats
    allocated here for such rays only. T_s and the expected depth's sums are
    K3's on every path."""
    if kernels.use_plain(deltas):
        return volume_render_bwd_plain(deltas, density, steps, payload, payload_index, weights,
                                       g_weights, g_acc, g_expected, g_composite)
    r, s = deltas.shape
    tensors = [deltas, density, weights, g_weights]
    if steps is not None:
        if clip is None or clip.shape != (2,):
            raise ValueError("volume_render_bwd: clip must be {min, max} of the steps")
        tensors += [steps, g_acc, g_expected, clip]
    c = 0
    if payload is not None:
        c = payload.shape[1]
        tensors += [payload, g_composite]
        if payload_index is not None:
            if payload_index.dtype != torch.int32:
                raise ValueError("volume_render_bwd: payload_index must be int32")
            tensors.append(payload_index)
    for t in tensors:
        if t is not payload_index and t.dtype != torch.float32:
            raise TypeError("volume_render_bwd: expected float32 inputs")
    kernels.require_cuda("volume_render_bwd", *tensors)
    d_density = torch.empty_like(density)
    d_payload = None if payload is None else torch.empty_like(payload)
    n_scratch = kernels.lib().volume_render_bwd_scratch_floats(r, s, c, payload is not None)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=deltas.device) if n_scratch \
        else None
    kernels.launch("volume_render_bwd", deltas.data_ptr(), density.data_ptr(),
                   kernels.ptr(steps), kernels.ptr(clip), kernels.ptr(payload),
                   kernels.ptr(payload_index), weights.data_ptr(), g_weights.data_ptr(),
                   kernels.ptr(g_acc), kernels.ptr(g_expected), kernels.ptr(g_composite), r, s,
                   c, 0 if payload is None else payload.shape[0], d_density.data_ptr(),
                   kernels.ptr(d_payload), kernels.ptr(scratch))
    return d_density, d_payload


class _VolumeRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, deltas, density, steps, payload, payload_index, threshold):
        clip = step_bounds(steps)
        ctx.plain = kernels.use_plain(deltas)
        out = volume_render_fwd(deltas, density, steps, payload, payload_index, threshold, clip)
        ctx.save_for_backward(deltas, density, steps, payload, payload_index, out["weights"],
                              clip)
        outs = tuple(out[key] if key in out else deltas.new_empty((0,)) for key in RENDER_KEYS)
        ctx.mark_non_differentiable(outs[2])
        return outs

    @staticmethod
    def backward(ctx, g_weights, g_acc, _g_depth, g_expected, g_composite):
        deltas, density, steps, payload, payload_index, weights, clip = ctx.saved_tensors
        with_steps, with_payload = steps is not None, payload is not None
        with kernels.plain_versions(ctx.plain):
            d_density, d_payload = volume_render_bwd(
                deltas, density, steps, payload, payload_index, weights, g_weights.contiguous(),
                g_acc.contiguous() if with_steps else None,
                g_expected.contiguous() if with_steps else None,
                g_composite.contiguous() if with_payload else None, clip)
        return None, d_density, None, d_payload, None, None


def volume_render(deltas: torch.Tensor, density: torch.Tensor,
                  steps: Optional[torch.Tensor] = None,
                  payload: Optional[torch.Tensor] = None,
                  payload_index: Optional[torch.Tensor] = None,
                  threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Weights (and, with steps, accumulation, median and expected depth;
    with a payload, the composite), differentiable in density and payload
    (K3 forward, K3b backward). See volume_render_plain for the contract."""
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in (density, payload))):
        return volume_render_fwd(deltas, density, steps, payload, payload_index, threshold)
    outs = _VolumeRender.apply(deltas, density, steps, payload, payload_index, threshold)
    out = {"weights": outs[0]}
    if steps is not None:
        out.update(accumulation=outs[1], depth=outs[2], expected_depth=outs[3])
    if payload is not None:
        out["composite"] = outs[4]
    return out
