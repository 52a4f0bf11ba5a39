"""One training step (the dense branch of presight_tpu/engine/train_step.py
``_make_split_train_step``): the ray batch is split into microbatches; each
runs ray generation, ``forward(train=True)``, ``compute_losses`` and the
backward pass with its own draws; gradients, losses and the mse are
averaged over the microbatches; then one optimizer and scheduler step.

Each microbatch's ``.backward()`` adds its gradients into ``.grad`` in
order, and the sum is scaled by 1/k at the end, as the JAX scan adds its
carried gradients and scales them once. The hash tables' gradients arrive
the same way but not through autograd's AccumulateGrad: the hash
encoding's backward (K5) adds them into the tables' ``.grad`` itself,
allocating it at the first microbatch, since ``.grad`` is set to None here
(ops/hash_encoding.py). So the step must call ``.backward()`` (not
``torch.autograd.grad``), and a hook on the tables never runs.
``stop_prop_grad`` is an argument: the JAX package compiles one step per
value.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..data.cameras import CameraParams, generate_rays
from ..models.nerfacto_ms import NerfactoNuscMS, compute_losses
from ..utils.profiler import span
from .optimizers import GroupOptimizer


class StepScalars(NamedTuple):
    """Host-computed schedule values of one step."""

    anneal: float
    sigma: float  # line-of-sight sigma
    los_mult: float  # line-of-sight multiplier


def psnr(mse: float) -> float:
    return -10.0 * math.log10(max(mse, 1e-12))


def draw_uniforms(model: NerfactoNuscMS, num_rays: int, generator: torch.Generator,
                  device) -> List[torch.Tensor]:
    """One (R, 1) single-jitter draw per sampling round (proposal rounds and
    the final one), from ``generator``."""
    rounds = len(model.config.num_proposal_samples_per_ray) + 1
    return [torch.rand((num_rays, 1), generator=generator, device=device)
            for _ in range(rounds)]


def train_step(model: NerfactoNuscMS, optimizers: Dict[str, GroupOptimizer],
               cameras: CameraParams, batch: Dict[str, torch.Tensor], scalars: StepScalars,
               stop_prop_grad: bool, microbatch_rays: int,
               prop_grid: Optional[torch.Tensor] = None,
               draws: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, float]:
    """Update ``model`` in place with one step over ``batch`` (ray_index
    (R, 3) and the targets). ``draws``: per microbatch, the uniforms of
    each sampling round (a test passes JAX's); otherwise they come from
    ``generator``. Returns the metrics: each loss, total_loss and psnr."""
    config = model.config
    num_rays = batch["ray_index"].shape[0]
    micro = min(microbatch_rays, num_rays)
    if num_rays % micro != 0:
        raise ValueError(f"ray batch ({num_rays}) must be divisible by microbatch_rays "
                         f"({micro})")
    k = num_rays // micro
    params = [p for opt in optimizers.values() for p in opt.params]
    for p in params:
        p.grad = None
    totals: Dict[str, torch.Tensor] = {}
    mse_sum = total_sum = 0.0
    device = batch["ray_index"].device
    for i in range(k):
        chunk = {key: v[i * micro:(i + 1) * micro] for key, v in batch.items()}
        with span("nerf.forward"):
            uniforms = (draws[i] if draws is not None
                        else draw_uniforms(model, micro, generator, device))
            bundle = generate_rays(cameras, chunk["ray_index"])
            outputs = model(bundle, train=True, prop_grid=prop_grid, anneal=scalars.anneal,
                            uniforms=uniforms, stop_prop_grad=stop_prop_grad)
            losses = compute_losses(outputs, chunk, config, scalars.sigma, scalars.los_mult)
            total = sum(losses.values())
        with span("nerf.backward"):
            total.backward()
        with torch.no_grad():
            for key, v in losses.items():
                totals[key] = totals[key] + v if key in totals else v.detach()
            total_sum = total_sum + total.detach()
            if "rgb" in chunk:
                mse_sum = mse_sum + torch.mean((outputs["rgb"] - chunk["rgb"]) ** 2)
    inv = 1.0 / k
    with span("nerf.optimizer"):
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
        for opt in optimizers.values():
            opt.step()
    with span("nerf.metrics"):
        metrics = {key: float(v) * inv for key, v in totals.items()}
        metrics["total_loss"] = float(total_sum) * inv
        metrics["psnr"] = psnr(float(mse_sum) * inv)
    return metrics
