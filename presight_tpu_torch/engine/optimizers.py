"""Optimizers and learning-rate schedules (presight_tpu/engine/optimizers.py).

One ``torch.optim.Adam`` per parameter group (betas 0.9, 0.999; eps and
weight decay from the group's config) with a ``LambdaLR`` holding the
warmup-multistep schedule. torch's ``weight_decay`` adds wd * param to the
gradient before the moments, as optax's ``add_decayed_weights`` before
``scale_by_adam`` does. Frozen buffers are not handed to any optimizer, so
they stay unchanged, as under ``optax.set_to_zero``. Adam is plain PyTorch:
the JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..configs import OptimizerGroupConfig


def warmup_multistep_factor(cfg: OptimizerGroupConfig, step: int) -> float:
    """lr(step) / lr: a linear warmup from warmup_start_factor over
    warmup_steps, times gamma per milestone reached; computed in f32 as the
    JAX schedule is."""
    f32 = np.float32
    t = f32(max(cfg.warmup_steps, 1))
    warm = f32(cfg.warmup_start_factor) + (f32(1.0) - f32(cfg.warmup_start_factor)) * \
        np.minimum(f32(step), t) / t
    decay_pow = f32(sum(step >= m for m in cfg.milestones))
    return float(warm * f32(cfg.gamma) ** decay_pow)


def warmup_multistep_schedule(cfg: OptimizerGroupConfig):
    """step -> learning rate."""
    return lambda step: float(np.float32(cfg.lr) * np.float32(warmup_multistep_factor(cfg, step)))


class GroupOptimizer:
    """Adam + LambdaLR for one group of parameters."""

    def __init__(self, params: List[torch.nn.Parameter], cfg: OptimizerGroupConfig):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.eps,
                                     weight_decay=cfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adam, lambda step: warmup_multistep_factor(cfg, step))

    def step(self) -> None:
        """One Adam step; a parameter without a gradient takes a zero
        gradient, so its moments and weight decay advance as under optax
        (JAX's gradient tree is dense)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.adam.step()
        self.scheduler.step()


def make_optimizers(groups: Dict[str, List[torch.nn.Parameter]],
                    configs: Dict[str, OptimizerGroupConfig]) -> Dict[str, GroupOptimizer]:
    """One GroupOptimizer per group of ``groups`` (NerfactoNuscMS.groups())."""
    missing = sorted(set(groups) - set(configs))
    if missing:
        raise ValueError(f"no optimizer config for parameter groups {missing}")
    return {name: GroupOptimizer(params, configs[name]) for name, params in groups.items()}
