"""Model EMA with the MEGVII/BEVDepth ramped decay, the port of
presight_tpu/utils/ema.py (reference occupancy/mmdet3d/core/hook/ema.py,
ModelEMA + MEGVIIEMAHook):

  d(t)  = decay * (1 - exp(-t / ramp))
  ema_t = d(t) * ema_{t-1} + (1 - d(t)) * params_t
  t starts at 1 on the first update; resume restores (ema, t).

The EMA walks the model's floating-point state_dict, parameters and
BatchNorm running statistics together, as the reference hook walks the
model's state (ema.py:48-59). The counter stays on the host and d(t) is
computed there in float32, as the JAX package computes it on the device, so
an update syncs nothing.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch import nn


class EMAState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the EMA of each floating-point state_dict entry
    updates: int  # updates made so far (the ramp's t - 1)


def _float_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


@torch.no_grad()
def ema_init(model: nn.Module, init_updates: int = 0) -> EMAState:
    """The EMA starts as a copy of the model's state (ema.py:39).
    ``init_updates`` seeds the ramp counter (MEGVIIEMAHook resumes with
    ``init_updates=10560`` in the shipped PreSight config), which puts d(t)
    at the asymptotic decay at once."""
    return EMAState({k: v.detach().clone() for k, v in _float_state(model).items()},
                    int(init_updates))


def ema_decay(t: int, decay: float = 0.9990, ramp: float = 2000.0) -> float:
    """d(t) in float32, as the JAX package computes it."""
    t32 = np.float32(t)
    return float(np.float32(decay) * (np.float32(1.0) - np.exp(-t32 / np.float32(ramp))))


@torch.no_grad()
def ema_update(state: EMAState, model: nn.Module, decay: float = 0.9990,
               ramp: float = 2000.0) -> EMAState:
    """One EMA step (ema.py:48-59), in place on ``state.params``; returns
    the state with the counter advanced."""
    t = state.updates + 1
    d = ema_decay(t, decay, ramp)
    one_minus = float(np.float32(1.0) - np.float32(d))
    current = _float_state(model)
    keys = list(state.params)
    ema = [state.params[k] for k in keys]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [current[k] for k in keys], alpha=one_minus)
    return EMAState(state.params, t)
