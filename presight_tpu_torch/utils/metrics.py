"""Image metrics (presight_tpu/utils/metrics.py): PSNR and SSIM (the
torchmetrics defaults: gaussian kernel 11, sigma 1.5, k1 0.01, k2 0.03,
mean over the valid window positions), in float64 on the host.

LPIPS needs a pretrained network that the port does not have yet:
``lpips_fn`` warns loudly once and returns None, as the JAX package does
when no weights are present, and raises NotImplementedError when
``$PRESIGHT_LPIPS_WEIGHTS`` names weights, rather than ignoring them.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred, gt, data_range: float = 1.0) -> float:
    pred, gt = torch.as_tensor(pred, dtype=torch.float64), torch.as_tensor(gt, dtype=torch.float64)
    mse = float(torch.mean((pred - gt) ** 2))
    return float(10.0 * np.log10(data_range ** 2 / max(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, gt, data_range: float = 1.0, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """SSIM of (H, W, C) images, gaussian-weighted, mean over valid pixels."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel(kernel_size, sigma)[None, None]
    x = torch.as_tensor(pred, dtype=torch.float64).movedim(-1, 0)[:, None]
    y = torch.as_tensor(gt, dtype=torch.float64).movedim(-1, 0)[:, None]

    def filt(img):
        return F.conv2d(img, kern.to(img.device))

    mu_x, mu_y = filt(x), filt(y)
    sigma_x = filt(x * x) - mu_x ** 2
    sigma_y = filt(y * y) - mu_y ** 2
    sigma_xy = filt(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return float(torch.mean(num / den))


_LPIPS_CACHE: Dict[str, Optional[Callable]] = {}


def lpips_fn() -> Optional[Callable[[np.ndarray, np.ndarray], float]]:
    """LPIPS scorer, or None (warned once) while the port has no network."""
    path = os.environ.get("PRESIGHT_LPIPS_WEIGHTS", "")
    if path:
        raise NotImplementedError(
            f"PRESIGHT_LPIPS_WEIGHTS={path!r}: the port has no LPIPS network yet; unset it "
            "or set eval_lpips False")
    if "fn" not in _LPIPS_CACHE:
        warnings.warn(
            "LPIPS requested but the port has NO perceptual network: LPIPS will be ABSENT "
            "from eval metrics this run (set eval_lpips False to silence this).",
            stacklevel=2,
        )
        _LPIPS_CACHE["fn"] = None
    return _LPIPS_CACHE["fn"]
