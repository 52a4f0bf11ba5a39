"""Image metrics (presight_tpu/utils/metrics.py): PSNR and SSIM (the
torchmetrics defaults: gaussian kernel 11, sigma 1.5, k1 0.01, k2 0.03,
mean over the valid window positions), in float64 on the host, and the
LPIPS scorer (utils/lpips.py) with weights from ``$PRESIGHT_LPIPS_WEIGHTS``.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional, Tuple

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


_LPIPS_CACHE: Dict[Tuple[str, str], Optional[Callable]] = {}


def _read_lpips_state(path: str) -> Dict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return dict(z)
    return torch.load(path, map_location="cpu")


def lpips_fn(device=None) -> Optional[Callable[[np.ndarray, np.ndarray], float]]:
    """LPIPS scorer ``(pred, gt) HxWx3 float [0, 1] -> float`` on ``device``
    (the CUDA card unless the caller passes another), or None.

    The weights come from the file ``$PRESIGHT_LPIPS_WEIGHTS`` names: a torch
    LPIPS state_dict saved as an ``.npz`` of numpy arrays, or any other file
    ``torch.load`` reads. A named file that cannot be loaded raises (the JAX
    package falls through to torchmetrics, which the port does not have).
    With no file named, warns once and returns None: LPIPS is then absent
    from the metrics, as in the JAX package without weights."""
    device = torch.device(device if device is not None else "cuda")
    path = os.environ.get("PRESIGHT_LPIPS_WEIGHTS", "")
    key = (path, str(device) if path else "")
    if key in _LPIPS_CACHE:
        return _LPIPS_CACHE[key]
    if not path:
        warnings.warn(
            "LPIPS requested but NO perceptual weights are available: set "
            "$PRESIGHT_LPIPS_WEIGHTS to a torch LPIPS state_dict (.npz/.pt). LPIPS will be "
            "ABSENT from eval metrics this run.",
            stacklevel=2,
        )
        _LPIPS_CACHE[key] = None
        return None
    from . import lpips as L

    try:
        params = L.to_device(L.load_torch_state_dict(_read_lpips_state(path)), device)
    except Exception as e:
        e.add_note(f"while loading the LPIPS weights $PRESIGHT_LPIPS_WEIGHTS={path!r}")
        raise

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def fn(pred: np.ndarray, gt: np.ndarray) -> float:
        return float(L.lpips(params, put(pred), put(gt)))

    _LPIPS_CACHE[key] = fn
    return fn
