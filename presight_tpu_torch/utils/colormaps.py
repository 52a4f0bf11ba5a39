"""Feature -> RGB colormaps (presight_tpu/utils/colormaps.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .precision import ieee_matmul

COLORMAP_KEYS = ("reduction_matrix", "mean", "rgb_min", "rgb_max")


def colormap_on(dino_to_rgb: Dict, device) -> Dict[str, torch.Tensor]:
    """The PCA reduction's arrays as f32 tensors on ``device``: made once, so
    that colouring on the card uploads nothing."""
    return {k: torch.as_tensor(np.asarray(dino_to_rgb[k], np.float32), device=device)
            for k in COLORMAP_KEYS}


def feature_colormap(features: torch.Tensor, colormap: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Features (..., D) -> rgb (..., 3) in [0, 1] by the stored PCA
    reduction (``colormap_on``, on the features' device) and per-channel
    min/max, in IEEE f32 whatever the process's TF32 setting."""
    with ieee_matmul():
        img = (features.float() - colormap["mean"]) @ colormap["reduction_matrix"]
    img = (img - colormap["rgb_min"]) / (colormap["rgb_max"] - colormap["rgb_min"])
    return torch.clamp(img, 0.0, 1.0)


def apply_feature_colormap(features: np.ndarray, dino_to_rgb: Dict) -> np.ndarray:
    """``feature_colormap`` of a numpy array, on the CPU."""
    return feature_colormap(torch.from_numpy(np.ascontiguousarray(features)),
                            colormap_on(dino_to_rgb, "cpu")).numpy()
