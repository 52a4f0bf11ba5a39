"""Feature -> RGB colormaps (presight_tpu/utils/colormaps.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def apply_feature_colormap(features: np.ndarray, dino_to_rgb: Dict) -> np.ndarray:
    """Features (..., D) -> rgb (..., 3) in [0, 1] by the stored PCA
    reduction and per-channel min/max."""
    red = np.asarray(dino_to_rgb["reduction_matrix"], np.float32)
    rgb_min = np.asarray(dino_to_rgb["rgb_min"], np.float32)
    rgb_max = np.asarray(dino_to_rgb["rgb_max"], np.float32)
    mean = np.asarray(dino_to_rgb["mean"], np.float32)
    img = (features.astype(np.float32) - mean) @ red
    img = (img - rgb_min) / (rgb_max - rgb_min)
    return np.clip(img, 0.0, 1.0)
