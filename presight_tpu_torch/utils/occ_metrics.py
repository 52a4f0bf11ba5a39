"""Occ3D-nuScenes occupancy mIoU metric (numpy; the port's copy of
presight_tpu/utils/occ_metrics.py).

Reference spec: occupancy/mmdet3d/datasets/occ_metrics.py:52-150
(Metric_mIoU): 18 classes (17 semantic + free), confusion-matrix
accumulation with optional camera/lidar visibility masks, per-class IoU =
diag / (row + col - diag). Grid: pc range [-40,-40,-1, 40,40,5.4] at 0.4 m.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

OCC3D_CLASS_NAMES = [
    "others", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk",
    "terrain", "manmade", "vegetation", "free",
]


class MetricMIoU:
    """Streaming occupancy mIoU (Metric_mIoU equivalent)."""

    def __init__(self, num_classes: int = 18, use_image_mask: bool = False,
                 use_lidar_mask: bool = False):
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.hist = np.zeros((num_classes, num_classes), np.float64)
        self.cnt = 0

    @staticmethod
    def _hist(n_cl: int, pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
        """Confusion matrix over labeled voxels (occ_metrics.py:78-105);
        labels outside [0, n_cl) (e.g. 255 ignore) are excluded."""
        k = (gt >= 0) & (gt < n_cl)
        return np.bincount(
            n_cl * gt[k].astype(np.int64) + pred[k].astype(np.int64),
            minlength=n_cl ** 2,
        ).reshape(n_cl, n_cl)

    def add_batch(self, pred: np.ndarray, gt: np.ndarray,
                  mask_camera: Optional[np.ndarray] = None,
                  mask_lidar: Optional[np.ndarray] = None) -> None:
        pred = np.asarray(pred).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        if self.use_image_mask and mask_camera is not None:
            m = np.asarray(mask_camera).reshape(-1).astype(bool)
            pred, gt = pred[m], gt[m]
        elif self.use_lidar_mask and mask_lidar is not None:
            m = np.asarray(mask_lidar).reshape(-1).astype(bool)
            pred, gt = pred[m], gt[m]
        self.hist += self._hist(self.num_classes, pred, gt)
        self.cnt += 1

    def per_class_iou(self) -> np.ndarray:
        denom = self.hist.sum(1) + self.hist.sum(0) - np.diag(self.hist)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(self.hist) / denom

    def miou(self, exclude_free: bool = True) -> float:
        """Mean IoU over semantic classes (the README tables exclude the
        'free' class, occ_metrics.py count_miou convention)."""
        ious = self.per_class_iou()
        sel = ious[: self.num_classes - 1] if exclude_free else ious
        return float(np.nanmean(sel) * 100.0)

    def summary(self) -> Dict[str, float]:
        ious = self.per_class_iou()
        out = {name: float(iou * 100.0)
               for name, iou in zip(OCC3D_CLASS_NAMES[: self.num_classes], ious)}
        out["mIoU"] = self.miou()
        return out
