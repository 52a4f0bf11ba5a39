"""Voxel downsampling — the Open3D `voxel_down_sample_and_trace` replacement.

The streaming half of presight_tpu/prior/voxelize.py (numpy only), copied
because the port imports nothing of the JAX package. The native accumulator
is the port's own (``presight_tpu_torch.native``).

Reference spec: nerfstudio-0.3.3/nerfstudio/scripts/extract_priors.py:216-245
(Open3D voxel_down_sample_and_trace at voxel_size=0.4, min_bound =
points.min(0) - 1.0) and :178-197 (per-voxel mean color, float64-accumulated
mean feature, hit counts, hit-quantile filter). The reference needs up to
300 GB host RAM for this step (docs/building_priors.md:65); here it is a
sort/segment reduction over integer voxel keys — O(N log N) time, O(N)
memory, identical bucketing (floor((p - min_bound) / voxel_size)) and
identical outputs (per-voxel mean of points / colors / features).

Runs on the host (the merge is memory-bound, not FLOP-bound).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import kernels


def voxel_keys(points: np.ndarray, voxel_size: float, min_bound: np.ndarray) -> np.ndarray:
    """Open3D bucketing: int voxel coords -> flat int64 key."""
    ijk = np.floor((points - min_bound) / voxel_size).astype(np.int64)
    # Flat key with generous per-axis range (city tiles are km-scale; 2^21
    # voxels/axis at 0.4 m = 838 km).
    return (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]


class StreamingVoxelAccumulator:
    """Pure-numpy streaming voxel mean-downsample — the plain version of
    native.VoxelAccumulator, with identical outputs.

    Feed per-frame batches with ``add``; memory is O(unique voxels), never
    O(total points) (the reference's Open3D pass needs up to 300 GB host RAM
    at full scale, docs/building_priors.md:65). Exactness: per-voxel sums
    accumulate point-by-point in arrival order via ``np.add.at`` (unbuffered,
    sequential), the same operand order as the native C++ accumulator and
    the JAX package's one-shot ``voxel_downsample`` -- so they produce
    byte-identical f64 sums, not merely close ones.
    """

    def __init__(self, voxel_size: float, min_bound: np.ndarray,
                 feature_dim: int = 0, with_colors: bool = True):
        self.voxel_size = float(voxel_size)
        self.min_bound = np.asarray(min_bound, np.float64)
        self.feature_dim = int(feature_dim)
        self.with_colors = with_colors
        self._keys = np.zeros((0,), np.int64)  # insertion order
        self._sorted_keys = np.zeros((0,), np.int64)
        self._rows_of_sorted = np.zeros((0,), np.int64)
        self._sum_pts = np.zeros((0, 3), np.float64)
        self._sum_cols = np.zeros((0, 3), np.float64) if with_colors else None
        self._sum_feats = (np.zeros((0, feature_dim), np.float64)
                           if feature_dim else None)
        self._hits = np.zeros((0,), np.int64)

    def add(self, points: np.ndarray, colors: Optional[np.ndarray] = None,
            features: Optional[np.ndarray] = None) -> None:
        if len(points) == 0:
            return
        keys = voxel_keys(np.asarray(points, np.float64), self.voxel_size,
                          self.min_bound)
        u, inv = np.unique(keys, return_inverse=True)
        # Resolve rows of already-known keys against the CURRENT index
        # before any growth (growing rebuilds the sorted index).
        if len(self._sorted_keys) == 0:
            exists = np.zeros(len(u), bool)
            rows_exist = np.zeros((0,), np.int64)
        else:
            pos = np.searchsorted(self._sorted_keys, u)
            pos_c = np.clip(pos, 0, len(self._sorted_keys) - 1)
            exists = self._sorted_keys[pos_c] == u
            rows_exist = self._rows_of_sorted[pos_c[exists]]
        new_u = u[~exists]
        n_old = len(self._keys)
        if len(new_u):
            grow = len(new_u)
            self._keys = np.concatenate([self._keys, new_u])
            self._sum_pts = np.concatenate(
                [self._sum_pts, np.zeros((grow, 3), np.float64)]
            )
            if self._sum_cols is not None:
                self._sum_cols = np.concatenate(
                    [self._sum_cols, np.zeros((grow, 3), np.float64)]
                )
            if self._sum_feats is not None:
                self._sum_feats = np.concatenate(
                    [self._sum_feats, np.zeros((grow, self.feature_dim), np.float64)]
                )
            self._hits = np.concatenate([self._hits, np.zeros((grow,), np.int64)])
            order = np.argsort(self._keys, kind="stable")
            self._sorted_keys = self._keys[order]
            self._rows_of_sorted = order.astype(np.int64)
        row_of_u = np.empty(len(u), np.int64)
        row_of_u[exists] = rows_exist
        if len(new_u):
            # Rows of the new keys: find them in the rebuilt sorted index.
            pos_new = np.searchsorted(self._sorted_keys, new_u)
            row_of_u[~exists] = self._rows_of_sorted[pos_new]
        rows = row_of_u[inv]
        np.add.at(self._sum_pts, rows, np.asarray(points, np.float64))
        if self._sum_cols is not None and colors is not None:
            np.add.at(self._sum_cols, rows, np.asarray(colors, np.float64))
        if self._sum_feats is not None and features is not None:
            np.add.at(self._sum_feats, rows, np.asarray(features, np.float64))
        np.add.at(self._hits, rows, 1)

    def finalize(self) -> Dict[str, np.ndarray]:
        order = np.argsort(self._keys, kind="stable")  # key-sorted output
        hits = self._hits[order]
        denom = np.maximum(hits, 1)[:, None].astype(np.float64)
        out = {
            "points": self._sum_pts[order] / denom,
            "hits": hits,
            "keys": self._keys[order],
        }
        if self._sum_cols is not None:
            out["colors"] = self._sum_cols[order] / denom
        if self._sum_feats is not None:
            out["features"] = (self._sum_feats[order] / denom).astype(np.float16)
        return out


def make_streaming_accumulator(voxel_size: float, min_bound: np.ndarray,
                               feature_dim: int = 0, with_colors: bool = True):
    """The port's native C++ accumulator (built with g++ at first use; a
    failed build raises), or its plain numpy version where
    ``kernels.use_plain()`` -- the same bytes either way
    (tests/test_torch_native.py)."""
    if kernels.use_plain():
        return StreamingVoxelAccumulator(voxel_size, min_bound, feature_dim, with_colors)
    from ..native import VoxelAccumulator

    return VoxelAccumulator(voxel_size, min_bound, feature_dim, with_colors)


def hit_quantile_filter(
    voxels: Dict[str, np.ndarray], hit_thr_ratio: float = 0.2
) -> Dict[str, np.ndarray]:
    """Keep voxels with hits > quantile(hits, ratio)
    (extract_priors.py:191-197)."""
    hits = voxels["hits"]
    if len(hits) == 0:
        return voxels
    thr = np.quantile(hits, hit_thr_ratio)
    sel = hits > thr
    return {k: v[sel] for k, v in voxels.items()}
