"""ctypes bindings of the host libraries: the streaming voxel accumulator and
the first-come voxelizer (voxelize.cpp, here) and the JPEG codec (jpeg.cpp,
native/jpeg.py).

``g++`` builds each library at first use into ``<repo>/build/native/``,
keyed on a hash of its source, the way ``kernels.build()`` keys the CUDA
library; nothing is written into the source tree and nothing runs at import.
A build failure raises: the numpy ``StreamingVoxelAccumulator`` of
prior/voxelize.py is the plain version and runs only where
``kernels.use_plain()`` (inside ``kernels.plain_versions()``), never as a
silent fallback, and so does the numpy ``points_to_voxel_plain`` of the
first-come voxelizer; the JPEG codec has none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .. import kernels

SOURCE = Path(__file__).resolve().parent / "voxelize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib: Optional[ctypes.CDLL] = None


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless the library for this exact source exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        handle.voxel_accum_create.restype = ctypes.c_void_p
        handle.voxel_accum_create.argtypes = [ctypes.c_int64, ctypes.c_int]
        handle.voxel_accum_destroy.argtypes = [ctypes.c_void_p]
        handle.voxel_accum_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
        ]
        handle.voxel_accum_size.restype = ctypes.c_int64
        handle.voxel_accum_size.argtypes = [ctypes.c_void_p]
        handle.voxel_accum_finalize.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        handle.points_to_voxel_first_come.restype = ctypes.c_int64
        handle.points_to_voxel_first_come.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = handle
    return _lib


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


class VoxelAccumulator:
    """Streaming voxel mean-downsample. Feed per-frame point batches;
    ``finalize`` returns key-sorted per-voxel means and hits, equal to
    prior/voxelize.StreamingVoxelAccumulator's byte for byte."""

    def __init__(self, voxel_size: float, min_bound: np.ndarray,
                 feature_dim: int = 0, with_colors: bool = True):
        self._lib = lib()
        self._handle = self._lib.voxel_accum_create(feature_dim, 1 if with_colors else 0)
        self.voxel_size = float(voxel_size)
        self.min_bound = np.ascontiguousarray(min_bound, np.float64)
        self.feature_dim = feature_dim
        self.with_colors = with_colors

    def add(self, points: np.ndarray, colors: Optional[np.ndarray] = None,
            features: Optional[np.ndarray] = None) -> None:
        points = np.ascontiguousarray(points, np.float64)
        colors_c = np.ascontiguousarray(colors, np.float32) if colors is not None else None
        feats_c = np.ascontiguousarray(features, np.float32) if features is not None else None
        self._lib.voxel_accum_add(
            self._handle, _ptr(points), _ptr(colors_c), _ptr(feats_c),
            len(points), self.voxel_size, _ptr(self.min_bound),
        )

    def finalize(self) -> Dict[str, np.ndarray]:
        v = self._lib.voxel_accum_size(self._handle)
        points = np.empty((v, 3), np.float64)
        hits = np.empty((v,), np.int64)
        keys = np.empty((v,), np.int64)
        colors = np.empty((v, 3), np.float64) if self.with_colors else None
        feats = np.empty((v, self.feature_dim), np.float64) if self.feature_dim else None
        self._lib.voxel_accum_finalize(
            self._handle, _ptr(points), _ptr(colors), _ptr(feats), _ptr(hits), _ptr(keys),
        )
        out = {"points": points, "hits": hits, "keys": keys}
        if colors is not None:
            out["colors"] = colors
        if feats is not None:
            out["features"] = feats.astype(np.float16)
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.voxel_accum_destroy(self._handle)
            self._handle = None


def points_to_voxel(points: np.ndarray, voxel_size, coors_range, max_points: int = 16,
                    max_voxels: int = 100_000) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-come voxelization (the reference's numba _points_to_voxel_kernel,
    prior_points.py:232-298): voxels appear in point order up to
    ``max_voxels``, each keeps its first ``max_points`` points. Returns
    (voxels (V, max_points, ndim), coors (V, 3) in (z, y, x), counts (V,)).
    The numpy version runs instead of the C++ one where
    ``kernels.use_plain()``."""
    points = np.ascontiguousarray(points, np.float32)
    n, ndim = points.shape
    vs = np.ascontiguousarray(voxel_size, np.float32)
    cr = np.ascontiguousarray(coors_range, np.float32)
    if kernels.use_plain():
        return points_to_voxel_plain(points, vs, cr, max_points, max_voxels)
    voxels = np.zeros((max_voxels, max_points, ndim), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    v = lib().points_to_voxel_first_come(
        _ptr(points), n, ndim, _ptr(vs), _ptr(cr), max_points, max_voxels,
        _ptr(voxels), _ptr(coors), _ptr(counts))
    return voxels[:v], coors[:v], counts[:v]


def points_to_voxel_plain(points, voxel_size, coors_range, max_points, max_voxels):
    """The numpy version of points_to_voxel, with the same first-come rule
    and the same f32 voxel arithmetic."""
    points = np.ascontiguousarray(points, np.float32)
    voxel_size = np.asarray(voxel_size, np.float32)
    coors_range = np.asarray(coors_range, np.float32)
    grid = np.round((coors_range[3:] - coors_range[:3]) / voxel_size).astype(np.int32)
    c = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(np.int32)
    ok = ((c >= 0) & (c < grid)).all(axis=1)
    voxels = np.zeros((max_voxels, max_points, points.shape[1]), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    key_to_vid = {}
    v = 0
    for i in np.nonzero(ok)[0]:
        key = (int(c[i, 2]), int(c[i, 1]), int(c[i, 0]))
        vid = key_to_vid.get(key)
        if vid is None:
            if v >= max_voxels:
                continue
            vid = v
            key_to_vid[key] = vid
            coors[vid] = key
            v += 1
        if counts[vid] < max_points:
            voxels[vid, counts[vid]] = points[i]
            counts[vid] += 1
    return voxels[:v], coors[:v], counts[:v]
