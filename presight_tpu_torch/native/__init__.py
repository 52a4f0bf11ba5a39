"""ctypes bindings of the host libraries: the streaming voxel accumulator
(voxelize.cpp, here) and the JPEG codec (jpeg.cpp, native/jpeg.py).

``g++`` builds each library at first use into ``<repo>/build/native/``,
keyed on a hash of its source, the way ``kernels.build()`` keys the CUDA
library; nothing is written into the source tree and nothing runs at import.
A build failure raises: the numpy ``StreamingVoxelAccumulator`` of
prior/voxelize.py is the plain version and is chosen only by an explicit
argument, never as a silent fallback; the JPEG codec has none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

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
