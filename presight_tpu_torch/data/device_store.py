"""Device-resident ray stores (presight_tpu/data/device_store.py): each
step's batch values are gathered on the device, so only indices cross from
the host.

  * DeviceRayStore: the whole per-pixel training set on the device, rows
    ``(image_index * H + v) * W + u``; ``maybe_build`` stages it from the
    dataparser's items when every image has one size and the set fits
    under the cap (the JAX package's size rule), else returns None.
  * ChunkDeviceStore: the active chunk's sampled rows (padded to a
    power-of-two multiple of 2^16 rows), the next chunk staged behind the
    current one's steps from the DataManager's prefetch thread, at most two
    resident. A chunk over the cap turns the store off for the run and the
    DataManager hands out host values, as in the JAX package.

Gathered batches equal the host path's rows bit for bit. Staging on a CUDA
device copies from pinned memory on a side stream and records an event;
the gather makes the current stream wait on it, so the copy neither races
with the step nor serialises with it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import constants as K


def _pad_rows_pow2(n: int, multiple: int = 1 << 16) -> int:
    """Round a chunk's row count up to a power-of-two multiple of 2^16."""
    units = max(1, -(-n // multiple))
    return (1 << (units - 1).bit_length()) * multiple


class ChunkDeviceStore:
    """Chunk-granularity staging for datasets over the DeviceRayStore cap."""

    def __init__(self, cap_mb: int, device=None):
        self.cap_bytes = cap_mb * 2 ** 20
        self.device = torch.device(device if device is not None else "cuda")
        self.enabled = True
        self._lock = threading.Lock()
        self._staged: Dict[int, tuple] = {}  # chunk id -> (tensors, event, pinned host copies)
        self._stream: Optional[torch.cuda.Stream] = None

    def stage(self, chunk_id: int, data: Dict[str, np.ndarray]) -> bool:
        """Upload one chunk's rows (padded). Returns False, and turns the
        store off for the run, when two padded chunks exceed the cap."""
        if not self.enabled:
            return False
        n = len(data[K.RGB])
        n_pad = _pad_rows_pow2(n)
        nbytes = sum(n_pad * int(np.prod(v.shape[1:], dtype=np.int64)) * v.dtype.itemsize
                     for v in data.values())
        if 2 * nbytes > self.cap_bytes:
            with self._lock:
                self.enabled = False
                self._staged.clear()
            return False
        host = {k: torch.from_numpy(np.pad(v, [(0, n_pad - n)] + [(0, 0)] * (v.ndim - 1)))
                for k, v in data.items()}
        event = None
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            host = {k: v.pin_memory() for k, v in host.items()}
            with torch.cuda.stream(self._stream):
                staged = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            staged = {k: v.to(self.device) for k, v in host.items()}
            host = None
        with self._lock:
            if not self.enabled:
                return False
            self._staged[chunk_id] = (staged, event, host)
        return True

    def retain_only(self, chunk_ids) -> None:
        keep = set(chunk_ids)
        with self._lock:
            for cid in list(self._staged):
                if cid not in keep:
                    del self._staged[cid]

    def has(self, chunk_id: int) -> bool:
        with self._lock:
            return chunk_id in self._staged

    def batch(self, chunk_id: int, sel: np.ndarray) -> Dict[str, torch.Tensor]:
        """Rows ``sel`` of a staged chunk, every key, on the device."""
        with self._lock:
            staged, event, _ = self._staged[chunk_id]
        idx = torch.from_numpy(np.asarray(sel, np.int64)).to(self.device)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in staged.values():
                # Side-stream memory read here: not reused before this
                # stream is done with it.
                t.record_stream(stream)
        return {k: staged[k][idx] for k in sorted(staged)}


class DeviceRayStore:
    """Flat (N_img * H * W, C) per-pixel tensors, row
    ``(image_index * H + v) * W + u``. Built from numpy arrays of one image
    size: rgb (N_img, H, W, 3) in [0, 1], sky (N_img, H, W) as 1.0 / 0.0,
    depth (N_img, H, W) and optional features (N_img, H, W, D), kept in
    their own dtype (f16 or f32) and handed out as f32."""

    # The most recent store, keyed by the dataset's identity, so successive
    # trainers over the same data reuse one upload.
    _cache: Dict[tuple, "DeviceRayStore"] = {}

    def __init__(self, rgb: np.ndarray, sky: np.ndarray, depth: np.ndarray,
                 features: Optional[np.ndarray] = None, device=None):
        n, H, W, _ = rgb.shape
        if sky.shape != (n, H, W) or depth.shape != (n, H, W):
            raise ValueError("DeviceRayStore: rgb (N, H, W, 3), sky and depth (N, H, W) expected")
        if features is not None and features.dtype not in (np.float16, np.float32):
            raise ValueError(f"DeviceRayStore: f16 or f32 features, got {features.dtype}")
        self.device = torch.device(device if device is not None else "cuda")
        self.num_images, self.H, self.W = n, H, W

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        self.rgb = put(rgb.reshape(-1, 3), np.float32)
        self.sky = put(sky.reshape(-1), np.float32)
        self.depth = put(depth.reshape(-1), np.float32)
        self.features = (None if features is None
                         else put(features.reshape(n * H * W, -1), features.dtype))

    @classmethod
    def from_items(cls, items: List, load_features: bool, device=None) -> "DeviceRayStore":
        """Load every item (one image size; rows indexed by image_index) the
        way the chunk dataset loads them: rgb, sky from the segmentation,
        depth and f32 features."""
        H, W = items[0].H, items[0].W
        n = max(it.image_index for it in items) + 1
        rgb = np.zeros((n, H, W, 3), np.float32)
        sky = np.zeros((n, H, W), np.float32)
        depth = np.zeros((n, H, W), np.float32)
        feat = None
        for it in items:
            i = it.image_index
            rgb[i] = it.load_image()
            sky[i] = (it.load_segmentation() == K.SKY_CLASS_ID).astype(np.float32)
            depth[i] = it.load_depth()
            if load_features:
                f = it.load_features().astype(np.float32)
                if feat is None:
                    feat = np.zeros((n, H, W, f.shape[-1]), np.float32)
                feat[i] = f
        return cls(rgb, sky, depth, feat, device=device)

    @classmethod
    def maybe_build(cls, items: List, load_features: bool, cap_mb: int,
                    device=None) -> Optional["DeviceRayStore"]:
        """Build (or fetch from the cache) iff every image shares one size
        and the staged tensors, counted at 4 bytes a value, fit under
        ``cap_mb``."""
        if not items or cap_mb <= 0:
            return None
        H, W = items[0].H, items[0].W
        if any(it.H != H or it.W != W for it in items):
            return None
        feat_dim = 0
        if load_features:
            f0 = items[0].feature_path
            if f0 is None:
                load_features = False
            else:
                try:
                    if str(f0).endswith(".npz"):
                        with np.load(f0) as z:
                            name = "arr_0" if "arr_0" in z.files else z.files[0]
                            feat_dim = int(z[name].shape[-1])
                    else:
                        feat_dim = int(np.load(f0, mmap_mode="r").shape[-1])
                except (OSError, ValueError, KeyError, IndexError):
                    return None
        n = max(it.image_index for it in items) + 1
        size_mb = n * H * W * (3 + 1 + 1 + feat_dim) * 4 / 2 ** 20
        if size_mb > cap_mb:
            return None
        device = torch.device(device if device is not None else "cuda")
        key = (tuple(str(it.image_path) for it in items), load_features, H, W, feat_dim,
               str(device))
        store = cls._cache.get(key)
        if store is None:
            store = cls.from_items(items, load_features, device=device)
            cls._cache.clear()
            cls._cache[key] = store
        return store

    def __len__(self) -> int:
        return self.num_images * self.H * self.W

    def ray_index(self, rows: np.ndarray) -> np.ndarray:
        """(image, v, u) int32 of flat rows."""
        rows = np.asarray(rows, np.int64)
        u = rows % self.W
        v = (rows // self.W) % self.H
        return np.stack([rows // (self.H * self.W), v, u], -1).astype(np.int32)

    def batch(self, ray_index: np.ndarray, with_features: bool = True) -> Dict[str, torch.Tensor]:
        """The batch of ``ray_index`` (R, 3): ray_index, rgb, sky, depth and,
        when asked and stored, f32 features, all on the device."""
        idx = torch.from_numpy(np.ascontiguousarray(ray_index, np.int32)).to(self.device)
        flat = (idx[:, 0].long() * self.H + idx[:, 1].long()) * self.W + idx[:, 2].long()
        out = {"ray_index": idx, "rgb": self.rgb[flat], "sky": self.sky[flat],
               "depth": self.depth[flat]}
        if with_features and self.features is not None:
            out["features"] = self.features[flat].float()
        return out
