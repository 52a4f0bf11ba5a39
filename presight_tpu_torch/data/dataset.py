"""Chunked pixel dataset (presight_tpu/data/dataset.py): an epoch is a
stream of image chunks. A chunk picks ``images_per_chunk`` images
(group-balanced across the k-means tiles, from a generator seeded by the
chunk's step), loads each, masks out dynamic classes and the ego mask,
subsamples ``chunk_ratio`` of the valid pixels per image, and emits flat
per-pixel numpy arrays; the same numpy streams as the JAX package give the
same chunks. Images load in a thread pool: the JPEG codec releases the
interpreter lock while it decodes.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import constants as K
from .image_metadata import ImageMetadata


@dataclasses.dataclass
class PixelChunk:
    """Flat per-pixel arrays; RAY_INDEX rows are (image, row, col)."""

    data: Dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))


class PixelChunkDataset:
    """Chunks of per-pixel rows from the items of one split."""

    def __init__(
        self,
        items: Sequence[ImageMetadata],
        group_flags: Optional[np.ndarray],
        split: str = "train",
        images_per_chunk: int = 512,
        chunk_ratio: float = 0.025,
        group_balanced: bool = True,
        load_features: bool = True,
        mask_seg_classes: Tuple[str, ...] = K.DEFAULT_MASK_SEG_CLASSES,
        num_threads: int = 8,
    ):
        self.items = [
            it for it in items
            if (split == "train" and not it.is_val)
            or (split == "val" and it.is_val)
            or split == "all"
        ]
        if group_flags is None:
            group_flags = np.zeros(len(self.items), np.int64)
        self.group_flags = np.asarray(group_flags)
        self.all_groups = np.unique(self.group_flags)
        self.split = split
        self.images_per_chunk = images_per_chunk
        self.chunk_ratio = chunk_ratio
        self.group_balanced = group_balanced
        self.load_features = load_features
        self.mask_classes_id = np.array(
            [K.CITYSCAPE_CLASSES.index(c) for c in mask_seg_classes], np.uint8
        )
        self.num_threads = num_threads

    def _choose_images(self, rng: np.random.Generator) -> List[int]:
        """Group-balanced image choice (my_dataset.py:165-191)."""
        if self.images_per_chunk == -1:
            return list(range(len(self.items)))
        if self.group_balanced and len(self.all_groups) > 1:
            chosen: List[int] = []
            per_group = self.images_per_chunk // len(self.all_groups)
            for g in self.all_groups:
                group_idx = np.nonzero(self.group_flags == g)[0]
                chosen.extend(
                    rng.choice(group_idx, size=min(per_group, len(group_idx)),
                               replace=False).tolist()
                )
            return chosen
        return rng.choice(
            np.arange(len(self.items)),
            size=min(self.images_per_chunk, len(self.items)),
            replace=False,
        ).tolist()

    def _load_one(self, item: ImageMetadata, seed: int) -> Dict[str, np.ndarray]:
        """Load + mask + subsample one image (my_dataset.py:286-330)."""
        rgb = item.load_image().reshape(-1, 3)
        mask = item.load_mask().reshape(-1)
        seg = item.load_segmentation().reshape(-1)
        depth = item.load_depth().reshape(-1)

        seg_mask = ~np.isin(seg, self.mask_classes_id)
        sky = (seg == K.SKY_CLASS_ID).astype(np.float32)

        keep = np.nonzero(mask & seg_mask)[0]
        rng = np.random.default_rng(seed)
        n_pick = int(len(keep) * self.chunk_ratio)
        picked = rng.choice(keep, size=n_pick, replace=False)

        out = {
            K.RGB: rgb[picked],
            K.SEG: seg[picked],
            K.SKY: sky[picked],
            K.DEPTH: depth[picked],
            K.RAY_INDEX: np.stack(
                [
                    np.full(n_pick, item.image_index, np.int32),
                    (picked // item.W).astype(np.int32),
                    (picked % item.W).astype(np.int32),
                ],
                axis=-1,
            ),
            K.VIDEO_ID: np.full(n_pick, item.video_id, np.int32),
        }
        if self.load_features:
            feats = item.load_features()
            out[K.FEATURES] = feats.reshape(-1, feats.shape[-1])[picked].astype(np.float32)
        return out

    def load_chunk(self, step: int) -> PixelChunk:
        rng = np.random.default_rng(step)
        chosen = self._choose_images(rng)
        items = [self.items[i] for i in chosen]
        seeds = rng.integers(0, 2 ** 31, size=len(items))
        if self.num_threads > 1:
            with ThreadPoolExecutor(self.num_threads) as pool:
                results = list(pool.map(self._load_one, items, seeds))
        else:
            results = [self._load_one(it, s) for it, s in zip(items, seeds)]
        data = {
            k: np.concatenate([r[k] for r in results], axis=0)
            for k in results[0]
        }
        return PixelChunk(data)
