"""Data manager: chunk prefetch and fixed-size batches
(presight_tpu/data/datamanager.py).

One background thread loads the next chunk while the current one is
consumed; batches are contiguous slices of a per-chunk shuffle drawn from
``np.random.default_rng`` exactly as the JAX package draws them, so the two
give the same rows. With a ``ChunkDeviceStore`` the prefetch thread also
stages each loaded chunk on the card (a side stream; the gather waits on
its event), and ``next_batch`` gathers the batch there, so only the
selection crosses the host link each step.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from .dataset import PixelChunk, PixelChunkDataset


class DataManager:
    """Streams fixed-size pixel batches from chunked image loading.

    ``dataset`` is anything with ``load_chunk(step) -> PixelChunk``
    (PixelChunkDataset, or one whole in-memory chunk). ``chunk_store``
    (optional data.device_store.ChunkDeviceStore): stage each prefetched
    chunk's rows on the device from the prefetch thread and gather batches
    there; ``next_batch`` then returns device tensors. Falls back to host
    values if a chunk exceeds the store's cap."""

    def __init__(self, dataset: PixelChunkDataset, batch_size: int, seed: int = 0,
                 chunk_store=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.chunk_store = chunk_store
        self._executor = ThreadPoolExecutor(1)
        self._next_chunk: Optional[Future] = None
        self._chunk: Optional[PixelChunk] = None
        self._chunk_id: Optional[int] = None
        self._order: Optional[np.ndarray] = None
        self._cursor = 0
        self._chunk_step = seed

    def _schedule_next(self) -> None:
        step = self._chunk_step
        self._chunk_step += 1

        def load():
            chunk = self.dataset.load_chunk(step)
            if self.chunk_store is not None:
                self.chunk_store.stage(step, chunk.data)
            return step, chunk

        self._next_chunk = self._executor.submit(load)

    def _advance_chunk(self) -> None:
        if self._next_chunk is None:
            self._schedule_next()
        self._chunk_id, self._chunk = self._next_chunk.result()
        self._schedule_next()
        if self.chunk_store is not None:
            # The active chunk and the one being prefetched: at most two
            # chunks resident.
            self.chunk_store.retain_only({self._chunk_id, self._chunk_step - 1})
        rng = np.random.default_rng(self._chunk_step)
        self._order = rng.permutation(len(self._chunk))
        self._cursor = 0

    def next_batch(self) -> Dict:
        """Next fixed-size batch; advances to a fresh chunk when drained.
        Host numpy values, or device tensors when the chunk store holds the
        active chunk."""
        if self._chunk is None or self._cursor + self.batch_size > len(self._chunk):
            self._advance_chunk()
        sel = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        if self.chunk_store is not None and self.chunk_store.has(self._chunk_id):
            return self.chunk_store.batch(self._chunk_id, sel)
        return {k: v[sel] for k, v in self._chunk.data.items()}

    def close(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)
