"""Batched BEVDet-Occ inference, the port of ``mapped_apply`` in
presight_tpu/occupancy/inference.py: the batch in ``chunk_size``-sample
slices, one forward each, outputs concatenated on axis 0 (every output of
BEVDetOcc is batch-major). Each forward runs in the chunk's activation
regime. The multi-device ``sharded_apply`` comes with the multi-GPU port
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

__all__ = ["mapped_apply"]


def mapped_apply(model, args: Sequence[Any] = (), kwargs: Optional[Mapping[str, Any]] = None, *,
                 chunk_size: int = 1):
    """Apply ``model`` to a batch one ``chunk_size`` slice at a time. All
    positional ``args`` and non-None ``kwargs`` share a leading batch axis
    divisible by ``chunk_size``. Returns what ``model`` returns."""
    args = tuple(args)
    kwargs = {k: v for k, v in dict(kwargs or {}).items() if v is not None}
    batch = int(args[0].shape[0]) if args else int(next(iter(kwargs.values())).shape[0])
    if batch % chunk_size:
        raise ValueError(f"batch {batch} not divisible by chunk_size {chunk_size}")
    outs = []
    for s in range(0, batch, chunk_size):
        outs.append(model(*(a[s:s + chunk_size] for a in args),
                          **{k: v[s:s + chunk_size] for k, v in kwargs.items()}))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)
