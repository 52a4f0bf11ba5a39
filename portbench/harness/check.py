"""Comparisons shared by the training cells' checks."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Set

import torch


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def moving(first_grad: Dict[str, float]) -> Set[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others are nought to rounding and move under Adam by
    round-off alone."""
    med = statistics.median(first_grad.values())
    return {k for k, v in first_grad.items() if v >= 1e-3 * med}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keep: Optional[Iterable[str]] = None) -> float:
    """max over leaves of |got - want| / max(want, median leaf's want): the
    gap between the two norms of a leaf, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or k in set(keep)]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def loss_gap(got, want) -> float:
    """The worst step's relative gap of the loss."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))
