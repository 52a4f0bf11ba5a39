"""Parameter bridge between the JAX package's numpy trees and the port.

The port keeps the JAX layouts: dense weights stay (in, out) (stacked
experts (E, in, out)), biases (out,) or (E, out), 'shared' hash tables stay
a list of per-level (T, 8F) tables. So a leaf crosses the bridge as a copy,
with no transpose, and the tree's dicts, lists and tuples keep their shape.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def from_jax_params(params_np: Any, device=None) -> Any:
    """numpy tree (``jax.tree_util.tree_map(np.asarray, params)``) -> the
    port's tree of torch tensors, each a C-contiguous copy (the kernels take
    contiguous tensors only; a stack of transposed views is not)."""
    return _map(params_np, lambda a: torch.as_tensor(np.array(a, order="C"), device=device))


def to_numpy(state: Any) -> Any:
    """The port's tree of tensors -> numpy tree of the same structure."""
    return _map(state, lambda t: t.detach().cpu().numpy())
