"""Parameter bridge between the JAX package's numpy trees and the port.

Stage 2: the port keeps the JAX layouts: dense weights stay (in, out)
(stacked experts (E, in, out)), biases (out,) or (E, out), 'shared' hash
tables stay a list of per-level (T, 8F) tables. So a leaf crosses the bridge
as a copy, with no transpose, and the tree's dicts, lists and tuples keep
their shape (``from_jax_params``, ``to_numpy``).

Stage 3 (occupancy): the port's modules are PyTorch layers whose
state_dict keys carry the flax auto-names (models/layers.py), so a flax
``{"params", "batch_stats"}`` tree maps onto the port's state_dict by path
(``occ_state_from_flax``, and back with ``occ_state_to_flax``): conv
kernels HWIO / DHWIO -> OIHW / OIDHW, Dense kernels (in, out) -> (out, in),
BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
running_var.

Stage 3 (online mapping): ``map_state_from_flax`` / ``map_state_to_flax``
do the same for StreamMapNet, whose tree adds LayerNorm scales (-> weight),
flax's MultiHeadDotProductAttention projections (query / key / value
kernels (D, heads, hd) -> (heads * hd, D) Dense weights, biases (heads, hd)
-> (heads * hd,); the out kernel (heads, hd, D) -> (D, heads * hd)), and raw
parameters that keep their name and layout (DeformConv2d's ``kernel_w`` /
``kernel_b``, the BEV and decoder queries and positional tables).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


# flax leaf name -> the port's tensor name, by collection
_OCC_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_OCC_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _kernel_to_port(a: np.ndarray) -> np.ndarray:
    """flax kernel -> the port's weight: (*k, in, out) -> (out, in, *k) for
    convs, (in, out) -> (out, in) for Dense."""
    nk = a.ndim - 2
    return np.transpose(a, (a.ndim - 1, a.ndim - 2, *range(nk)))


def _kernel_to_flax(a: np.ndarray) -> np.ndarray:
    nk = a.ndim - 2
    return np.transpose(a, (*range(2, 2 + nk), 1, 0))


def occ_state_from_flax(variables_np: Any, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A flax occupancy tree (``{"params": ..., "batch_stats": ...}`` of
    numpy arrays, as ``jax.device_get`` gives them) -> the port model's
    state_dict, loaded into ``model`` and returned. Raises on a flax leaf
    that names no port tensor, on a port tensor that no flax leaf fills,
    and on a shape mismatch."""
    target = model.state_dict()
    filled: Dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _OCC_PARAM_LEAVES), ("batch_stats", _OCC_STAT_LEAVES)):
        for path, leaf in _flatten(variables_np.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(f"occ_state_from_flax: unknown flax leaf {collection}/{'/'.join(path)}")
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            if key not in target:
                raise KeyError(f"occ_state_from_flax: flax leaf {collection}/{'/'.join(path)} "
                               f"has no port tensor {key}")
            if key in filled:
                raise KeyError(f"occ_state_from_flax: port tensor {key} filled twice")
            a = np.asarray(leaf)
            if path[-1] == "kernel":
                a = _kernel_to_port(a)
            if tuple(a.shape) != tuple(target[key].shape):
                raise ValueError(f"occ_state_from_flax: {collection}/{'/'.join(path)} "
                                 f"{a.shape} -> {key} {tuple(target[key].shape)}")
            filled[key] = torch.as_tensor(np.array(a, dtype=np.float32, order="C"))
    missing = sorted(set(target) - set(filled))
    if missing:
        raise KeyError(f"occ_state_from_flax: {len(missing)} port tensors left unfilled, "
                       f"e.g. {missing[:5]}")
    model.load_state_dict(filled, strict=True)
    return filled


def occ_state_to_flax(model: torch.nn.Module,
                      state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The port model's tensors (or ``state``, a state_dict of the model,
    such as its EMA) -> a flax ``{"params", "batch_stats"}`` numpy tree of
    float32 arrays (the inverse of occ_state_from_flax), as the JAX
    occupancy CLI pickles it."""
    from .models.layers import BatchNorm

    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _OCC_STAT_LEAVES.items()}
    norms = {name for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    for key, t in (model.state_dict() if state is None else state).items():
        *mods, leaf = key.split(".")
        owner = ".".join(mods)
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf in stats:
            collection, name = "batch_stats", stats[leaf]
        elif owner in norms:
            collection, name = "params", "scale" if leaf == "weight" else "bias"
        else:
            collection, name = "params", "kernel" if leaf == "weight" else "bias"
            if leaf == "weight":
                a = _kernel_to_flax(a)
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return out


_MHA_IN = ("query", "key", "value")


def _is_mha(path: Tuple[str, ...]) -> bool:
    return len(path) >= 3 and path[-3].startswith("MultiHeadDotProductAttention")


def _map_leaf_to_port(collection: str, path: Tuple[str, ...], a: np.ndarray,
                      raw: set) -> Tuple[str, np.ndarray]:
    """One flax leaf of a mapping tree -> (the port's state_dict key, array)."""
    leaf = path[-1]
    if collection == "batch_stats":
        if leaf not in _OCC_STAT_LEAVES:
            raise KeyError(f"map_state_from_flax: unknown flax leaf batch_stats/{'/'.join(path)}")
        return ".".join(path[:-1] + (_OCC_STAT_LEAVES[leaf],)), a
    if _is_mha(path) and path[-2] in _MHA_IN:
        if leaf == "kernel":
            return ".".join(path[:-1] + ("weight",)), a.reshape(a.shape[0], -1).T
        return ".".join(path[:-1] + ("bias",)), a.reshape(-1)
    if _is_mha(path) and path[-2] == "out" and leaf == "kernel":
        return ".".join(path[:-1] + ("weight",)), a.reshape(-1, a.shape[-1]).T
    key = ".".join(path)
    if key in raw:
        return key, a
    if leaf not in _OCC_PARAM_LEAVES:
        raise KeyError(f"map_state_from_flax: unknown flax leaf params/{'/'.join(path)}")
    if leaf == "kernel":
        a = _kernel_to_port(a)
    return ".".join(path[:-1] + (_OCC_PARAM_LEAVES[leaf],)), a


def _raw_params(model: torch.nn.Module) -> set:
    """Parameters held by a module directly that are not a layer's weight or
    bias: they cross the bridge as they are."""
    from .mapping.conv_gru import LayerNorm
    from .models.layers import BatchNorm, Conv, Dense

    layers = (Conv, Dense, BatchNorm, LayerNorm)
    owners = dict(model.named_modules())
    out = set()
    for key, _ in model.named_parameters():
        owner, _, _ = key.rpartition(".")
        if not isinstance(owners[owner], layers):
            out.add(key)
    return out


def map_state_from_flax(variables_np: Any, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A flax StreamMapNet tree (``{"params": ..., "batch_stats": ...}`` of
    numpy arrays) -> the port model's state_dict, loaded into ``model`` and
    returned. Raises on a flax leaf that names no port tensor, on a port
    tensor no leaf fills, and on a shape mismatch."""
    target = model.state_dict()
    raw = _raw_params(model)
    filled: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables_np.get(collection, {})):
            key, a = _map_leaf_to_port(collection, path, np.asarray(leaf), raw)
            where = f"{collection}/{'/'.join(path)}"
            if key not in target:
                raise KeyError(f"map_state_from_flax: flax leaf {where} has no port tensor {key}")
            if key in filled:
                raise KeyError(f"map_state_from_flax: port tensor {key} filled twice")
            if tuple(a.shape) != tuple(target[key].shape):
                raise ValueError(f"map_state_from_flax: {where} {a.shape} -> {key} "
                                 f"{tuple(target[key].shape)}")
            filled[key] = torch.as_tensor(np.array(a, dtype=np.float32, order="C"))
    missing = sorted(set(target) - set(filled))
    if missing:
        raise KeyError(f"map_state_from_flax: {len(missing)} port tensors left unfilled, "
                       f"e.g. {missing[:5]}")
    model.load_state_dict(filled, strict=True)
    return filled


def map_state_to_flax(model: torch.nn.Module,
                      state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The port StreamMapNet's tensors (or ``state``, a state_dict of it) ->
    a flax ``{"params", "batch_stats"}`` numpy tree of float32 arrays, the
    inverse of map_state_from_flax."""
    from .mapping.conv_gru import LayerNorm
    from .mapping.map_head import MultiHeadDotProductAttention
    from .models.layers import BatchNorm

    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _OCC_STAT_LEAVES.items()}
    modules = dict(model.named_modules())
    raw = _raw_params(model)
    for key, t in (model.state_dict() if state is None else state).items():
        *mods, leaf = key.split(".")
        owner = ".".join(mods)
        a = t.detach().cpu().numpy().astype(np.float32)
        parent = modules.get(".".join(mods[:-1]))
        if key in raw:
            collection, name = "params", leaf
        elif leaf in stats:
            collection, name = "batch_stats", stats[leaf]
        elif isinstance(modules[owner], (BatchNorm, LayerNorm)):
            collection, name = "params", "scale" if leaf == "weight" else "bias"
        elif isinstance(parent, MultiHeadDotProductAttention):
            collection, name = "params", "kernel" if leaf == "weight" else "bias"
            heads = parent.heads
            if mods[-1] in _MHA_IN:
                a = a.T.reshape(a.shape[1], heads, -1) if leaf == "weight" else a.reshape(heads, -1)
            elif leaf == "weight":
                a = a.T.reshape(heads, -1, a.shape[0])
        else:
            collection, name = "params", "kernel" if leaf == "weight" else "bias"
            if leaf == "weight":
                a = _kernel_to_flax(a)
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return out
