"""Multi-resolution hash-grid encoding (presight_tpu/ops/hash_encoding.py).

``hash_encode`` is a ``torch.autograd.Function`` over the hash tables. Its
forward is kernel K1 (csrc/hash_encode.cu); its backward is kernel K1b
(csrc/hash_encode_bwd.cu), which writes one cotangent row and key per
(sample, level) (per corner for 'corner'), then a stable ``torch.sort`` of
the keys, and kernel K5 (csrc/sorted_accum.cu), which reads the rows
through the sort's permutation and adds each run of equal keys to the
tables' gradient -- the sort-then-reduce design of the JAX package's
``_gather_rows_sorted_grad``. Each kernel's wrapper runs its plain
PyTorch version where ``kernels.use_plain`` says so (CPU tensors), else
launches it; the Function's backward follows its forward. The plain
versions hash in int64 with each prime product masked to 32 bits, which
equals the reference's uint32 wraparound modulo the table size.

The table gradient's contract: K5 adds it straight into each table's
``.grad`` (allocating zeros only where ``.grad`` is None). The tables are
not inputs of the autograd graph: the Function takes them in a list, which
autograd does not track, and a zero-size leaf that requires grad makes its
output require grad. So the gradients arrive through ``.backward()``, which
accumulates them into ``.grad`` as autograd would; they do not arrive
through ``torch.autograd.grad`` on the tables (which finds the tables
unused), and the tables' AccumulateGrad nodes, and any hooks on the tables,
never run. The tables must be leaf tensors. This spares every backward a
dense zero fill and an AccumulateGrad pass over the whole table.

Positions get no gradient (the sample bins are stop-gradient and camera
optimisation is off): the Function raises if they require one.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Union

import numpy as np
import torch

from .. import kernels
from ..configs import HashEncodingConfig

_HASH_PRIMES = (1, 2654435761, 805459861)
_EXPERT_PRIME = 3674653429
_U32 = 0xFFFFFFFF

_CORNER_BITS = np.array(
    [
        [1, 1, 1],
        [1, 0, 1],
        [0, 0, 1],
        [0, 1, 1],
        [1, 1, 0],
        [1, 0, 0],
        [0, 0, 0],
        [0, 1, 0],
    ],
    dtype=np.int64,
)

_STORAGES = {"corner": 0, "cell": 1, "shared": 2}
_SORTED_ACCUM_TILE = 64  # sorted rows per tile of K5 (kRowsPerTile in csrc/sorted_accum.cu)

Table = Union[torch.Tensor, List[torch.Tensor]]


def init_hash_table(generator: torch.Generator, config: HashEncodingConfig,
                    num_experts: int = 1) -> Table:
    """U(-s, s) tables: a list of L (T, 8F) tables for 'shared' storage, one
    (E * L * T, row_features) table otherwise."""
    def uniform(rows):
        u = torch.rand((rows, config.row_features), generator=generator)
        return (u * 2.0 - 1.0) * config.hash_init_scale

    if config.storage == "shared":
        return [uniform(config.table_size) for _ in range(config.num_levels)]
    return uniform(num_experts * config.num_levels * config.table_size)


def trilerp_weights(offset: torch.Tensor) -> torch.Tensor:
    """In-cell offsets (..., 3) -> (..., 8) trilinear corner weights in
    _CORNER_BITS order."""
    bits = torch.as_tensor(_CORNER_BITS, device=offset.device) == 1  # (8, 3)
    w = torch.where(bits, offset[..., None, :], 1.0 - offset[..., None, :])
    return w[..., 0] * w[..., 1] * w[..., 2]


def _raw_hash(corners: torch.Tensor) -> torch.Tensor:
    """Unmasked spatial hash of integer coordinates (..., 3) -> int64 holding
    the uint32 value."""
    c = corners.to(torch.int64)
    return (
        ((c[..., 0] * _HASH_PRIMES[0]) & _U32)
        ^ ((c[..., 1] * _HASH_PRIMES[1]) & _U32)
        ^ ((c[..., 2] * _HASH_PRIMES[2]) & _U32)
    )


def _hash_corners(corners: torch.Tensor, table_size: int) -> torch.Tensor:
    return _raw_hash(corners) & (table_size - 1)


def _scaled(positions: torch.Tensor, config: HashEncodingConfig):
    scalings = torch.as_tensor(config.scalings(), device=positions.device)
    scaled = positions[..., None, :] * scalings[:, None]  # (..., L, 3)
    scaled_f = torch.floor(scaled)
    return scaled, scaled_f, scaled - scaled_f


def hash_encode_plain(table: Table, positions: torch.Tensor, config: HashEncodingConfig,
                      expert_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hash lookup + trilinear blend; positions (..., 3) in [0, 1] ->
    (..., L * F)."""
    L, T, F = config.num_levels, config.table_size, config.features_per_level
    scaled, scaled_f, offset = _scaled(positions, config)
    fl = scaled_f.to(torch.int64)
    w = trilerp_weights(offset)  # (..., L, 8)

    if config.storage == "shared":
        emix = None
        if expert_ids is not None:
            emix = (expert_ids.to(torch.int64) * _EXPERT_PRIME) & _U32
        outs = []
        for l in range(L):
            h = _raw_hash(fl[..., l, :])
            if emix is not None:
                h = h ^ emix
            rows = table[l][h & (T - 1)]  # (..., 8F)
            rows = rows.reshape(*rows.shape[:-1], 8, F)
            outs.append(torch.sum(rows * w[..., l, :, None], dim=-2))
        return torch.cat(outs, dim=-1)

    level_offset = torch.arange(L, device=positions.device, dtype=torch.int64) * T
    if config.storage == "cell":
        idx = _hash_corners(fl, T) + level_offset  # (..., L)
        if expert_ids is not None:
            idx = idx + (expert_ids.to(torch.int64) * (L * T))[..., None]
        rows = table[idx]
        rows = rows.reshape(*rows.shape[:-1], 8, F)
        out = torch.sum(rows * w[..., None], dim=-2)
        return out.reshape(*out.shape[:-2], L * F)

    ce = torch.ceil(scaled).to(torch.int64)
    bits = torch.as_tensor(_CORNER_BITS, device=positions.device) == 1
    corners = torch.where(bits, ce[..., None, :], fl[..., None, :])  # (..., L, 8, 3)
    idx = _hash_corners(corners, T) + level_offset[:, None]
    if expert_ids is not None:
        idx = idx + (expert_ids.to(torch.int64) * (L * T))[..., None, None]
    feats = table[idx]  # (..., L, 8, F)
    out = torch.sum(feats * w[..., None], dim=-2)
    return out.reshape(*out.shape[:-2], L * F)


def hash_encode_fwd(table: Table, positions: torch.Tensor, config: HashEncodingConfig,
                    expert_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Wrapper of K1: the CUDA kernel, or the plain version where
    ``kernels.use_plain``."""
    if kernels.use_plain(positions):
        return hash_encode_plain(table, positions, config, expert_ids)
    L, T, F = config.num_levels, config.table_size, config.features_per_level
    storage = _STORAGES[config.storage]
    shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    n = pos.shape[0]
    eids = None if expert_ids is None else expert_ids.reshape(-1)
    if config.storage == "shared":
        if len(table) != L:
            raise ValueError(f"hash_encode: expected {L} level tables, got {len(table)}")
        tables = list(table)
        for t in tables:
            if t.shape != (T, 8 * F):
                raise ValueError(f"hash_encode: level table {tuple(t.shape)} != {(T, 8 * F)}")
        level_ptrs = [t.data_ptr() for t in tables]
        expert_stride = 0
    else:
        tables = [table]
        row = config.row_features
        if table.dim() != 2 or table.shape[1] != row or table.shape[0] % (L * T):
            raise ValueError(f"hash_encode: table {tuple(table.shape)} does not fit {config}")
        level_ptrs = [table.data_ptr() + l * T * row * 4 for l in range(L)]
        expert_stride = L * T
    for t in [pos, *tables]:
        if t.dtype != torch.float32:
            raise TypeError("hash_encode: expected float32 positions and tables")
    extra = []
    if eids is not None:
        if eids.dtype != torch.int32 or eids.shape[0] != n:
            raise TypeError("hash_encode: expert ids must be int32, one per position")
        extra = [eids]
    kernels.require_cuda("hash_encode", pos, *tables, *extra)
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    scales = (ctypes.c_float * L)(*config.scalings().tolist())
    kernels.launch("hash_encode_fwd", pos.data_ptr(), kernels.ptr(eids),
                   kernels.host_ptrs(level_ptrs), scales, n, L, F, config.log2_hashmap_size,
                   storage, expert_stride, out.data_ptr())
    return out.reshape(*shape, L * F)


def hash_keys(positions: torch.Tensor, config: HashEncodingConfig,
              expert_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The table row each (sample, level) reads -- each (sample, level,
    corner) for 'corner' -- as a flat int64 key: its row in the
    (E * L * T, row) table, or in the flat (L * T, 8F) 'shared' gradient.
    positions (n, 3) -> (n, L) or (n, L, 8)."""
    L, T = config.num_levels, config.table_size
    scaled, scaled_f, _ = _scaled(positions, config)
    fl = scaled_f.to(torch.int64)
    level_offset = torch.arange(L, device=positions.device, dtype=torch.int64) * T
    expert_offset = 0 if expert_ids is None else expert_ids.to(torch.int64) * (L * T)
    if config.storage == "corner":
        ce = torch.ceil(scaled).to(torch.int64)
        bits = torch.as_tensor(_CORNER_BITS, device=positions.device) == 1
        corners = torch.where(bits, ce[..., None, :], fl[..., None, :])  # (n, L, 8, 3)
        keys = _hash_corners(corners, T) + level_offset[:, None]
        return keys if expert_ids is None else keys + expert_offset[:, None, None]
    h = _raw_hash(fl)  # (n, L)
    if config.storage == "shared":
        if expert_ids is not None:
            h = h ^ ((expert_ids.to(torch.int64) * _EXPERT_PRIME) & _U32)[:, None]
        return (h & (T - 1)) + level_offset
    keys = (h & (T - 1)) + level_offset
    return keys if expert_ids is None else keys + expert_offset[:, None]


def hash_encode_bwd_plain(positions: torch.Tensor, config: HashEncodingConfig,
                          expert_ids: Optional[torch.Tensor], grad: torch.Tensor):
    """Plain version of K1b. positions (n, 3), grad (n, L * F) -> (keys
    int32, rows): the table-gradient contribution w_c * g[level] of every
    corner, keyed by ``hash_keys``. 'shared' and 'cell' give one 8F row per
    (sample, level), 'corner' one F row per (sample, level, corner)."""
    L, F = config.num_levels, config.features_per_level
    n = positions.shape[0]
    w = trilerp_weights(_scaled(positions, config)[2])  # (n, L, 8)
    rows = w[..., None] * grad.reshape(n, L, F)[:, :, None, :]  # (n, L, 8, F)
    if config.storage != "corner":
        rows = rows.reshape(n * L, 8 * F)
    keys = hash_keys(positions, config, expert_ids)
    return keys.reshape(-1).to(torch.int32), rows.reshape(keys.numel(), -1)


def hash_encode_bwd(positions: torch.Tensor, config: HashEncodingConfig,
                    expert_ids: Optional[torch.Tensor], grad: torch.Tensor):
    """Wrapper of K1b (see hash_encode_bwd_plain for the contract)."""
    if kernels.use_plain(positions):
        return hash_encode_bwd_plain(positions, config, expert_ids, grad)
    L, F = config.num_levels, config.features_per_level
    n = positions.shape[0]
    if positions.shape != (n, 3) or grad.shape != (n, L * F):
        raise ValueError("hash_encode_bwd: positions (n, 3) and grad (n, L * F) expected")
    if positions.dtype != torch.float32 or grad.dtype != torch.float32:
        raise TypeError("hash_encode_bwd: expected float32 positions and gradient")
    extra = []
    if expert_ids is not None:
        if expert_ids.dtype != torch.int32 or expert_ids.shape != (n,):
            raise TypeError("hash_encode_bwd: expert ids must be int32, one per position")
        extra = [expert_ids]
    kernels.require_cuda("hash_encode_bwd", positions, grad, *extra)
    corner = config.storage == "corner"
    n_keys = n * L * (8 if corner else 1)
    keys = torch.empty((n_keys,), dtype=torch.int32, device=positions.device)
    rows = torch.empty((n_keys, F if corner else 8 * F), dtype=torch.float32,
                       device=positions.device)
    scales = (ctypes.c_float * L)(*config.scalings().tolist())
    kernels.launch("hash_encode_bwd", positions.data_ptr(), kernels.ptr(expert_ids),
                   grad.data_ptr(), scales, n, L, F, config.log2_hashmap_size,
                   _STORAGES[config.storage], keys.data_ptr(), rows.data_ptr())
    return keys, rows


def _out_parts(out: Table) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def sorted_accum_plain(keys: torch.Tensor, rows: torch.Tensor, out: Table,
                       order: torch.Tensor) -> None:
    """Plain version of K5 (see sorted_accum for the contract)."""
    if keys.numel() == 0:
        return
    parts = _out_parts(out)
    part_rows = parts[0].shape[0]
    rows = rows[order]
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=0)
    uniq = uniq.long()
    if int(uniq[-1]) >= len(parts) * part_rows:
        raise ValueError("sorted_accum: a key lies past the output's rows")
    for p, part in enumerate(parts):
        sel = (uniq >= p * part_rows) & (uniq < (p + 1) * part_rows)
        part[uniq[sel] - p * part_rows] += sums[sel]


def sorted_accum(keys: torch.Tensor, rows: torch.Tensor, out: Table,
                 order: torch.Tensor) -> None:
    """Wrapper of K5: for each run of equal ``keys`` (int32, sorted
    ascending), add the sum of its rows to the output row of that key, in
    place. Sorted row i is ``rows[order[i]]`` (``order``: the int64 indices
    of ``torch.sort``). ``out`` is one (T, C) tensor, or a list of P (T, C)
    tensors of which part p holds keys [p T, (p + 1) T) (the 'shared'
    storage's level tables). The output is accumulated into and never
    zeroed."""
    if kernels.use_plain(rows):
        return sorted_accum_plain(keys, rows, out, order)
    parts = _out_parts(out)
    if keys.dtype != torch.int32 or rows.dtype != torch.float32:
        raise TypeError("sorted_accum: int32 keys and float32 rows expected")
    n = keys.shape[0]
    if keys.dim() != 1 or rows.dim() != 2:
        raise ValueError("sorted_accum: keys (n,) and rows (N, C) expected")
    if order.dtype != torch.int64 or order.shape != (n,):
        raise ValueError("sorted_accum: order must be int64 (n,)")
    C = rows.shape[1]
    if not 1 <= len(parts) <= 16 or any(
            p.dtype != torch.float32 or p.shape != (parts[0].shape[0], C) for p in parts):
        raise ValueError("sorted_accum: 1 to 16 float32 output parts of one (T, C) shape expected")
    kernels.require_cuda("sorted_accum", keys, order, rows, *parts)
    vec = 4 if C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in [rows, *parts]) else 1
    num_tiles = -(-n // _SORTED_ACCUM_TILE)
    scratch = torch.empty((2 * num_tiles, C), dtype=torch.float32, device=rows.device)
    flags = torch.empty((num_tiles,), dtype=torch.uint8, device=rows.device)
    kernels.launch("sorted_accum", keys.data_ptr(), order.data_ptr(), rows.data_ptr(), n, C,
                   kernels.host_ptrs([t.data_ptr() for t in parts]), len(parts),
                   parts[0].shape[0], vec, scratch.data_ptr(), flags.data_ptr())


def table_grad(positions: torch.Tensor, config: HashEncodingConfig,
               expert_ids: Optional[torch.Tensor], grad: torch.Tensor, out: Table) -> None:
    """Add the table gradient of hash_encode to ``out`` in place: the
    (E * L * T, row) gradient, or for 'shared' storage the list of the L
    (T, 8F) level gradients (K5 takes one base pointer per level; a key is
    l * T + row). K1b's (key, row) pairs, a stable sort of the keys, and K5
    reading the rows through the sort's permutation."""
    keys, rows = hash_encode_bwd(positions, config, expert_ids, grad)
    keys, order = torch.sort(keys, stable=True)
    sorted_accum(keys, rows, out, order)


class _HashEncode(torch.autograd.Function):
    """K1 forward; the backward adds the table gradient to the tables'
    ``.grad`` itself (see the module docstring). ``tables`` is a list, out
    of autograd's sight; ``token`` is the zero-size leaf that makes the
    output require grad."""

    @staticmethod
    def forward(ctx, positions, expert_ids, config, tables, token):
        ctx.config = config
        ctx.tables = tables
        ctx.plain = kernels.use_plain(positions)
        ctx.save_for_backward(positions, expert_ids)
        return hash_encode_fwd(tables if config.storage == "shared" else tables[0], positions,
                               config, expert_ids)

    @staticmethod
    def backward(ctx, grad):
        positions, expert_ids = ctx.saved_tensors
        grads = []
        for t in ctx.tables:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        with kernels.plain_versions(ctx.plain):
            table_grad(positions, ctx.config, expert_ids, grad.contiguous(),
                       grads if ctx.config.storage == "shared" else grads[0])
        return None, None, None, None, None


def hash_encode(table: Table, positions: torch.Tensor, config: HashEncodingConfig,
                expert_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hash lookup + trilinear blend, positions (..., 3) in [0, 1] ->
    (..., L * F), differentiable in the tables (K1 forward; K1b, sort and K5
    backward, into the tables' ``.grad``: see the module docstring)."""
    if positions.requires_grad:
        raise ValueError("hash_encode: positions carry no gradient on this path")
    shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    eids = None if expert_ids is None else expert_ids.reshape(-1)
    tables = list(table) if config.storage == "shared" else [table]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        if not all(t.requires_grad and t.is_leaf for t in tables):
            raise ValueError("hash_encode: the tables' gradients go to .grad, so every table "
                             "must be a leaf that requires grad")
        out = _HashEncode.apply(pos, eids, config, tables, pos.new_empty(0).requires_grad_())
    else:
        out = hash_encode_fwd(tables if config.storage == "shared" else table, pos, config, eids)
    return out.reshape(*shape, out.shape[-1])
