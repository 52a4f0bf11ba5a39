"""Multi-resolution hash-grid encoding (presight_tpu/ops/hash_encoding.py).

``hash_encode`` is the wrapper of kernel K1 (csrc/hash_encode.cu): on a CUDA
tensor it launches the kernel, on a CPU tensor it runs ``hash_encode_plain``,
the PyTorch version of the same function. The plain version hashes in int64
with each prime product masked to 32 bits, which equals the reference's
uint32 wraparound modulo the table size.
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


def hash_encode(table: Table, positions: torch.Tensor, config: HashEncodingConfig,
                expert_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Wrapper of K1: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if positions.device.type == "cpu":
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
    code = kernels.lib().hash_encode_fwd(
        pos.data_ptr(), kernels.ptr(eids), kernels.host_ptrs(level_ptrs), scales,
        n, L, F, config.log2_hashmap_size, storage, expert_stride, out.data_ptr(),
        kernels.stream())
    kernels.check("hash_encode_fwd", code)
    kernels.LAUNCHES["hash_encode_fwd"] += 1
    return out.reshape(*shape, L * F)
