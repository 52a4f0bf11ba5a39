"""Deformable sampling of the online-mapping model: kernel S3.

The JAX package samples with XLA gathers (presight_tpu/mapping/
bev_encoder.py:90 ``deformable_taps``, the fused SCA core's row gather and
DeformConv2d's ``bilinear_sample``), standing in for mmcv's
MultiScaleDeformableAttention and ModulatedDeformConv2d. Here two hand
kernels (csrc/deformable.cu) run them on CUDA tensors, forward only:

* :func:`msda_fwd` serves the three attention sites: for each (map, query,
  head), the attention-weighted bilinear taps over levels and points;
* :func:`deform_im2col_fwd` builds DCNv2's mask-modulated columns, which one
  f32 product turns into the convolution.

:func:`msda` and :func:`deform_im2col` take the plain versions
(:func:`msda_plain`, :func:`deform_im2col_plain`: four gathers) where
``kernels.use_plain`` says so, and the kernels otherwise (which raise where
they cannot launch). A tap is ``packed_rows_weights``' bilinear
sample: floor of the pixel coordinate, corner weights (1 - wy)(1 - wx),
(1 - wy) wx, wy (1 - wx), wy wx, a corner outside the map weighing 0. The
kernels take no gradient: with autograd on and an input that requires one,
they raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import kernels

Level = Tuple[int, int, int]  # (H, W, first row of the level in a map's value rows)


def bilinear_corners(px: torch.Tensor, py: torch.Tensor, H: int, W: int):
    """The four corners of each tap: [(flat row into the H x W map, clamped
    in range; weight, 0 for a corner outside)]."""
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = []
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        out.append((yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1), w * valid.to(w.dtype)))
    return out


def msda_plain(value: torch.Tensor, levels: Sequence[Level], loc: torch.Tensor,
               attn: torch.Tensor) -> torch.Tensor:
    """Plain version of S3's ``msda_fwd``: value (B, R, D) rows of every
    map, levels [(H, W, first row)], loc (B, Q, Hh, L, T, 2) (x, y) pixel
    coordinates of level l, attn (B, Q, Hh, L, T) -> (B, Q, D): per head,
    the four corners blended, then the taps weighted and summed."""
    B, Q, Hh, L, T = attn.shape
    R, D = value.shape[1:]
    hd = D // Hh
    vh = value.reshape(B, R, Hh, hd).permute(0, 2, 1, 3)  # (B, Hh, R, hd)
    out = value.new_zeros((B, Hh, Q, hd))
    for l, (H, W, start) in enumerate(levels):
        px = loc[:, :, :, l, :, 0].permute(0, 2, 1, 3)  # (B, Hh, Q, T)
        py = loc[:, :, :, l, :, 1].permute(0, 2, 1, 3)
        taps = 0
        for row, w in bilinear_corners(px, py, H, W):
            index = (row + start).reshape(B, Hh, Q * T, 1).expand(-1, -1, -1, hd)
            taps = taps + torch.gather(vh, 2, index).reshape(B, Hh, Q, T, hd) * w[..., None]
        a = attn[:, :, :, l].permute(0, 2, 1, 3)
        out = out + (taps * a[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Q, D)


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under no_grad "
                           "or take the plain version")


def _float32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors expected, got {t.dtype}")


def msda_fwd(value: torch.Tensor, levels: Sequence[Level], loc: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
    """S3 ``msda_fwd`` on CUDA tensors (contract of :func:`msda_plain`; head
    width at most 32). Raises if it cannot launch."""
    kernels.require_cuda("msda_fwd", value, loc, attn)
    _float32("msda_fwd", value, loc, attn)
    _forward_only("msda_fwd", value, loc, attn)
    B, Q, Hh, L, T = attn.shape
    R, D = value.shape[1:]
    if (value.shape[0] != B or loc.shape != (B, Q, Hh, L, T, 2) or len(levels) != L
            or D % Hh or D // Hh > 32 or L > 8 or R * D >= 2**31):
        raise ValueError(f"msda_fwd: value {tuple(value.shape)}, loc {tuple(loc.shape)}, "
                         f"attn {tuple(attn.shape)}, {len(levels)} levels do not fit")
    for H, W, start in levels:
        if start < 0 or start + H * W > R:
            raise ValueError(f"msda_fwd: level ({H}, {W}) at row {start} outside {R} rows")
    out = torch.empty((B, Q, D), dtype=torch.float32, device=value.device)
    flat = [int(v) for level in levels for v in level]
    kernels.launch("msda_fwd", value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                   (ctypes.c_int64 * len(flat))(*flat), B, Q, R, D, Hh, L, T, out.data_ptr())
    return out


def msda(value: torch.Tensor, levels: Sequence[Level], loc: torch.Tensor,
         attn: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention: S3, or the plain version where
    ``kernels.use_plain``."""
    if kernels.use_plain(value):
        return msda_plain(value, levels, loc, attn)
    return msda_fwd(value.contiguous(), levels, loc.contiguous(), attn.contiguous())


def _grid(Ho: int, Wo: int, k: int, stride: int, like: torch.Tensor):
    """The taps' undeformed positions (Ho, 1, k*k) and (1, Wo, k*k): the
    output grid times the stride plus the kernel offset, as the JAX package
    adds them (exact integers)."""
    dt, dev = like.dtype, like.device
    ky, kx = torch.meshgrid(torch.arange(k, device=dev) - k // 2,
                            torch.arange(k, device=dev) - k // 2, indexing="ij")
    gy = (torch.arange(Ho, device=dev, dtype=dt) * stride)[:, None, None]
    gx = (torch.arange(Wo, device=dev, dtype=dt) * stride)[None, :, None]
    return gy + ky.reshape(1, 1, -1).to(dt), gx + kx.reshape(1, 1, -1).to(dt)


def deform_im2col_plain(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, k: int,
                        stride: int = 1) -> torch.Tensor:
    """Plain version of S3's ``deform_im2col_fwd``: x (B, H, W, C),
    offsets (B, Ho, Wo, k*k, 2) as (dy, dx), mask (B, Ho, Wo, k*k) ->
    columns (B * Ho * Wo, k*k * C), tap-major: the four corners blended,
    times the mask."""
    B, H, W, C = x.shape
    Ho, Wo, KK = offsets.shape[1:4]
    gy, gx = _grid(Ho, Wo, k, stride, x)
    py, px = gy + offsets[..., 0], gx + offsets[..., 1]  # (B, Ho, Wo, KK)
    flat = x.reshape(B, H * W, C)
    taps = 0
    for row, w in bilinear_corners(px, py, H, W):
        index = row.reshape(B, -1, 1).expand(-1, -1, C)
        taps = taps + torch.gather(flat, 1, index).reshape(B, Ho, Wo, KK, C) * w[..., None]
    return (taps * mask[..., None]).reshape(B * Ho * Wo, KK * C)


def deform_im2col_fwd(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, k: int,
                      stride: int = 1) -> torch.Tensor:
    """S3 ``deform_im2col_fwd`` on CUDA tensors (contract of
    :func:`deform_im2col_plain`). Raises if it cannot launch."""
    kernels.require_cuda("deform_im2col_fwd", x, offsets, mask)
    _float32("deform_im2col_fwd", x, offsets, mask)
    _forward_only("deform_im2col_fwd", x, offsets, mask)
    B, H, W, C = x.shape
    Ho, Wo, KK = offsets.shape[1:4]
    if (KK != k * k or offsets.shape != (B, Ho, Wo, KK, 2) or mask.shape != (B, Ho, Wo, KK)
            or H * W >= 2**31):
        raise ValueError(f"deform_im2col_fwd: x {tuple(x.shape)}, offsets "
                         f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}, k {k} do not fit")
    cols = torch.empty((B * Ho * Wo, KK * C), dtype=torch.float32, device=x.device)
    kernels.launch("deform_im2col_fwd", x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), B, H,
                   W, C, Ho, Wo, k, stride, cols.data_ptr())
    return cols


def deform_im2col(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, k: int,
                  stride: int = 1) -> torch.Tensor:
    """DCNv2's columns: S3, or the plain version where ``kernels.use_plain``."""
    if kernels.use_plain(x):
        return deform_im2col_plain(x, offsets, mask, k, stride)
    return deform_im2col_fwd(x.contiguous(), offsets.contiguous(), mask.contiguous(), k, stride)


def level_rows(shapes: Sequence[Tuple[int, int]]) -> List[Level]:
    """Levels stacked one after another in a map's value rows."""
    out, start = [], 0
    for H, W in shapes:
        out.append((int(H), int(W), start))
        start += int(H) * int(W)
    return out
