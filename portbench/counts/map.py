"""Work of kernel S3's two entry points, counted from the shapes of a call.

``msda_fwd`` (value (B, R, D) rows, B * Q * heads warps, L levels of T
taps): each tap blends four corner rows of its head's D / heads channels,
one multiply-add per corner and channel (8 FLOPs a tap and channel), so
8 * B * Q * D * L * T FLOPs; its least traffic reads the value rows, the
locations (2 floats a tap and head), the attention weights (1) once and
writes the output once.

``deform_im2col_fwd`` (x (B, H, W, C), B * Ho * Wo output pixels, k*k
taps): each column entry blends four corners (four multiply-adds) and is
scaled by the mask (9 FLOPs); its least traffic reads x, the offsets (2
floats a tap) and the mask (1) once and writes the columns once.

Floats are 4 bytes.
"""

from __future__ import annotations

from typing import Tuple

F32 = 4


def msda(B: int, Q: int, heads: int, L: int, T: int, R: int, D: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one msda_fwd call."""
    taps = B * Q * heads * L * T
    moved = B * R * D + 3 * taps + B * Q * D
    return float(moved * F32), float(8 * B * Q * D * L * T)


def dcn_im2col(B: int, H: int, W: int, C: int, Ho: int, Wo: int,
               k: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one deform_im2col_fwd call."""
    entries = B * Ho * Wo * k * k
    moved = B * H * W * C + 3 * entries + entries * C
    return float(moved * F32), float(9 * entries * C)
