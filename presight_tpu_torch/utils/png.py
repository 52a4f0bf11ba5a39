"""PNG writer over the standard library's zlib (what scripts/render.py
writes): 8-bit greyscale (H, W) and 8-bit RGB (H, W, 3) uint8 images,
every row unfiltered, one IDAT chunk."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB = 0, 2  # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, image: np.ndarray) -> None:
    """Write ``image``, (H, W) or (H, W, 3) uint8, to ``path``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    colour = _GREY if image.ndim == 2 else _RGB
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                           + _chunk(b"IEND", b""))
