"""ctypes binding of the host JPEG codec (jpeg.cpp).

``decode`` returns the pixels Pillow (on libjpeg-turbo) returns for a
baseline file: ``np.asarray(Image.open(path))``, (H, W, 3) for colour and
(H, W) for greyscale. ``encode`` writes what ``Image.save(path)`` writes
for RGB pixels with Pillow's defaults (quality 75, 4:2:0). The library is built by g++ at
first use (native.build); a failed build raises, and a file the codec does
not handle (progressive, arithmetic-coded, 12-bit, ...) raises ValueError.
ctypes releases the interpreter lock for the call, so a thread pool decodes
in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from . import build

SOURCE = Path(__file__).resolve().parent / "jpeg.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_ERRLEN = 256


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build(SOURCE)))
            c_int_p = ctypes.POINTER(ctypes.c_int)
            handle.jpeg_info.restype = ctypes.c_int
            handle.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_int_p, c_int_p,
                                         c_int_p, ctypes.c_char_p, ctypes.c_int]
            handle.jpeg_decode.restype = ctypes.c_int
            handle.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            handle.jpeg_encode.restype = ctypes.c_int64
            handle.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                           ctypes.c_int]
            _lib = handle
    return _lib


def _read(src: Union[str, Path, bytes]) -> bytes:
    return bytes(src) if isinstance(src, (bytes, bytearray)) else Path(src).read_bytes()


def info(src: Union[str, Path, bytes]) -> Tuple[int, int, int]:
    """(height, width, channels) from the frame header."""
    data = _read(src)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib().jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                       err, _ERRLEN) != 0:
        raise ValueError(f"{_name(src)}: {err.value.decode()}")
    return h.value, w.value, c.value


def decode(src: Union[str, Path, bytes]) -> np.ndarray:
    """uint8 pixels of a baseline JPEG file (a path) or its bytes."""
    data = _read(src)
    h, w, c = info(data)
    out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib().jpeg_decode(data, len(data), out.ctypes.data, out.size, err, _ERRLEN) != 0:
        raise ValueError(f"{_name(src)}: {err.value.decode()}")
    return out


def encode(pixels: np.ndarray) -> bytes:
    """Baseline JFIF bytes of (H, W, 3) uint8 ``pixels``, as Pillow's
    ``Image.save`` writes them by default (quality 75, 4:2:0)."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8, got {pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    cap = h * w * 3 + 4096
    err = ctypes.create_string_buffer(_ERRLEN)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib().jpeg_encode(pixels.ctypes.data, w, h, out.ctypes.data, cap, err, _ERRLEN)
        if n < 0:
            raise ValueError(f"jpeg encode: {err.value.decode()}")
        if n <= cap:
            return out[:n].tobytes()
        cap = int(n)


def save(path: Union[str, Path], pixels: np.ndarray) -> None:
    Path(path).write_bytes(encode(pixels))


def _name(src) -> str:
    return "<bytes>" if isinstance(src, (bytes, bytearray)) else str(src)
