"""Per-image record with lazy numpy loaders (presight_tpu/data/image_metadata.py).

The loaders return what the JAX package's return, without Pillow:

  * RGB jpg through the port's codec (native/jpeg.py), then Pillow's LANCZOS
    resize (``lanczos_resize``, a port of Pillow's ImagingResample) when the
    size differs; float32 in [0, 1]
  * dynamic-object mask (optional 8-bit png, ``read_png``; plus the ego-truck
    mask on CAM_BACK's bottom 1/9)
  * per-pixel depth npz (nearest-exact resize), -1 where absent
  * segmentation class-map npz uint8
  * DINO feature npz (H, W, 64) float16 -> float32
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import jpeg


def _nearest_resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """nearest-exact resize matching F.interpolate(mode='nearest-exact'):
    sample at (i + 0.5) * scale - 0.5 rounded to nearest."""
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr
    rows = np.clip(np.round((np.arange(h) + 0.5) * arr.shape[0] / h - 0.5), 0,
                   arr.shape[0] - 1).astype(np.int64)
    cols = np.clip(np.round((np.arange(w) + 0.5) * arr.shape[1] / w - 0.5), 0,
                   arr.shape[1] - 1).astype(np.int64)
    return arr[rows][:, cols]


def _is_back_cam(path: str) -> bool:
    return "CAM_BACK" in path and "CAM_BACK_RIGHT" not in path and "CAM_BACK_LEFT" not in path


# ---------------------------------------------------------------- LANCZOS

_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    """Pillow's lanczos_filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coefficients(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for support 3:
    per output pixel the first input index, the count and the fixed-point
    weights (22 fraction bits), in double precision as Pillow computes them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:  # in order: Python's sum() of floats is compensated
            ww += v
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << _PRECISION_BITS))
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of ImagingResample{Horizontal,Vertical}_8bpc along ``axis``
    of a uint8 (H, W, C) image: int32 sums from a 2^21 bias, >> 22, clipped
    to uint8."""
    bounds, kk = _coefficients(img.shape[axis], out_size)
    ksize = kk.shape[1]
    idx = np.minimum(bounds[:, :1] + np.arange(ksize)[None], img.shape[axis] - 1)
    src = np.take(img.astype(np.int64), idx.reshape(-1), axis=axis)
    shape = list(img.shape)
    shape[axis:axis + 1] = [out_size, ksize]
    src = src.reshape(shape)
    wshape = [1] * src.ndim
    wshape[axis], wshape[axis + 1] = out_size, ksize
    acc = (src * kk.reshape(wshape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.resize((width, height), Image.LANCZOS)`` of a uint8 (H, W, C)
    image: the horizontal pass first, each pass rounded to uint8; a pass
    whose size does not change is skipped, as Pillow skips it."""
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, axis=1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, axis=0)
    return out


# ---------------------------------------------------------------- PNG

def read_png(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` of an 8-bit non-interlaced greyscale,
    RGB or palette PNG (a palette image gives its indices, as Pillow's 'P'
    mode does). Anything else raises ValueError."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, RGB or palette PNG is "
                         f"read (bit depth {depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * channels
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data size does not match its header")
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    bpp = channels
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b, c = prev[x], prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(height, width, channels) if channels == 3 else out.reshape(height, width)


@dataclasses.dataclass
class ImageMetadata:
    image_path: str
    c2w: np.ndarray  # (4, 4) or (3, 4), nerfstudio convention, scaled poses
    W: int
    H: int
    intrinsics: np.ndarray  # (3, 3)
    image_index: int
    time: int
    video_id: int
    is_val: bool = False
    is_key_frame: bool = False
    depth_path: Optional[str] = None
    mask_path: Optional[str] = None
    seg_path: Optional[str] = None
    feature_path: Optional[str] = None

    def load_image(self) -> np.ndarray:
        img = jpeg.decode(self.image_path)
        if img.ndim == 2:  # Image.convert("RGB") of a greyscale file
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[:2] != (self.H, self.W):
            img = lanczos_resize(img, self.W, self.H)
        return img.astype(np.float32) / 255.0

    def load_mask(self) -> np.ndarray:
        """True = valid pixel. Includes the ego-truck mask for CAM_BACK
        (image_metadata.py:63-94)."""
        if self.mask_path is None:
            mask = np.ones((self.H, self.W), dtype=bool)
        else:
            m = read_png(self.mask_path)
            m = _nearest_resize(m.astype(np.uint8), self.H, self.W)
            mask = m > 0
        if _is_back_cam(self.image_path):
            truck_height = int(self.H / 9)
            mask[-truck_height:] = False
        return mask

    def load_depth(self) -> np.ndarray:
        if self.depth_path is None:
            return -np.ones((self.H, self.W), dtype=np.float32)
        d = np.load(self.depth_path)
        if isinstance(d, np.lib.npyio.NpzFile):
            d = d["arr_0"]
        return _nearest_resize(np.asarray(d, np.float32), self.H, self.W)

    def load_segmentation(self) -> np.ndarray:
        if self.seg_path is None:
            return np.zeros((self.H, self.W), dtype=np.uint8)
        s = np.load(self.seg_path)
        if isinstance(s, np.lib.npyio.NpzFile):
            s = s["arr_0"]
        return _nearest_resize(np.asarray(s, np.uint8), self.H, self.W)

    def load_features(self) -> np.ndarray:
        if self.feature_path is None:
            return np.zeros((self.H, self.W, 0), dtype=np.float32)
        f = np.load(self.feature_path)
        if isinstance(f, np.lib.npyio.NpzFile):
            f = f["arr_0"]
        f = np.asarray(f, np.float32)
        if f.shape[0] != self.H or f.shape[1] != self.W:
            rows = np.clip(np.round((np.arange(self.H) + 0.5) * f.shape[0] / self.H - 0.5),
                           0, f.shape[0] - 1).astype(np.int64)
            cols = np.clip(np.round((np.arange(self.W) + 0.5) * f.shape[1] / self.W - 0.5),
                           0, f.shape[1] - 1).astype(np.int64)
            f = f[rows][:, cols]
        return f
