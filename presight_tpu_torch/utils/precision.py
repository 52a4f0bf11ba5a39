"""Scoped float32 precision settings of the card's libraries."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_convolutions():
    """cuDNN convolutions in IEEE f32 inside the block (under torch's
    defaults they run in TF32, about three decimal digits), the process's
    setting restored after it."""
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = before
