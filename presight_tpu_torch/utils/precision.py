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


@contextlib.contextmanager
def ieee_matmul():
    """f32 matrix products in IEEE f32 inside the block, on the card (cuBLAS,
    not TF32) and on the CPU (oneDNN, not bf16), the process's settings
    restored after it."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    before = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(backends, before):
            b.fp32_precision = p
