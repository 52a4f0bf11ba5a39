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
def tuned_convolutions():
    """cuDNN times the candidate engines of each convolution inside the
    block and keeps the fastest (``cudnn.benchmark``; the first
    ``cudnn.benchmark_limit`` of its list, 10 by default), in place of its
    heuristic's first choice, which at some shapes is an FFT engine several
    times slower than implicit GEMM; the process's setting restored after
    it. The candidates are those of the precision in force, so the block
    changes no precision. cuDNN keeps one plan a shape for the life of the
    process, whichever way it was chosen: only a shape first met inside
    the block is timed, once, on that call."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark
    cudnn.benchmark = True
    try:
        yield
    finally:
        cudnn.benchmark = before


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
