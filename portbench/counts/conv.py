"""Work of convolutions and matrix products, counted from their shapes.

A forward convolution with input (N, Cin, *S_in), weight (Cout, Cin/g, *K)
and output (N, Cout, *S_out) does N * Cout * prod(S_out) * (Cin/g) *
prod(K) multiply-adds, 2 FLOPs each; it reads its input and weight once
and writes its output once (float32: 4 bytes a value), plus the bias.
Its backward takes the gradient of the input (dgrad, where the input
carries one) and of the weight (wgrad): each as many multiply-adds as the
forward. dgrad reads the output's gradient and the weight and writes the
input's gradient; wgrad reads the output's gradient and the input and
writes the weight's gradient. A product of (..., m, k) and (..., k, n)
does m * k * n multiply-adds per batch entry.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

F32 = 4


def conv_macs(x: Sequence[int], w: Sequence[int], out: Sequence[int]) -> int:
    """Multiply-adds of a forward convolution."""
    return out[0] * out[1] * math.prod(out[2:]) * w[1] * math.prod(w[2:])


def conv_fwd(x: Sequence[int], w: Sequence[int], out: Sequence[int],
             bias: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of a forward convolution."""
    moved = (math.prod(x) + math.prod(w) + math.prod(out) + (w[0] if bias else 0)) * F32
    return float(moved), float(2 * conv_macs(x, w, out))


def conv_bwd(x: Sequence[int], w: Sequence[int], out: Sequence[int], input_grad: bool,
             weight_grad: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of a convolution's backward: dgrad and wgrad."""
    macs = conv_macs(x, w, out)
    moved = flops = 0
    if input_grad:
        moved += math.prod(out) + math.prod(w) + math.prod(x)
        flops += 2 * macs
    if weight_grad:
        moved += math.prod(out) + math.prod(x) + math.prod(w)
        flops += 2 * macs
    return float(moved * F32), float(flops)


def matmul_flops(a: Sequence[int], b: Sequence[int]) -> float:
    """FLOPs of a (..., m, k) @ (..., k, n) product."""
    *batch, m, k = a
    return float(2 * math.prod(batch) * m * k * b[-1])
