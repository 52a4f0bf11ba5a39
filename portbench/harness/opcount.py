"""Record the shapes of a unit of work's convolutions and matrix products
(a TorchDispatchMode over one unit in set-up) and count their work with
``counts.conv``."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from counts import conv as C
from counts.peaks import bound_s

aten = torch.ops.aten
_MATMULS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1), aten.addmm.default: (1, 2),
            aten.baddbmm.default: (1, 2)}


class OpCounter(TorchDispatchMode):
    """Sums, over the ops it sees: forward convolutions' and convolution
    backwards' bytes, FLOPs and least times (each convolution's own bound,
    summed), and matrix products' FLOPs."""

    def __init__(self):
        super().__init__()
        self.work: Dict[str, float] = dict.fromkeys(
            ("conv_fwd_bytes", "conv_fwd_flops", "conv_fwd_bound_s", "conv_bwd_bytes",
             "conv_bwd_flops", "conv_bwd_bound_s", "matmul_flops"), 0.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is aten.convolution.default:
            b, f = C.conv_fwd(args[0].shape, args[1].shape, out.shape, args[2] is not None)
            self.work["conv_fwd_bytes"] += b
            self.work["conv_fwd_flops"] += f
            self.work["conv_fwd_bound_s"] += bound_s(b, f)
        elif func is aten.convolution_backward.default:
            grad_out, x, w = args[0], args[1], args[2]
            mask = args[10]
            b, f = C.conv_bwd(x.shape, w.shape, grad_out.shape, bool(mask[0]), bool(mask[1]))
            self.work["conv_bwd_bytes"] += b
            self.work["conv_bwd_flops"] += f
            self.work["conv_bwd_bound_s"] += bound_s(b, f)
        elif func in _MATMULS:
            i, j = _MATMULS[func]
            self.work["matmul_flops"] += C.matmul_flops(args[i].shape, args[j].shape)
        return out


def count(fn) -> Dict[str, float]:
    """Run fn() once under the counter; its work by kind."""
    with OpCounter() as counter:
        fn()
    return counter.work
