"""The table gradient's least time on the card (counts.nerf.table_grad_step:
the bytes and FLOPs the traced steps' shapes need) over the device time
launched under the _HashEncodeBackward autograd node (K1b, the key sort,
K5 and what else the node launches)."""

from counts.peaks import bound_s

LAYER = "table gradient: ops/hash_encoding _HashEncode.backward"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(trace, work):
    t = trace.device_s_under("autograd::engine::evaluate_function: _HashEncodeBackward")
    if not t or not work.get("table_grad_bytes"):
        return None
    return 100.0 * bound_s(work["table_grad_bytes"], work["table_grad_flops"]) / t
