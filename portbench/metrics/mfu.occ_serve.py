"""Model FLOPs of the traced frames (every forward convolution and matrix
product, from the shapes one frame records: harness.opcount) over the
traced window's seconds times the float32 peak."""

from counts.peaks import F32_FLOPS_PER_S

LAYER = "occupancy model: occupancy/bevdet_occ"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    flops = work.get("model_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * F32_FLOPS_PER_S)
