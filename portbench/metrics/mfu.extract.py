"""MLP FLOPs of the traced frames' depth renders (counts.nerf.depth_flops:
every proposal round and the main field's density, a lower bound that
leaves out the point queries) over the traced window's seconds times the
float32 peak."""

from counts.peaks import F32_FLOPS_PER_S

LAYER = "extraction: prior/extraction"
SOURCE = "device_trace"
MOVES = "extract_frames_per_s"
UNIT = "%"


def read(trace, work):
    flops = work.get("model_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * F32_FLOPS_PER_S)
