"""Model FLOPs of the traced training steps (every convolution forward and
backward and every matrix product, counted from the shapes one step
records: harness.opcount) over the traced window's seconds times the
float32 peak."""

from counts.peaks import F32_FLOPS_PER_S

LAYER = "occupancy step: scripts/train_occ.train_step"
SOURCE = "device_trace"
MOVES = "occ_train_frames_per_s"
UNIT = "%"


def read(trace, work):
    flops = work.get("model_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * F32_FLOPS_PER_S)
