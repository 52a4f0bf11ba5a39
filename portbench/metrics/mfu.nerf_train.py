"""Model FLOPs of the traced training steps (counts.nerf.train_step_flops:
the MLPs' products, forward and backward) over the traced window's seconds
times the float32 peak."""

from counts.peaks import F32_FLOPS_PER_S

LAYER = "step: engine/train_step"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(trace, work):
    flops = work.get("model_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * F32_FLOPS_PER_S)
