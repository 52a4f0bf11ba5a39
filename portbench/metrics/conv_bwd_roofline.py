"""Every convolution backward's least time (dgrad and wgrad from its shapes,
each convolution's own bound, summed: counts.conv) over the device time
launched under aten::convolution_backward in the traced steps."""

LAYER = "occupancy model convolutions: occupancy/backbones, bevdet_occ"
SOURCE = "device_trace"
MOVES = "occ_train_frames_per_s"
UNIT = "%"


def read(trace, work):
    t = trace.device_s_under("aten::convolution_backward")
    if not t or not work.get("conv_bwd_bound_s"):
        return None
    return 100.0 * work["conv_bwd_bound_s"] / t
