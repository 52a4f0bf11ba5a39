"""Every forward convolution's least time (from its shapes, each
convolution's own bound, summed: counts.conv) over the device time
launched under aten::convolution in the traced frames."""

LAYER = "occupancy model convolutions: occupancy/backbones, bevdet_occ"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    t = trace.device_s_under("aten::convolution")
    if not t or not work.get("conv_fwd_bound_s"):
        return None
    return 100.0 * work["conv_fwd_bound_s"] / t
