"""S3 ``deform_im2col_fwd``'s least time on the card (counts.map.dcn_im2col
for the shapes of every call a frame makes, recorded in set-up: the two
DCNv2 layers' columns; each call's own bound, summed) over the device time
launched inside the ``map.dcn_im2col`` spans, which hold the kernel's
launch and nothing else."""

from harness import spans

LAYER = "kernel S3: mapping/deformable"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    t = spans.device_s(trace, "map.dcn_im2col")
    if not t or not work.get("dcn_im2col_bound_s"):
        return None
    return 100.0 * work["dcn_im2col_bound_s"] / t
