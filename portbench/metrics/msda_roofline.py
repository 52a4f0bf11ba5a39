"""S3 ``msda_fwd``'s least time on the card (counts.map.msda for the shapes
of every call a frame makes, recorded in set-up: the temporal
self-attention, the spatial cross-attention over the cameras' compacted
queries and each decoder layer's cross-attention; each call's own bound,
summed) over the device time launched inside the ``map.msda`` spans, which
hold the kernel's launch and nothing else."""

from harness import spans

LAYER = "kernel S3: mapping/deformable"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    t = spans.device_s(trace, "map.msda")
    if not t or not work.get("msda_bound_s"):
        return None
    return 100.0 * work["msda_bound_s"] / t
