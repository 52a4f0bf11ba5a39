"""The share of the traced frames' forward passes (``occ.forward`` spans)
in which the device ran nothing: the model's own host dispatch, with the
host-to-device copies and the wait between frames left out."""

from harness import spans

LAYER = "occupancy model host dispatch: occupancy/bevdet_occ"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    total = spans.length(spans.intervals(trace, "occ.forward"))
    if total <= 0:
        return None
    return 100.0 * spans.idle_us(trace, "occ.forward") / total
