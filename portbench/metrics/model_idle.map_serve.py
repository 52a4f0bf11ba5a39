"""The share of the traced frames' forward passes (``map.forward`` spans) in
which the device ran nothing: the model's own host dispatch, with the
host-to-device copies and the wait between frames left out."""

from harness import spans

LAYER = "mapping model host dispatch: mapping/stream_mapnet"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    total = spans.length(spans.intervals(trace, "map.forward"))
    if total <= 0:
        return None
    return 100.0 * spans.idle_us(trace, "map.forward") / total
