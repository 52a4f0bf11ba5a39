"""Model FLOPs of the traced frames (every forward convolution and matrix
product, the DCNv2 products and the dense layers among them, from the
shapes one frame records: harness.opcount; and S3's taps, counts.map) over
the traced window's seconds times the float32 peak: ``mfu.occ_serve``'s
reader over ``drivers/map_serve``'s ``model_flops``."""

from harness import load

_READER = load.metric("mfu.occ_serve")

LAYER = "mapping model: mapping/stream_mapnet"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"

read = _READER.read
