"""The share of the traced window in which no operation ran on the card:
``device_idle.occ_serve``'s reader, for the mapping cell."""

from harness import load

_READER = load.metric("device_idle.occ_serve")

LAYER = "device"
SOURCE = "device_trace"
MOVES = "occ_frame_ms_p95"
UNIT = "%"

read = _READER.read
