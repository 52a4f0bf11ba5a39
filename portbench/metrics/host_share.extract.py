"""The share of the traced frames' time (``extract.frame`` spans) that the
host spent in its own numpy, files and native code: the union of the
``extract.select``, ``extract.colors``, ``extract.spill``, ``extract.fold``
and ``extract.write`` spans."""

from harness import spans

LAYER = "extraction host: prior/extraction, prior/voxelize, native"
SOURCE = "device_trace"
MOVES = "extract_frames_per_s"
UNIT = "%"
HOST = ("extract.select", "extract.colors", "extract.spill", "extract.fold", "extract.write")


def read(trace, work):
    frame = spans.length(spans.intervals(trace, "extract.frame"))
    if frame <= 0:
        return None
    host = spans.union([iv for name in HOST for iv in spans.intervals(trace, name)])
    return 100.0 * spans.length(host) / frame
