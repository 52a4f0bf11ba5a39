"""The share of the traced training steps' time that the host spent
getting the step's batch (``trainer.batch``: the data manager's next batch
and its gather on the device) over the ``trainer.step`` spans' time."""

from harness import spans

LAYER = "data: data/datamanager, data/device_store"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(trace, work):
    step = spans.length(spans.intervals(trace, "trainer.step"))
    if step <= 0:
        return None
    return 100.0 * spans.length(spans.intervals(trace, "trainer.batch")) / step
