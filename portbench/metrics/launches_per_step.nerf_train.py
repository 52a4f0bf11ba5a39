"""Kernel launch calls (any thread) that start inside the traced
``trainer.step`` spans, over the number of those spans: the host's
dispatches a training step."""

from harness import spans

LAYER = "dispatch: engine/trainer, engine/train_step"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
UNIT = "launches"


def read(trace, work):
    steps = len(spans.events(trace, "trainer.step"))
    if not steps:
        return None
    return spans.launches(trace, "trainer.step") / steps
