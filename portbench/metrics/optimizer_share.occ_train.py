"""The share of the traced steps' (``occ.train_step`` spans) device busy
time that the host launched under ``occ.optimizer``: the zero-filled
gradients, the global-norm clip, AdamW and the EMA."""

from harness import spans

LAYER = "occupancy step optimizer: scripts/train_occ, utils/ema"
SOURCE = "device_trace"
MOVES = "occ_train_frames_per_s"
UNIT = "%"


def read(trace, work):
    if not spans.events(trace, "occ.train_step") or trace.busy_s <= 0:
        return None
    return 100.0 * spans.device_s(trace, "occ.optimizer") / trace.busy_s
