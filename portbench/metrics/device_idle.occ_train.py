"""The share of the traced window in which no operation ran on the card."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "occ_train_frames_per_s"
UNIT = "%"


def read(trace, work):
    if trace.window_s <= 0 or not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
