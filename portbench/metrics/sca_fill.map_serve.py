"""The share of the spatial cross-attention's computed (camera, query)
slots that hold a query the camera sees: the program's counters
``map.sca_pairs`` over ``map.sca_slots`` (cameras x capacity) over the
traced frames (the program counts them only inside a profiler session)."""

LAYER = "mapping spatial cross-attention: mapping/bev_encoder compaction"
SOURCE = "program_counter"
MOVES = "occ_frame_ms_p95"
UNIT = "%"


def read(trace, work):
    try:
        from presight_tpu_torch.utils.profiler import COUNTS
    except ImportError:  # a program without counters
        return None
    if not COUNTS["map.sca_slots"]:
        return None
    return 100.0 * COUNTS["map.sca_pairs"] / COUNTS["map.sca_slots"]
