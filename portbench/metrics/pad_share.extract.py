"""The share of the rows that extraction's chunks send to the depth render
and the point queries that are padding (``_pad_to``): one less the rows
over the padded rows, from the program's counters over the process's
extractions (set-up's included; a ratio, so the traced frames' own)."""

LAYER = "extraction render: prior/extraction chunks"
SOURCE = "program_counter"
MOVES = "extract_frames_per_s"
UNIT = "%"


def read(trace, work):
    try:
        from presight_tpu_torch.utils.profiler import COUNTS
    except ImportError:  # a program without counters
        return None
    padded = COUNTS["extract.rays_padded"] + COUNTS["extract.points_padded"]
    if not padded:
        return None
    return 100.0 * (1.0 - (COUNTS["extract.rays"] + COUNTS["extract.points"]) / padded)
