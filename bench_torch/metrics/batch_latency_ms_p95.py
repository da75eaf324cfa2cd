"""95th percentile, over every batch written in the window, of the time
from the start of its ``fetch_batch`` (its frames read from the take) to
the end of its ``_finish_batch`` (its last DNG's ``writev``): how long after
a take's frames are read their DNGs can be opened, the take's calibration
included where it falls."""

import math

SOURCE = "host_clock"
UNIT = "ms"


def percentile(values, q):
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def read(rec):
    lat = [1e3 * (b["finish"][1] - b["fetch"][0]) for b in rec.batches if b["fetch"]]
    return percentile(lat, 95) if lat else None
