"""Share of the traced window in which no kernel, copy or set ran on the
card (100 minus the union of the device spans over the window), in the
plain cells."""

SOURCE = "device_trace"
UNIT = "%"


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
