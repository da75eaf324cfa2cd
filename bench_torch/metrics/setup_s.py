"""Seconds from the process's start to the window's: imports, the kernel
libraries, the take made and written, the warm-up convert."""

SOURCE = "host_clock"
UNIT = "s"


def read(rec):
    return rec.setup_s
