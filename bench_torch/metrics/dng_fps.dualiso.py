"""Dual-ISO DNGs written in the window per second of the window: every
batch handed out until ``--seconds`` had passed, over the time from the
window's start to its last DNG's ``writev``."""

SOURCE = "host_clock"
UNIT = "frames/s"


def read(rec):
    return rec.frames / rec.seconds
