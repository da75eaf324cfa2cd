"""Reads a written DNG independently of the program: IFD0's tags, and the
16-bit payload its strip points at."""

from __future__ import annotations

import struct

import numpy as np

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}
_TYPE_FMT = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 7: "B", 9: "i", 10: "ii"}

IMAGE_WIDTH, IMAGE_LENGTH, BITS_PER_SAMPLE = 256, 257, 258
STRIP_OFFSETS, STRIP_BYTE_COUNTS = 273, 279
BLACK_LEVEL, WHITE_LEVEL, BASELINE_EXPOSURE = 50714, 50717, 50730


def ifd0(raw: bytes) -> dict:
    """{tag: tuple of values} of IFD0 of a little-endian TIFF."""
    if raw[:4] != b"II*\0":
        raise ValueError("not a little-endian TIFF")
    off = struct.unpack_from("<I", raw, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", raw, off)[0]):
        tag, typ, count, value = struct.unpack_from("<HHI4s", raw, off + 2 + 12 * i)
        size = _TYPE_SIZE.get(typ)
        if size is None:
            continue
        data = value if size * count <= 4 else raw[struct.unpack("<I", value)[0]:][: size * count]
        fmt = "<" + _TYPE_FMT[typ] * count
        tags[tag] = struct.unpack_from(fmt, data)
    return tags


def read(path: str):
    """(tags, (H, W) uint16 payload) of a DNG, or None if it is missing or short."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        tags = ifd0(raw)
        w, h = tags[IMAGE_WIDTH][0], tags[IMAGE_LENGTH][0]
        start, n = tags[STRIP_OFFSETS][0], tags[STRIP_BYTE_COUNTS][0]
    except (ValueError, KeyError, struct.error):
        return None
    if n != w * h * 2 or len(raw) < start + n:
        return None
    return tags, np.frombuffer(raw, "<u2", w * h, start).reshape(h, w)


def header_faults(tags: dict, width: int, height: int, levels, bias) -> list:
    """Names of the header fields that differ from what the reference gives:
    size, 16 bits, the levels, and BaselineExposure when ``bias`` is given."""
    want = {IMAGE_WIDTH: (width,), IMAGE_LENGTH: (height,), BITS_PER_SAMPLE: (16,),
            BLACK_LEVEL: (levels[0],), WHITE_LEVEL: (levels[1],)}
    if bias is not None:
        want[BASELINE_EXPOSURE] = tuple(bias)
    return [tag for tag, value in want.items() if tags.get(tag) != value]
