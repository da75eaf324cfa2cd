"""raw <-> EV integer lookup tables, bit-exact with the reference.

Counterpart of ``mlvfs_tpu/ops/luts.py`` (host numpy, unchanged): the 14/16-bit
tables (get_raw2ev / get_ev2raw, main.c:128-196) that the focus-pixel fix
needs. The pipeline works in "EV space": a fixed-point log2 of the signal
above black, at EV_RESOLUTION steps per stop.

Bit-exactness notes: C computes ``(int)(log2(i) * EV_RESOLUTION)``, which
truncates toward zero; log2(0) = -inf casts to INT_MIN on x86, reproduced at
index ``black``. Tables are memoized per black level.
"""

from __future__ import annotations

import functools

import numpy as np

EV_RESOLUTION = 32768  # mlvfs.h:87
MAX_BLACK = 16384  # mlvfs.h:88
INT_MIN = -(2**31)


@functools.lru_cache(maxsize=16)
def raw2ev_lut(black: int, size: int = None) -> np.ndarray:
    """Integer raw→EV table indexed by raw value in [0, size).

    Matches get_raw2ev (main.c:154-179): value = trunc(log2(p - black) * EVR)
    for p > black, 0 for p < black, INT_MIN at p == black (C casts -inf).
    Default size covers the reachable range p in [0, 16384 + black).
    """
    if size is None:
        size = 16384 + black
    p = np.arange(size, dtype=np.int64)
    sig = p - black
    with np.errstate(divide="ignore", invalid="ignore"):
        ev = np.log2(np.maximum(sig, 1).astype(np.float64)) * EV_RESOLUTION
    out = np.where(sig > 0, np.trunc(ev), 0.0).astype(np.int64)
    out = np.where(sig == 0, INT_MIN, out)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=1)
def ev2raw_lut() -> np.ndarray:
    """EV→raw table over [-10*EVR, 14*EVR) shifted to index 0 (main.c:181-196).

    Entry j corresponds to EV index j - 10*EVR; value = (int)pow(2, ev/EVR)
    with the double result truncated. Callers index it as ``table[ev + 10*EVR]``.
    """
    i = np.arange(-10 * EV_RESOLUTION, 14 * EV_RESOLUTION, dtype=np.int64)
    vals = np.power(2.0, i.astype(np.float64) / EV_RESOLUTION)
    return np.trunc(vals).astype(np.int64).clip(INT_MIN, 2**31 - 1).astype(np.int32)
