"""Reference copy of ``mlvfs_tpu_torch/ops/luts.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

raw <-> EV integer lookup tables, bit-exact with the reference.

Counterpart of ``mlvfs_tpu/ops/luts.py`` (host numpy, unchanged): the 14/16-bit
tables (get_raw2ev / get_ev2raw, main.c:128-196) that the focus-pixel fix
and chroma smoothing need, and the 20-bit tables (build_ev2raw_lut,
hdr.c:839-874) and fullres curve (hdr.c:890-913) of the full dual-ISO
reconstruction. The pipeline works in "EV space": a fixed-point log2 of the
signal above black, at EV_RESOLUTION steps per stop.

Bit-exactness notes: C computes ``(int)(log2(i) * EV_RESOLUTION)``, which
truncates toward zero; log2(0) = -inf casts to INT_MIN on x86, reproduced at
index ``black``. The 20-bit raw→EV table rounds instead, and is symmetric
(log1p-style) below black. Tables are memoized per level.
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


@functools.lru_cache(maxsize=8)
def _luts20(black: int, white: int):
    """20-bit raw2ev + ev2raw tables (build_ev2raw_lut, hdr.c:839-874).

    black/white here are 20-bit levels (14-bit levels * 64).
    Returns (raw2ev[1<<20] int32, ev2raw_0[24*EVR] int32); index ev2raw_0 by
    ``ev + 10*EVR``.
    """
    i = np.arange(1 << 20, dtype=np.int64)
    signal = np.maximum(i / 64.0 - black / 64.0, -1023.0)
    pos = np.round(np.log2(1 + np.abs(signal)) * EV_RESOLUTION)
    raw2ev = np.where(signal > 0, pos, -np.round(np.log2(1 - np.minimum(signal, 0)) * EV_RESOLUTION))
    raw2ev = raw2ev.astype(np.int32)

    j = np.arange(-10 * EV_RESOLUTION, 14 * EV_RESOLUTION, dtype=np.int64)
    ev2raw = np.empty(24 * EV_RESOLUTION, np.int64)
    neg = j < 0
    ev2raw[neg] = np.clip(
        black + 64 - np.round(64 * np.power(2.0, -j[neg] / EV_RESOLUTION)), 0, black
    )
    nonneg = ~neg
    vals = np.clip(
        black - 64 + np.round(64 * np.power(2.0, j[nonneg] / EV_RESOLUTION)),
        black,
        (1 << 20) - 1,
    )
    # for ev >= raw2ev[white], clamp up to at least white (hdr.c:861-864)
    thr = raw2ev[min(white, (1 << 20) - 1)]
    vals = np.where(j[nonneg] >= thr, np.maximum(vals, white), vals)
    ev2raw[nonneg] = vals
    ev2raw = ev2raw.astype(np.int32)
    # keep "bad" pixels: ev2raw[raw2ev[0]] = 0 (hdr.c:868)
    ev2raw[int(raw2ev[0]) + 10 * EV_RESOLUTION] = 0
    raw2ev.setflags(write=False)
    ev2raw.setflags(write=False)
    return raw2ev, ev2raw


def raw2ev_lut20(black: int, white: int) -> np.ndarray:
    return _luts20(black, white)[0]


def ev2raw_lut20(black: int, white: int) -> np.ndarray:
    return _luts20(black, white)[1]


@functools.lru_cache(maxsize=8)
def fullres_curve(black20: int) -> np.ndarray:
    """Fullres mixing curve over 20-bit values (build_fullres_curve, hdr.c:890-913)."""
    fullres_start, fullres_transition = 4.0, 4.0
    i = np.arange(1 << 20, dtype=np.float64)
    ev2 = np.log2(np.maximum(i / 64.0 - black20 / 64.0, 1.0))
    c2 = -np.cos(np.clip(ev2 - fullres_start, 0, fullres_transition) * np.pi / fullres_transition)
    return (c2 + 1) / 2
