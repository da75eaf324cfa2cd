"""Vertical stripe (column banding) correction.

Counterpart of ``mlvfs_tpu/ops/stripes.py``. 5D3/7D highlight banding: some
columns (period 8) have slightly different gain. Calibration compares each
column against columns 0/1 via log2-ratio histograms and takes the median
ratio (stripes_compute_correction, stripes.c:143-248, from the first frame of
a clip only); correction is a per-column-mod-8 fixed-point multiply applied
to sufficiently bright pixels (stripes_apply_correction, stripes.c:250-266).

Calibration is the reference's host numpy, copied as it is with the same
seeded dither, so the gains are identical. Application is plain torch in
int64, where ``(p - black) * gain >> 16`` is exact.

Not ported yet: ``calibrate_batch_device`` (``--stripes-batch-cal``), which
comes with the multi-GPU slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .unpack import to_int16_bits

FIXP_ONE = 65536
FIXP_RANGE = 65536


def compute_correction(
    frame,
    black: int,
    white: int,
    width: int,
    frame_size_bytes: int = None,
    rng: np.random.Generator = None,
):
    """Per-column-mod-8 fixed-point gains from one frame.

    Returns (gains[8] int32, needed bool). Gain 0 means "not enough data,
    leave column untouched" (the apply step checks for 0, stripes.c:261).

    The reference adds +/-0.5 uniform dither to defeat quantization spikes
    using libc rand(); we use a seeded generator — the median over thousands
    of samples is insensitive to the dither realization.
    """
    img = np.asarray(frame, np.int64)
    h, w = img.shape
    if frame_size_bytes is None:
        frame_size_bytes = w * h * 14 // 8
    if rng is None:
        rng = np.random.default_rng(0x57A1BE5)

    p = img - black
    starts = np.arange(0, w - 10, 8)
    if len(starts) == 0:
        return np.zeros(8, np.int32), False

    cols = {k: p[:, starts + k].ravel().astype(np.float64) for k in range(10)}

    # (offset, ref_col, cur_col, multiplicity) — stripes.c:175-203:
    # nearer reference pixels get higher multiplicity
    combos = [
        (2, 0, 2, 3), (2, 8, 2, 1),
        (3, 1, 3, 3), (3, 9, 3, 1),
        (4, 0, 4, 2), (4, 8, 4, 2),
        (5, 1, 5, 2), (5, 9, 5, 2),
        (6, 0, 6, 1), (6, 8, 6, 3),
        (7, 1, 7, 1), (7, 9, 7, 3),
    ]

    hist = np.zeros((8, FIXP_RANGE), np.int64)
    num = np.zeros(8, np.int64)
    too_bright = white / 1.5
    for offset, ra, rb, mult in combos:
        a, b = cols[ra], cols[rb]
        valid = (np.minimum(a, b) >= 32) & (np.maximum(a, b) <= too_bright)
        av, bv = a[valid], b[valid]
        n = len(av)
        if n == 0:
            continue
        for _ in range(mult):
            af = av + rng.integers(0, 1024, n) / 1024.0 - 0.5
            bf = bv + rng.integers(0, 1024, n) / 1024.0 - 0.5
            ev = np.log2(af / bf)
            buckets = np.clip(
                np.trunc(FIXP_RANGE / 2 + ev * (FIXP_RANGE / 2)).astype(np.int64),
                0,
                FIXP_RANGE - 1,
            )
            hist[offset] += np.bincount(buckets, minlength=FIXP_RANGE)
            num[offset] += n

    gains = np.zeros(8, np.int64)
    for j in range(2, 8):
        if num[j] < frame_size_bytes // 128:
            continue
        cum = np.cumsum(hist[j])
        k = int(np.searchsorted(cum, num[j] // 2))  # first k with cum >= num/2
        ev = (k - FIXP_RANGE / 2) / (FIXP_RANGE / 2)
        gains[j] = int(2.0**ev * FIXP_ONE)
    gains[0] = gains[1] = FIXP_ONE

    needed = bool(np.any((gains != 0) & (np.abs(gains / FIXP_ONE - 1.0) > 0.002)))
    return gains.astype(np.int32), needed


@functools.lru_cache(maxsize=16)
def _column_gains(gains: tuple, width: int, device: torch.device) -> torch.Tensor:
    """(W,) int64 gain per column on ``device``, uploaded once per clip."""
    return torch.tensor(gains, dtype=torch.int64).repeat(width // 8).to(device)


def apply_correction_batch(imgs: torch.Tensor, gains, black: int, white: int) -> torch.Tensor:
    """Apply gains to a batch (B, H, W) int16 (u16 bits); no-op unless
    width % 8 == 0.

    result = min(white, (p - black) * gain // 65536 + black) for pixels
    above black + 64 in columns with nonzero gain (stripes.c:250-266: the C
    multiplies in double and truncates, which is exact at these magnitudes).
    """
    w = imgs.shape[-1]
    if w % 8 != 0:
        return imgs
    g = _column_gains(tuple(int(v) for v in np.asarray(gains).reshape(8)), w, imgs.device)
    p = imgs.to(torch.int64) & 0xFFFF
    corrected = torch.clamp(((p - black) * g >> 16) + black, max=white)
    active = (g != 0) & (p > black + 64)
    return to_int16_bits(torch.where(active, corrected, p) & 0xFFFF)
