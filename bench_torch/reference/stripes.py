"""Reference copy of ``mlvfs_tpu_torch/ops/stripes.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Vertical stripe (column banding) correction.

Counterpart of ``mlvfs_tpu/ops/stripes.py``. 5D3/7D highlight banding: some
columns (period 8) have slightly different gain. Calibration compares each
column against columns 0/1 via log2-ratio histograms and takes the median
ratio (stripes_compute_correction, stripes.c:143-248, from the first frame of
a clip only); correction is a per-column-mod-8 fixed-point multiply applied
to sufficiently bright pixels (stripes_apply_correction, stripes.c:250-266).

The frame-0 calibration is the reference's host numpy, copied as it is with
the same seeded dither, so the gains are identical. The whole-batch
calibration (``--stripes-batch-cal``, :func:`calibrate_batch_device`) is
plain torch on the batch's device, with the float32 roundings of XLA's CPU
backend (``evmath``). Application is plain torch in int64, where
``(p - black) * gain >> 16`` is exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .evmath import exp2_f32, fma, log2_f32
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


# (offset, reference column, multiplicity) — stripes.c:175-203; reference
# columns 8 and 9 are columns 0 and 1 of the next block of 8
_BATCH_COMBOS = [
    (2, 0, 3), (2, 8, 1),
    (3, 1, 3), (3, 9, 1),
    (4, 0, 2), (4, 8, 2),
    (5, 1, 2), (5, 9, 2),
    (6, 0, 1), (6, 8, 3),
    (7, 1, 1), (7, 9, 3),
]


def calibrate_batch_device(imgs: torch.Tensor, black: int, white: int, frame_size_bytes: int):
    """Stripe gains from a whole batch (B, H, W) int16 (u16 bits) on its
    device: the reference's ``calibrate_batch_device``
    (``mlvfs_tpu/ops/stripes.py:111-184``), the multi-frame form of
    :func:`compute_correction` (stripes.c:143-248) behind
    ``--stripes-batch-cal``.

    Each offset's median log2 ratio comes from 17 bisection rounds of
    batch-wide int32 counts (exact in any order) instead of a histogram, and
    no dither is added. Returns (gains (8,) int32, needed bool 0-dim), both
    on the batch's device: nothing is read back until the caller reads them.
    The width must be a multiple of 8, as the reference's reshape needs.

    The float32 steps round as XLA's CPU backend rounds them: ``log2`` and
    ``exp2`` are :func:`~.evmath.log2_f32` and :func:`~.evmath.exp2_f32`,
    ``32768 + ev * 32768`` is one fused multiply-add (the product by 2^15
    is exact, so it is also the plain form), and the Python-float bounds
    ``white / 1.5`` and ``1e-9`` are taken as float32."""
    b, h, w = imgs.shape
    nb = w // 8
    if w != nb * 8:
        raise ValueError(f"the batch stripe calibration takes widths that are multiples of 8, got {w}")
    p = ((imgs.to(torch.int32) & 0xFFFF).to(torch.float32) - float(black)).reshape(b, h, nb, 8)
    # column k of block i; references 8/9 are columns 0/1 of block i + 1.
    # Blocks that start at or past w - 10 are left out, as the C loop bound
    # (stripes.c:175)
    n_use = min((w - 10 + 7) // 8, nb - 1)
    cur = p[:, :, :n_use, :]
    nxt = p[:, :, 1 : n_use + 1, :2]
    too_bright = float(np.float32(white / 1.5))
    tiny = float(np.float32(1e-9))
    half = FIXP_RANGE / 2
    dev = imgs.device

    by_offset = {j: [] for j in range(2, 8)}
    for offset, ref_col, mult in _BATCH_COMBOS:
        a = cur[..., ref_col] if ref_col < 8 else nxt[..., ref_col - 8]
        bcol = cur[..., offset]
        valid = (torch.minimum(a, bcol) >= 32) & (torch.maximum(a, bcol) <= too_bright)
        ev = log2_f32(torch.clamp(a, min=tiny) / torch.clamp(bcol, min=tiny))
        bk = torch.clamp(torch.trunc(fma(ev, half, half)), 0, FIXP_RANGE - 1).to(torch.int32)
        by_offset[offset].append((bk, valid, mult))

    gains = [torch.full((), FIXP_ONE, dtype=torch.int32, device=dev)] * 2
    needed = torch.zeros((), dtype=torch.bool, device=dev)
    for j in range(2, 8):
        js = by_offset[j]
        num = sum(m * torch.sum(v, dtype=torch.int32) for bk, v, m in js)
        lo = torch.zeros((), dtype=torch.int32, device=dev)
        hi = torch.full((), FIXP_RANGE, dtype=torch.int32, device=dev)
        for _ in range(17):
            mid = (lo + hi) >> 1
            cnt = sum(m * torch.sum(v & (bk <= mid), dtype=torch.int32) for bk, v, m in js)
            take = cnt >= torch.div(num + 1, 2, rounding_mode="floor")
            hi = torch.where(take, mid, hi)
            lo = torch.where(take, lo, mid + 1)
        ev = (lo.to(torch.float32) - half) / half
        g = torch.trunc(exp2_f32(ev) * float(FIXP_ONE)).to(torch.int32)
        g = torch.where(num >= b * (frame_size_bytes // 128), g, 0)
        gains.append(g)
        off_one = torch.abs(g.to(torch.float32) / FIXP_ONE - 1.0)
        needed = needed | ((g != 0) & (off_one > float(np.float32(0.002))))
    return torch.stack(gains), needed


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
