"""Dual-ISO full-path per-frame analysis on the host, in numpy: the
``exact_luts`` mode's analysis.

A copy of ``mlvfs_tpu/ops/dualiso_analysis.py`` (host numpy, no JAX), kept
byte-for-byte in its logic so the port imports nothing of the reference.
These are the data-dependent, control-flow-heavy stages of the cr2hdr port:
Bayer-order detection, bright/dark field identification, white level
detection, and the exposure-matching RANSAC (hdr.c:250-823), in float64 with
the reference's exact integer semantics. They reduce a frame to a handful of
scalars for the batched reconstruction (``dualiso_full.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ExposureFit:
    ok: bool = False
    reason: str = ""
    a: float = 0.0
    b: float = 0.0  # 16-bit offset
    corr_ev: float = 0.0
    white_darkened: int = 0  # 20-bit


def _tdiv(a, b):
    """C-style integer division (truncation toward zero) for arrays."""
    q = np.floor_divide(np.abs(a), b)
    return np.where(a < 0, -q, q)


def identify_rggb_or_gbrg(img: np.ndarray, active_y1: int = 0) -> bool:
    """True for RGGB (hdr.c:441-495): greens are the channel pair whose CDFs
    match best."""
    h, w = img.shape
    y0 = (active_y1 + 3) & ~3
    region = img[y0 : h // 4 * 4].astype(np.int64) & 16383
    ys = np.arange(y0, h // 4 * 4)
    hists = np.zeros((4, 16384), np.int64)
    for py in range(2):
        sel_rows = region[(ys % 2) == py]
        for px in range(2):
            hists[py * 2 + px] = np.bincount(sel_rows[:, px::2].ravel(), minlength=16384)
    cdf = np.cumsum(hists, axis=1)
    diffs_rggb = np.abs(cdf[1] - cdf[2]).sum()
    diffs_gbrg = np.abs(cdf[0] - cdf[3]).sum()
    return bool(diffs_rggb < diffs_gbrg)


def identify_bright_and_dark_fields(img: np.ndarray, black: int, active_y1: int = 0):
    """is_bright[4] from green-channel percentile analysis (hdr.c:497-636)."""
    h, w = img.shape
    white = 10000  # rough guess used at this stage (hdr.c:518)
    y0 = (active_y1 + 3) & ~3

    hists = np.zeros((4, 16384), np.int64)
    region = img[y0 : h // 4 * 4].astype(np.int64) & 16383
    ys = np.arange(y0, h // 4 * 4)
    for q in range(4):
        rows = region[(ys % 4) == q]
        yrows = ys[(ys % 4) == q]
        if len(rows) == 0:
            return False, [0, 0, 0, 0]
        vals = [r[int((y + 1) % 2) :: 2] for r, y in zip(rows, yrows)]
        hists[q] = np.bincount(np.concatenate(vals), minlength=16384)

    hist_total = int(hists[0].sum())
    cum = np.cumsum(hists, axis=1)

    def raw_at(ref):
        """bins consumed until cumsum >= ref; 0 when ref <= 0 (hdr.c:562-569)."""
        if ref <= 0:
            return np.zeros(4, np.int64)
        return np.array(
            [min(np.searchsorted(cum[i], ref, "left") + 1, 16384) for i in range(4)]
        )

    ref_max = int(hist_total * 0.998)
    ref_off = int(hist_total * 0.05)
    # the walk breaks once any raw_i reaches `white` (hdr.c:583-586):
    # raw_i(ref) >= white first at ref = cum[i][white-2] + 1
    first_break = min(int(cum[i][white - 2]) + 1 for i in range(4))
    ref_final = min(ref_max - 1, first_break)
    if ref_final < 0:
        return False, [0, 0, 0, 0]

    thr = black + (white - black) // 4
    # the black-offset snapshot is taken at the last ref < ref_off where
    # max(raw) < thr (hdr.c:571-581); raw is monotone in ref, so that is
    # ref <= min_i cum[i][thr-2]
    cond_bound = min(int(cum[i][max(thr - 2, 0)]) for i in range(4))
    ref_b = min(ref_off - 1, cond_bound, ref_final)
    off = raw_at(ref_b) if ref_b >= 0 else np.zeros(4, np.int64)

    raw = raw_at(ref_final) - off
    srt = np.sort(raw)
    median_bright = (srt[1] + srt[2]) / 2
    is_bright = [bool(r > median_bright) for r in raw]

    ok = sum(is_bright) == 2 and is_bright[0] != is_bright[2] and is_bright[1] != is_bright[3]
    return ok, is_bright


def white_detect(img: np.ndarray, is_bright, active_area) -> tuple:
    """(white_dark, white_bright), 14-bit (white_detect, hdr.c:250-300).

    Replicates the sample-buffer clamp: samples past max_pix-1 collapse into
    the last slot so only the final one survives (hdr.c:278-281).
    """
    h, w = img.shape
    y1, x1, y2, x2 = active_area
    max_pix = w * h // 2 // 9
    discard = [10, 50]
    margins = [100, 1500]

    ys = np.arange(y1, y2, 3)
    xs = np.arange(x1, x2, 3)
    grid = img[np.ix_(ys, xs)].astype(np.int64)
    bright_rows = np.array([bool(is_bright[y % 4]) for y in ys])

    whites = []
    for bin_idx in range(2):
        samples = grid[bright_rows == bool(bin_idx)].ravel()
        if len(samples) > max_pix:
            samples = np.concatenate([samples[: max_pix - 1], samples[-1:]])
        n = len(samples)
        if n == 0:
            whites.append(0)
            continue
        k = min(discard[bin_idx], n - 1)
        kth_max = int(np.partition(-samples, k)[k]) * -1
        whites.append(kth_max - margins[bin_idx])
    white_dark = int(np.clip(whites[0], 10000, 16383))
    white_bright = int(np.clip(whites[1], 5000, 16383))
    return white_dark, white_bright


def _wirth_k(n: int) -> int:
    return n // 2 if (n & 1) else n // 2 - 1


def match_exposures(img: np.ndarray, is_bright, black20: int, white20: int, active_y1: int = 0) -> ExposureFit:
    """Exposure matching (match_exposures, hdr.c:638-823).

    ``img`` is the 14-bit fixed frame (uint16); 20-bit promotion is implicit
    (p20>>4 == p14<<2). Returns the gain/offset applied on device.
    """
    h, w = img.shape
    black = black20 // 16
    white = white20 // 16
    clip0 = white - black
    clip = int(clip0 * 0.95)
    y0 = active_y1 + 2

    ys = np.arange(y0, h - 2, 3)
    xs = np.arange(0, w, 3)
    p16 = (img.astype(np.int64) << 2)
    pn = p16[np.ix_(ys, xs)] - black
    pa = p16[np.ix_(ys - 2, xs)] - black
    pb = p16[np.ix_(ys + 2, xs)] - black
    pi = _tdiv(pa + pb + 1, 2)
    pi = np.where((pa >= clip) | (pb >= clip), clip0, pi)
    pn = np.where(pi >= clip, clip0, pn)

    row_bright = np.array([bool(is_bright[y % 4]) for y in ys])
    bright = np.where(row_bright[:, None], pn, pi).ravel()
    dark = np.where(row_bright[:, None], pi, pn).ravel()

    unclipped = bright < clip
    b_vals = bright[unclipped]
    n = len(b_vals)
    if n < 2:
        return ExposureFit(ok=False, reason="no unclipped samples")
    bmed = int(np.partition(b_vals, _wirth_k(n))[_wirth_k(n)])
    k98 = min(n * 98 // 100, n - 1)
    b_lo = int(np.partition(b_vals, k98)[k98])
    k999 = min(int(n * 99.9 / 100), n - 1)
    b_hi = int(np.partition(b_vals, k999)[k999])
    d_vals = dark[unclipped]
    dmed = int(np.partition(d_vals, _wirth_k(n))[_wirth_k(n)])

    # highlights in (b_lo, b_hi), first hi_nmax in scan order (hdr.c:727-745)
    hi_nmax = ((w + 2) * (h + 2) // 9) // 50
    sel = (bright > b_lo) & (bright < b_hi)
    order = np.cumsum(sel)
    sel &= order <= hi_nmax
    hb = bright[sel].astype(np.float64)
    hd = dark[sel].astype(np.float64)

    # RANSAC-style slope search: 0..6 EV in 0.002 steps (hdr.c:749-773)
    evs = np.arange(3000) * 0.002
    a_cand = np.power(2.0, -evs)
    b_cand = dmed - bmed * a_cand
    if len(hb):
        e = hd[None, :] - (hb[None, :] * a_cand[:, None] + b_cand[:, None])
        scores = (np.abs(e.astype(np.int64)) < 50).sum(axis=1)
        best = int(np.argmax(scores))
        best_score = int(scores[best])
    else:
        best_score = 0
    if best_score == 0:
        return ExposureFit(ok=False, reason="not interlaced ISO")
    a = float(a_cand[best])
    b = float(b_cand[best])

    factor = 1 / a
    if factor < 1.2 or not np.isfinite(factor):
        return ExposureFit(ok=False, reason="not interlaced ISO")

    b20 = b * 16
    white_darkened = int((white20 - black20 + b20) * a + black20)
    return ExposureFit(
        ok=True, a=a, b=b, corr_ev=float(np.log2(factor)), white_darkened=white_darkened
    )
