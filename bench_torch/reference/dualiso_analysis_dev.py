"""Reference copy of ``mlvfs_tpu_torch/ops/dualiso_analysis_dev.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Dual-ISO analysis on the batch's device (the default, non-exact mode).

Counterpart of ``mlvfs_tpu/ops/dualiso_analysis_dev.py``: the stages of
``dualiso_analysis.py`` (hdr.c:441-823) as batched tensor reductions, so the
frames stay on the device and only per-frame scalars are read back. The
integer order statistics are exact: where the reference bisects over value
ranges by counts, this module sorts and indexes (the same values; the
reference's bisection bounds become clamps). The exposure fit scores its
3000 candidate gains in float32, with the fused multiply-adds and the exp
that XLA on the CPU gives the reference (:mod:`.evmath`).

Frames are (B, H, W) int16 tensors holding u16 bits; per-frame scalars are
(B,) tensors on the frames' device.
"""

from __future__ import annotations

import functools
import math

import torch

from . import evmath
from .evmath import fma
from .pixels import wrap32

RANSAC_STEPS = 3000  # candidate gains 2**-(0.002 i), i < 3000 (hdr.c:749-773)


def u16(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int16 u16 bits → int32 values 0..65535."""
    return imgs.to(torch.int32) & 0xFFFF


def rggb_stat(img: torch.Tensor, active_y1: int = 0) -> torch.Tensor:
    """diffs_rggb < diffs_gbrg of one (H, W) frame (identify_rggb_or_gbrg,
    hdr.c:441-495), a bool tensor: the L1 distance between the count-CDFs of
    two equal-size samples is the sum of |order statistic differences|.
    The sums wrap like the reference's int32 sums."""
    h, w = img.shape
    y0 = (active_y1 + 3) & ~3
    region = u16(img[y0 : h // 4 * 4]) & 16383
    ch = [torch.sort(region[py::2, px::2].reshape(-1))[0].to(torch.int64)
          for py in range(2) for px in range(2)]
    diffs_rggb = wrap32((ch[1] - ch[2]).abs().sum())
    diffs_gbrg = wrap32((ch[0] - ch[3]).abs().sum())
    return diffs_rggb < diffs_gbrg


def fields_stat_batch(imgs: torch.Tensor, black: int, active_y1: int = 0):
    """(ok (B,) bool, is_bright (B, 4) bool) per frame
    (identify_bright_and_dark_fields, hdr.c:497-636) from order statistics of
    the green samples of each row phase: raw_at(ref) = sorted[ref-1] + 1 and
    cum[v] = #samples <= v."""
    white = 10000
    b, h, w = imgs.shape
    dev = imgs.device
    y0 = (active_y1 + 3) & ~3
    h4 = h // 4 * 4
    hr = h4 - y0
    n = (hr // 4) * (w // 2)  # per-phase sample count (phase 0's)
    if n <= 0:
        return torch.zeros(b, dtype=torch.bool, device=dev), torch.zeros((b, 4), dtype=torch.bool,
                                                                         device=dev)
    region = u16(imgs[:, y0:h4]) & 16383
    # phase q: rows y0+q::4 (y0 % 4 == 0), green columns of parity (q+1) % 2
    phases = [torch.sort(region[:, q::4, (q + 1) % 2 :: 2].reshape(b, -1), dim=1)[0]
              for q in range(4)]

    def cum(v: int) -> torch.Tensor:
        """(B, 4) counts of samples <= v."""
        v = min(max(v, 0), 16383)
        return torch.stack([(p <= v).sum(1) for p in phases], 1)

    ref_max = int(n * 0.998)
    ref_off = int(n * 0.05)
    thr = black + (white - black) // 4
    first_break = cum(white - 2).amin(1) + 1
    ref_final = torch.clamp(first_break, max=ref_max - 1)
    cond_bound = cum(max(thr - 2, 0)).amin(1)
    ref_b = torch.minimum(torch.clamp(cond_bound, max=ref_off - 1), ref_final)

    def stat(ref: torch.Tensor) -> torch.Tensor:
        """(B, 4) raw_at(ref): the (ref-1)-th order statistic + 1, 0 at ref <= 0."""
        k = (ref - 1).clamp(0, n - 1)[:, None]
        lo = torch.stack([p.gather(1, k)[:, 0] for p in phases], 1)
        return torch.where(ref[:, None] <= 0, 0, lo + 1)

    off = torch.where(ref_b[:, None] >= 0, stat(ref_b), 0)
    raw = stat(ref_final) - off
    srt = torch.sort(raw, dim=1)[0]
    median_bright = (srt[:, 1] + srt[:, 2]).to(torch.float32) / 2
    is_bright = raw.to(torch.float32) > median_bright[:, None]
    ok = ((is_bright.sum(1) == 2) & (is_bright[:, 0] != is_bright[:, 2])
          & (is_bright[:, 1] != is_bright[:, 3]) & (ref_final >= 0))
    return ok, is_bright


def white_detect_batch(imgs: torch.Tensor, is_bright: torch.Tensor, active_area, max_pix: int):
    """(white_dark, white_bright) int32 (B,) per frame (white_detect,
    hdr.c:250-300). Keeps the reference's sample-buffer rule: of each bin's
    samples, the first max_pix-1 and the last one (hdr.c:278-281)."""
    y1, x1, y2, x2 = active_area
    discard = (10, 50)
    margins = (100, 1500)
    b = imgs.shape[0]
    grid = u16(imgs[:, y1:y2:3, x1:x2:3])  # (B, gy, gx)
    ys = torch.arange(y1, y2, 3, device=imgs.device)
    bright_rows = is_bright[:, ys % 4]  # (B, gy)
    whites = []
    for bin_idx in range(2):
        m = (bright_rows == bool(bin_idx))[:, :, None].expand_as(grid).reshape(b, -1)
        order = torch.cumsum(m.to(torch.int32), dim=1)
        count = order[:, -1:]
        keep = m & ((order <= max_pix - 1) | (order == count))
        vals = torch.where(keep, grid.reshape(b, -1), -1)
        k = torch.clamp(torch.clamp(count[:, 0], max=max_pix) - 1, min=0).clamp(max=discard[bin_idx])
        top = torch.topk(vals, min(discard[bin_idx] + 1, vals.shape[1]), dim=1)[0]
        # the k-th largest; the reference's bisection starts at 16383
        kth = top.gather(1, k[:, None].long())[:, 0].clamp(max=16383)
        whites.append(kth - margins[bin_idx])
    return whites[0].clamp(10000, 16383).to(torch.int32), whites[1].clamp(5000, 16383).to(torch.int32)


def tdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    """C-style truncating integer division."""
    return torch.div(a, b, rounding_mode="trunc")


def _wirth_k(nn: torch.Tensor) -> torch.Tensor:
    return torch.where((nn & 1) == 1, nn // 2, nn // 2 - 1)


@functools.lru_cache(maxsize=4)
def candidate_gains(device) -> torch.Tensor:
    """The 3000 candidate gains exp2(-i * f32(0.002)) in float32, as the
    reference computes them on the CPU (``evmath.exp2_f32``): a gain one ulp
    off moves the fit's truncated residuals, and with them the argmax."""
    return evmath.exp2_f32(-(torch.arange(RANSAC_STEPS, dtype=torch.float32, device=device) * 0.002))


def match_exposures_batch(imgs, is_bright, black20s, white20s, shape, active_y1: int = 0):
    """Exposure fit per frame (match_exposures, hdr.c:638-823), float32
    scoring. ``black20s``/``white20s`` are per-frame (B,) int32 (the white
    from white_detect). Returns (ok, a, b, white_darkened), each (B,).

    The selected highlight pairs (b_lo < bright < b_hi) are a contiguous
    window of the bright-sorted samples, capped at hi_nmax pairs; the sort
    is stable, so when more than hi_nmax pairs qualify the pairs kept at
    the window's end among equal brights follow the raster order (the
    reference's unstable sort leaves that order to XLA)."""
    h, w = shape
    bsz = imgs.shape[0]
    dev = imgs.device
    y0 = active_y1 + 2
    ys = torch.arange(y0, h - 2, 3, device=dev)
    hi_nmax = ((w + 2) * (h + 2) // 9) // 50

    black = (black20s // 16).to(torch.int32)[:, None, None]
    white = (white20s // 16).to(torch.int32)[:, None, None]
    clip0 = white - black
    clip = (clip0.to(torch.float32) * 0.95).to(torch.int32)

    p16 = u16(imgs) << 2
    pn = p16[:, y0 : h - 2 : 3, 0:w:3] - black
    pa = p16[:, y0 - 2 : h - 4 : 3, 0:w:3] - black
    pb = p16[:, y0 + 2 : h : 3, 0:w:3] - black
    pi = tdiv(pa + pb + 1, 2)
    pi = torch.where((pa >= clip) | (pb >= clip), clip0, pi)
    pn = torch.where(pi >= clip, clip0, pn)

    rb = is_bright[:, ys % 4][:, :, None]
    bright = torch.where(rb, pn, pi).reshape(bsz, -1)
    dark = torch.where(rb, pi, pn).reshape(bsz, -1)
    unclipped = bright < clip.reshape(bsz, 1)
    n = unclipped.sum(1, dtype=torch.int32)
    big = 1 << 30
    bs, order = torch.sort(torch.where(unclipped, bright, big), dim=1, stable=True)
    dcarry = dark.gather(1, order)
    last = bs.shape[1] - 1

    def at(k):
        return bs.gather(1, k.clamp(0, last).long()[:, None])[:, 0]

    bmed = at(_wirth_k(n))
    b_lo = at(n * 98 // 100)
    b_hi = at((n.to(torch.float32) * 0.999).to(torch.int32))
    dm = torch.sort(torch.where(unclipped, dark, big), dim=1)[0]
    # the median of the unclipped darks; the reference bisects in [-2**18, 2**18]
    dmed = dm.gather(1, _wirth_k(n).clamp(0, last).long()[:, None])[:, 0].clamp(-(1 << 18), 1 << 18)

    start = (bs <= b_lo[:, None]).sum(1)
    idx = (start[:, None] + torch.arange(hi_nmax, device=dev)[None, :]).clamp(max=last + 1)
    bs_pad = torch.cat([bs, torch.full((bsz, 1), big, dtype=bs.dtype, device=dev)], 1)
    dc_pad = torch.cat([dcarry, torch.zeros((bsz, 1), dtype=dcarry.dtype, device=dev)], 1)
    hb_w = bs_pad.gather(1, idx)
    hd_w = dc_pad.gather(1, idx)
    valid = hb_w < b_hi[:, None]  # the window starts past b_lo; pads fail this
    hb = torch.where(valid, hb_w, 0).to(torch.float32)
    hd = torch.where(valid, hd_w, 0).to(torch.float32)

    a_cand = candidate_gains(dev)
    # dmed - bmed * a and hb * a + b, each multiply fused into its add
    b_cand = fma(-bmed.to(torch.float32)[:, None], a_cand[None, :], dmed.to(torch.float32)[:, None])
    scores = torch.empty((bsz, RANSAC_STEPS), dtype=torch.int64, device=dev)
    for i in range(bsz):  # one frame at a time: (3000, hi_nmax) float64 temporaries
        e = hd[i][None, :] - fma(hb[i][None, :], a_cand[:, None], b_cand[i][:, None])
        scores[i] = ((torch.trunc(e).abs() < 50) & valid[i][None, :]).sum(1)
    best = torch.argmax(scores, dim=1)  # the first of equal scores
    a = a_cand[best]
    bb = b_cand.gather(1, best[:, None])[:, 0]
    ok = (scores.gather(1, best[:, None])[:, 0] > 0) & (1 / a >= 1.2)
    b20 = bb * 16
    wd = fma((white20s - black20s).to(torch.float32) + b20, a, black20s.to(torch.float32))
    return ok, a, bb, wd.to(torch.int32)


DARK_NOISE_EV = math.log2(8.0) + 6


def decide_batch(is_hdr, okf, ibf, wd_w, mok, a_dev, b_dev, wd_dev, hh: int, black: int):
    """Per-frame conversion decision and the reconstruction's per-frame
    scalars (the reference's host loop, hdr.c:1853-1886). Returns (ok,
    row_bright (B, hh), s (B, hh), a, b20, white_darkened, corr_ev,
    overlap, white20)."""
    dev = a_dev.device
    ys = torch.arange(hh, device=dev)
    log_gain = evmath.log_f32(1.0 / a_dev)
    corr_ev = log_gain * evmath.INV_LN2  # log2(1 / a)
    white20s = wd_w.to(torch.int32) * 64
    lowiso_dr = evmath.log2_add(torch.clamp(white20s - black * 64, min=1).to(torch.float32),
                                -DARK_NOISE_EV)
    ov = evmath.fma(-log_gain, evmath.INV_LN2, lowiso_dr)  # lowiso_dr - corr_ev, contracted
    ov = ov - torch.clamp(ov - 3.0, max=3.0)
    ok = is_hdr & okf & mok & (ov >= 0.5)
    ibb = ibf.to(torch.bool)
    row_bright = ibb[:, ys % 4] & ok[:, None]
    s = torch.where((ibb[:, ys % 4] == ibb[:, (ys + 1) % 4]) & ok[:, None], -1, 1).to(torch.int32)
    a = torch.where(ok, a_dev, 1.0).to(torch.float32)
    b20 = torch.where(ok, b_dev * 16, 0.0).to(torch.float32)
    wd = torch.where(ok, wd_dev, 1 << 20).to(torch.int32)
    ce = torch.where(ok, corr_ev, 0.0).to(torch.float32)
    ovr = torch.where(ok, ov, 1.0).to(torch.float32)
    return ok, row_bright, s, a, b20, wd, ce, ovr, white20s


def analyze_batch(imgs, is_hdr, y_off: int, hh: int, black: int):
    """Field, white and exposure analysis plus the conversion decisions of a
    batch (B, H, W) on its device; nothing is read back here."""
    b, _, w = imgs.shape
    ay1 = y_off  # GBRG shifts one row: active_y1 == y_off by construction
    sub = imgs[:, y_off : y_off + hh, :]
    okf, ibf = fields_stat_batch(sub, black, ay1)
    max_pix = w * hh // 2 // 9
    wd_w, wb_w = white_detect_batch(sub, ibf, (ay1, 0, hh, w), max_pix)
    black20s = torch.full((b,), black * 64, dtype=torch.int32, device=imgs.device)
    min20s = torch.minimum(wd_w, wb_w) * 64
    mok, a_dev, b_dev, wd_dev = match_exposures_batch(sub, ibf, black20s, min20s, (hh, w), ay1)
    return decide_batch(is_hdr, okf, ibf, wd_w, mok, a_dev, b_dev, wd_dev, hh, black)
