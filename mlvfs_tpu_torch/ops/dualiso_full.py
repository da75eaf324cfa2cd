"""Dual-ISO full-quality reconstruction (--dual-iso): the cr2hdr 20-bit path
in PyTorch.

Counterpart of ``mlvfs_tpu/ops/dualiso_full.py`` (cr2hdr20_convert_data →
hdr_interpolate, hdr.c:1774-1957) with both interpolations:

  hdr_check → focus/bad pixel fix → RGGB/GBRG → bright/dark fields →
  white detect → promote to 20 bit → exposure matching → interpolation
  of the missing exposure (amaze-edge, ``ops/amaze.py`` with kernels #6,
  #8 and #10; or mean23 per row) → borders → full-res
  reconstruction → half-res EV-space blend (+ 20-bit chroma smoothing +
  alias map, kernel #7) → overexposure blur → final blend → 16-bit out.

The per-frame analysis runs on the batch's device (``dualiso_analysis_dev``)
and is read back once per batch (the conversion mask, and on a clip's first
batch the white level); with ``exact_luts`` it runs on the host in float64
(``dualiso_analysis``). The reconstruction is plain torch over the batch,
per-frame scalars as (B,) tensors, except the alias filter chain, which is
``ops/alias.py`` (the CUDA kernel on a CUDA tensor), and amaze-edge's
demosaic and edge pick (``ops/amaze_core.py``, ``ops/amaze_scans.py``,
``ops/amaze_edge.py``, CUDA kernels on a CUDA tensor).

Float32 stages follow the reference's operation order with the fused
multiply-adds XLA on the CPU forms (``evmath.fma``); the EV transforms are
the 20-bit tables with ``exact_luts``, else computed (``evmath``). As in the
reference, this path is held to the reference by PSNR, not bit equality:
cos is correctly rounded here and not in XLA. hdr_check's mean is an exact
sum (``hdr_check_sums``), so the card and the CPU decide alike; the
reference's float32 sum can round otherwise only for a mean within its
rounding of 0.5.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import alias as alias_ops
from . import evmath
from .alias import shift
from .amaze import amaze_edge_interpolate
from .dualiso_analysis_dev import tdiv, u16
from .evmath import fma
from .luts import EV_RESOLUTION, ev2raw_lut20, fullres_curve, raw2ev_lut20
from .unpack import to_int16_bits
from ..utils import metrics

FULLRES_THR = 0.8
ALIAS_MAP_MAX = alias_ops.ALIAS_MAP_MAX
DARK_NOISE20 = 8.0 * 64  # compute_noise's default stdev 8 (14-bit) for MLV frames


def _grid(h: int, w: int, device):
    return (torch.arange(h, device=device)[:, None], torch.arange(w, device=device)[None, :])


# ------------------------------------------------------------------ checks


@metrics.traced("dualiso.hdr_check", metrics.DEVICE)
def hdr_check_batch(imgs: torch.Tensor, black: int, white: int) -> torch.Tensor:
    """Quick interlaced-exposure detector (hdr_check, hdr.c:407-439) of a batch
    (B, H, W) int16 (u16 bits): (B,) bool on the batch's device. The mean
    |EV difference| to the row two below, over valid pixels, exceeds 0.5."""
    diff, num = hdr_check_terms(imgs, black, white)
    mean = torch.where(num > 0, hdr_check_sums(diff) / num.clamp(min=1), 0.0)
    return mean > 0.5


def hdr_check_terms(imgs: torch.Tensor, black: int, white: int):
    """hdr_check's float32 |EV differences| (B, H, W), 0 at pixels that are
    not valid, and the (B,) counts of valid pixels."""
    b, h, w = imgs.shape
    p = u16(imgs)
    p2 = shift(p, 2, 0)
    ys, xs = _grid(h, w, imgs.device)
    inner = (ys >= 2) & (ys < h - 2) & (xs >= 2) & (xs < w - 2)
    valid = inner & ((p > black + 32) | (p2 > black + 32)) & (p < white) & (p2 < white)

    sig = p - black
    mag = evmath.log2_f32(torch.clamp(sig, min=1).to(torch.float32)) * EV_RESOLUTION
    evf = torch.where(sig > 0, mag, torch.where(sig == 0, -torch.inf, 0.0))
    # evf(p2) is evf shifted up two rows (its 0-filled rows are evf(0) = 0)
    diff = torch.where(valid, (shift(evf, 2, 0) - evf).abs(), 0.0)
    return diff, valid.sum((1, 2))


def hdr_check_sums(diff: torch.Tensor) -> torch.Tensor:
    """(B,) sums of hdr_check's (B, H, W) float32 differences in float64,
    exact in any order, so the same on every device: math.fsum of each
    frame's differences. A nonzero evf is log2(x) * 2^15 with log2(x) >= 0.5
    (x >= 2), a multiple of 2^-9 below 2^19, so every difference is too (or
    inf, where a valid pixel sits at black), and a sum of fewer than 2^25 of
    them stays below 2^53 * 2^-9."""
    if diff.shape[-2] * diff.shape[-1] >= 1 << 25:
        raise ValueError(f"hdr_check: a {diff.shape[-2]}x{diff.shape[-1]} frame is past exact sums")
    return diff.to(torch.float64).sum((1, 2))


# ------------------------------------------------------- the reconstruction


def _row_shift(arr, s, mag):
    """arr[y + s*mag, x] with per-frame, per-row sign s (B, H) of +1/-1."""
    return torch.where((s == 1)[:, :, None], shift(arr, mag, 0), shift(arr, -mag, 0))


def _mean23_interpolate(p, ev, ev2raw_at, row_bright, s, evw_row):
    """mean23 (mean32_interpolate, hdr.c:1231-1304) and the border
    interpolation (hdr.c:1306-1353) of (B, H, W) int32 → (dark, bright)."""
    _, h, w = p.shape
    e_up2 = shift(ev, -2, 0)
    e_dn2 = shift(ev, 2, 0)
    e_s_xp = _row_shift(shift(ev, 0, 1), s, 1)
    e_s_xm = _row_shift(shift(ev, 0, -1), s, 1)
    e_m2s = torch.where((s == 1)[:, :, None], e_up2, e_dn2)  # y - 2s
    evw = evw_row[:, :, None]

    def mean2(a, b):
        m = tdiv(a + b, 2)
        return torch.where((a >= evw) | (b >= evw), evw, m)

    def mean3(a, b, c):
        m = tdiv(a + b + c, 3)
        return torch.where((a >= evw) | (b >= evw) | (c >= evw), torch.maximum(m, evw), m)

    ys, xs = _grid(h, w, p.device)
    is_green = (xs % 2) != (ys % 2)
    interp_ev = torch.where(is_green, mean3(e_s_xp, e_s_xm, e_m2s), mean2(e_up2, e_dn2))
    interp_main = ev2raw_at(interp_ev)

    # main region: y in [2, h-3], x in [2, w-3] (hdr.c:1254,1261)
    region = (ys >= 2) & (ys <= h - 3) & (xs >= 2) & (xs <= w - 3)
    interp = torch.where(region, interp_main, 0)
    native = torch.where(region, p, 0)
    rb = row_bright[:, :, None]
    return _apply_borders(p, torch.where(rb, interp, native), torch.where(rb, native, interp),
                          row_bright)


def _apply_borders(p, dark, bright, row_bright):
    """The border interpolation (hdr.c:1306-1353) over (B, H, W) dark/bright
    frames, in the reference's order: the top 3 and bottom 4 rows, then the
    left 2 and right 3 columns from row 2 down."""
    _, h, w = p.shape
    ys, xs = _grid(h, w, p.device)
    rb = row_bright[:, :, None]

    def put(dark, bright, mask, interp_val, native_val):
        d = torch.where(mask, torch.where(rb, interp_val, native_val), dark)
        b = torch.where(mask, torch.where(rb, native_val, interp_val), bright)
        return d, b

    dark, bright = put(dark, bright, ys < 3, shift(p, 2, 0), p)
    dark, bright = put(dark, bright, ys >= h - 4, shift(p, -2, 0), p)
    dark, bright = put(dark, bright, (ys >= 2) & (xs < 2), shift(p, -2, 0), p)
    return put(dark, bright, (ys >= 2) & (xs >= w - 3), shift(p, -2, -2), shift(p, 0, -2))


def _build_alias_map(fullres_smooth, halfres_smooth, fe, he, fr_bright):
    """Aliasing-likelihood map (build_alias_map, hdr.c:1382-1486) from the
    smoothed full-res and half-res frames, their EV planes ``fe``/``he`` and
    the fullres curve of the bright frame; the filter chain is kernel #7."""
    skip = fr_bright > FULLRES_THR
    e_lin = torch.clamp((fullres_smooth - halfres_smooth).abs() - int(DARK_NOISE20) * 3 // 2, min=0)
    e_log = (fe - he).abs()
    alias = torch.minimum(e_lin // 2, e_log // 16).clamp(max=65530)
    alias = torch.where(skip, 0, alias).to(torch.int32)
    return alias_ops.alias_filter(alias.contiguous(), skip.contiguous())


def _blur_overexposed(over):
    """3x3-ish integer blur of the overexposure map (hdr.c:1639-1655)."""
    _, h, w = over.shape
    n4 = sum(shift(over, dy, dx) for dx, dy in [(0, -1), (-1, 0), (1, 0), (0, 1)])
    nd = sum(shift(over, dy, dx) for dx, dy in [(-1, -1), (1, -1), (-1, 1), (1, 1)])
    blurred = over + n4 * 820 // 1024 + nd * 657 // 1024
    ys, xs = _grid(h, w, over.device)
    inner = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(inner, blurred, over)


@functools.lru_cache(maxsize=8)
def _luts(black20: int, white20: int, device: torch.device):
    """The 20-bit raw→EV and EV→raw tables (int64) on ``device``, uploaded
    once per (levels, device)."""
    return (torch.from_numpy(raw2ev_lut20(black20, white20).astype(np.int64)).to(device),
            torch.from_numpy(ev2raw_lut20(black20, white20).astype(np.int64)).to(device))


@functools.lru_cache(maxsize=4)
def _frcurve(black20: int, device: torch.device):
    return torch.from_numpy(np.asarray(fullres_curve(black20), np.float32)).to(device)


def white_ev_of(black20: int, white20: int) -> int:
    """raw2ev(white20) on the host, the computed inverse's white clamp."""
    return int(round(math.log2(1 + max(white20 / 64.0 - black20 / 64.0, 0)) * EV_RESOLUTION))


@functools.lru_cache(maxsize=4)
def _max_ev(black20: int, white20: int) -> torch.Tensor:
    """log2 of the white's distance from black (mix_images), a 0-dim host
    tensor, computed once per levels."""
    return evmath.log2_f32(torch.tensor(float(white20 // 64 - black20 // 64)))


@metrics.traced("recon", metrics.DEVICE)
def reconstruct_batch(imgs, row_bright, s, a, b20, white_darkened, corr_ev, overlap, *,
                      black20: int, white20: int, interp_method: int, use_fullres: bool,
                      use_alias: bool, cs_method: int, exact_luts: bool) -> torch.Tensor:
    """Reconstruct a batch (B, H, W) int16 (u16 bits) of interlaced frames →
    (B, H, W) int16 16-bit output. ``row_bright``/``s`` are (B, H) bool/int32,
    the rest (B,) per-frame scalars, all on the batch's device."""
    if interp_method not in (0, 1):
        raise ValueError(f"interp_method is 0 (amaze-edge) or 1 (mean23), got {interp_method}")
    dev = imgs.device
    white_ev = white_ev_of(black20, white20)
    if exact_luts or cs_method:
        lut, inv = _luts(black20, white20, dev)
    if exact_luts:
        frcurve = _frcurve(black20, dev)

        def ev_of(x):
            return lut[x.clamp(0, lut.shape[0] - 1)].to(torch.int32)

        def ev2raw_at(e):
            return inv[(e.to(torch.int64) + 10 * EV_RESOLUTION).clamp(0, 24 * EV_RESOLUTION - 1)].to(
                torch.int32)

        def frcurve_of(x):
            return frcurve[(x & 0xFFFFF).long()]
    else:
        def ev_of(x):
            return evmath.raw2ev20(x, black20)

        def ev2raw_at(e):
            return evmath.ev2raw20(e, black20, white20, white_ev)

        def frcurve_of(x):
            return evmath.fullres_weight(x, black20)

    def per_frame(v):
        return v[:, None, None]

    with metrics.span("recon.match", metrics.DEVICE):
        # promote to 20 bits (hdr.c:825-837)
        raw = (u16(imgs) << 6) & 0xFFFFF

        # exposure matching apply (hdr.c:783-809)
        pf = raw.to(torch.float32)
        rb = row_bright[:, :, None]
        av, bv = per_frame(a.to(torch.float32)), per_frame(b20.to(torch.float32))
        darkened = fma(bv, av, fma(pf - black20, av, float(black20)))
        lifted = fma(bv, av, pf - bv)
        adj = torch.clamp(torch.trunc(torch.where(rb, darkened, lifted)), 0, 0xFFFFF).to(torch.int32)
        raw = torch.where(raw == 0, 0, adj)

    with metrics.span("recon.interp", metrics.DEVICE):
        wd = white_darkened.to(torch.int32)
        if interp_method == 0:
            dark, bright = amaze_edge_interpolate(raw, ev2raw_at, row_bright, s, ev_of, frcurve_of, wd,
                                                  black20=black20)
            dark, bright = _apply_borders(raw, dark, bright, row_bright)
        else:
            white_row = torch.where(row_bright, white20, wd[:, None]).to(torch.int32)
            dark, bright = _mean23_interpolate(raw, ev_of(raw), ev2raw_at, row_bright, s, ev_of(white_row))

    with metrics.span("recon.blend", metrics.DEVICE):
        # full-res reconstruction (hdr.c:1355-1380)
        wd3 = per_frame(wd)
        if use_fullres:
            fullres = torch.where(rb, torch.where(bright < wd3, bright, torch.maximum(bright, dark)), dark)
        else:
            fullres = torch.zeros_like(raw)

        # half-res blend (mix_images, hdr.c:1560-1611)
        max_ev = _max_ev(black20, white20)
        ov = per_frame(overlap.to(torch.float32))
        bright_ev = ev_of(bright)
        dark_ev = ev_of(dark)
        i_f = (bright & 0xFFFFF).to(torch.float32)
        evb = evmath.log2_add(torch.clamp(i_f / 64.0 - black20 / 64.0, min=1.0),
                              per_frame(corr_ev.to(torch.float32)))
        t = torch.minimum(torch.clamp(evb - (max_ev - ov), min=0.0), ov)
        cmix = -evmath.cos_f32(t * float(np.float32(math.pi)) / ov)
        k = torch.clamp((cmix + 1) / 2, 0, 1)
        mixed = torch.trunc(fma(bright_ev.to(torch.float32), 1 - k, dark_ev.to(torch.float32) * k)).to(torch.int32)
        halfres = ev2raw_at(mixed)

    with metrics.span("recon.chroma20", metrics.DEVICE):
        if cs_method:
            # the 20-bit chroma smooth (hdr.c:1488-1500) always uses the tables
            from .chroma_smooth import chroma_smooth_20

            fullres_smooth = chroma_smooth_20(fullres, cs_method, lut, inv) if use_fullres else fullres
            halfres_smooth = chroma_smooth_20(halfres, cs_method, lut, inv)
        else:
            fullres_smooth, halfres_smooth = fullres, halfres

    with metrics.span("recon.alias", metrics.DEVICE):
        # each EV plane once (without smoothing the full-res planes are one)
        f = frcurve_of(bright)
        hs_ev = ev_of(halfres_smooth)
        fs_ev = ev_of(fullres_smooth)
        f_ev = fs_ev if fullres_smooth is fullres else ev_of(fullres)
        alias = _build_alias_map(fullres_smooth, halfres_smooth, fs_ev, hs_ev, f) if use_alias else None

    with metrics.span("recon.final", metrics.DEVICE):
        over = torch.where((bright >= wd3) | (dark >= white20), 100, 0).to(torch.int32)
        over = _blur_overexposed(over)

        # final blend (hdr.c:1663-1758)
        hrev = hs_ev.to(torch.float32)
        frev = f_ev.to(torch.float32)
        frsev = fs_ev.to(torch.float32)
        ovf = torch.clamp(over.to(torch.float32) / 200.0, 0, 1)
        c = torch.maximum(torch.clamp(alias.to(torch.float32) / ALIAS_MAP_MAX, 0, 1), ovf) if use_alias else ovf
        noisy = torch.maximum(ovf, 1 - f)
        f = torch.maximum(f, c)
        fev = fma(noisy, frsev, (1 - noisy) * frev)
        sig = (dark + bright) // 2
        f = torch.clamp(torch.minimum(f, (sig - black20).to(torch.float32) / (4 * DARK_NOISE20)), min=0.0)
        output = torch.trunc(fma(hrev, 1 - f, fev * f)).to(torch.int32)
        output = torch.clamp(output, -10 * EV_RESOLUTION, 14 * EV_RESOLUTION - 1)
        final20 = ev2raw_at(output)

        # 20 → 16 bit; the reference's dither source is never seeded, so its
        # noise is all zero: out = trunc(v/16 + 0.5) (hdr.c:242,1760-1772)
        return to_int16_bits(torch.clamp((final20 + 8) >> 4, 0, 65535))


# ------------------------------------------------------------ orchestrator


def _analyze_exact(imgs, is_hdr, rggb_cached, black, cal):
    """The exact_luts mode's analysis on the host, in float64 (the
    reference's host loop, ``mlvfs_tpu/ops/dualiso_full.py:587-638``).
    Returns (ok, y_off, hh, scalars as numpy, white20 or None)."""
    from . import dualiso_analysis as analysis

    b, h, w = imgs.shape
    host = imgs.cpu().numpy().view(np.uint16)
    rggb = rggb_cached if rggb_cached is not None else analysis.identify_rggb_or_gbrg(host[0])
    if cal is not None:
        cal.dual_iso_rggb = rggb
    y_off = 0 if rggb else 1
    hh = h if rggb else h - 1
    ay1 = y_off
    ys = np.arange(hh)
    ok = np.zeros(b, bool)
    row_bright = np.zeros((b, hh), bool)
    s_arr = np.ones((b, hh), np.int32)
    a_arr = np.ones(b, np.float32)
    b20_arr = np.zeros(b, np.float32)
    wd_arr = np.full(b, 1 << 20, np.int32)
    ce_arr = np.zeros(b, np.float32)
    ov_arr = np.ones(b, np.float32)
    whites20 = np.zeros(b, np.int64)
    dark_noise_ev = np.log2(8.0) + 6
    for i in range(b):
        if not is_hdr[i]:
            continue
        frame = host[i][y_off : y_off + hh]
        fok, is_bright = analysis.identify_bright_and_dark_fields(frame, black, active_y1=ay1)
        if not fok:
            continue
        wdark, wbright = analysis.white_detect(frame, is_bright, (ay1, 0, hh, w))
        fit = analysis.match_exposures(frame, is_bright, black * 64, min(wdark, wbright) * 64,
                                       active_y1=ay1)
        if not fit.ok:
            continue
        white20_i = wdark * 64
        lowiso_dr = np.log2(white20_i - black * 64) - dark_noise_ev
        overlap = lowiso_dr - fit.corr_ev
        overlap -= min(3.0, overlap - 3.0)
        if overlap < 0.5:
            continue
        ok[i] = True
        ib = np.array(is_bright, bool)
        row_bright[i] = ib[ys % 4]
        s_arr[i] = np.where(ib[ys % 4] == ib[(ys + 1) % 4], -1, 1)
        a_arr[i] = fit.a
        b20_arr[i] = fit.b * 16
        wd_arr[i] = fit.white_darkened
        ce_arr[i] = fit.corr_ev
        ov_arr[i] = overlap
        whites20[i] = white20_i
    white20 = int(whites20[ok][0]) if ok.any() else None
    return ok, y_off, hh, (row_bright, s_arr, a_arr, b20_arr, wd_arr, ce_arr, ov_arr), white20


def cr2hdr20_batch(imgs: torch.Tensor, fh, cfg, cal):
    """The full path for a batch (B, H, W) int16 (u16 bits) on its device.
    Returns (imgs, ok) with ok a (B,) numpy bool array: the frames converted.
    Frames not converted keep their pixels (a frame that passed hdr_check
    keeps the dual-ISO-mode pixel fixes, as in the reference)."""
    from . import pixels as pixel_ops

    ri = fh.raw_info
    black, white14 = ri.black_level, ri.white_level
    b, h, w = imgs.shape
    dev = imgs.device

    is_hdr = hdr_check_batch(imgs, black, white14)

    # focus and bad pixels, horizontal mode, gated per frame on hdr_check
    # (the fixes sit inside `if (hdr_check(...))`, hdr.c:1942-1948)
    crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
    crop_y = int(fh.vidf["panPosY"]) & ~1
    fixed = imgs
    if cal is not None and cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        fixed = pixel_ops.fix_pixel_list_batch(fixed, cal.focus_pixel_list, black, crop_x, crop_y,
                                               dual_iso=True)
    if cfg.fix_bad_pixels:
        # ONE map per clip (cs.c:233-312), from the first frame that reaches
        # fix_bad_pixels: frame 0, through this path when it passes hdr_check
        bp = None
        if cal is not None and cal.bad_pixels_done:
            bp = cal.bad_pixel_list
        else:
            with metrics.sync("hdr0"):
                frame0_hdr = bool(is_hdr[0])
            if frame0_hdr:
                with metrics.sync("frame"):
                    frame0 = fixed[0].cpu().numpy().view(np.uint16)
                bp = pixel_ops.detect_bad_pixels(frame0, w, h, black,
                                                 aggressive=(cfg.fix_bad_pixels == 2),
                                                 crop_x=crop_x, crop_y=crop_y)
            if cal is not None:
                cal.bad_pixel_list = bp
                cal.bad_pixels_done = True
        if bp is not None and len(bp):
            fixed = pixel_ops.fix_pixel_list_batch(fixed, bp, black, crop_x, crop_y, dual_iso=True)
    if fixed is not imgs:
        imgs = torch.where(is_hdr[:, None, None], fixed, imgs)

    cached_rggb = getattr(cal, "dual_iso_rggb", None) if cal is not None else None
    if cfg.exact_luts:
        with metrics.sync("hdr"):
            is_hdr_host = is_hdr.cpu().numpy()
        ok, y_off, hh, scalars, white20 = _analyze_exact(imgs, is_hdr_host, cached_rggb, black, cal)
        metrics.count("dualiso.frames_seen", b)
        metrics.count("dualiso.frames_converted", int(ok.sum()))
        if not ok.any():
            return imgs, ok
        row_bright, s_arr, a_arr, b20_arr, wd_arr, ce_arr, ov_arr = (
            torch.from_numpy(v).to(dev) for v in scalars)
    else:
        from . import dualiso_analysis_dev as analysis_dev

        if cached_rggb is not None:
            rggb = cached_rggb
        else:
            with metrics.sync("rggb"):
                rggb = bool(analysis_dev.rggb_stat(imgs[0]))
        if cal is not None:
            cal.dual_iso_rggb = rggb
        y_off = 0 if rggb else 1
        hh = h if rggb else h - 1
        (ok_t, row_bright, s_arr, a_arr, b20_arr, wd_arr, ce_arr, ov_arr,
         white20s) = analysis_dev.analyze_batch(imgs, is_hdr, y_off, hh, black)
        # the batch's one readback: which frames convert, and their whites
        with metrics.sync("analysis"):
            host = torch.stack([ok_t.to(torch.int32), white20s]).cpu().numpy()
        ok, w20 = host[0].astype(bool), host[1]
        metrics.count("dualiso.frames_seen", b)
        metrics.count("dualiso.frames_converted", int(ok.sum()))
        if not ok.any():
            return imgs, ok
        white20 = getattr(cal, "dual_iso_white20", None) if cal is not None else None
        if white20 is None:
            # the first converted batch fixes the clip's reconstruction white
            white20 = int(w20[ok][0])
            if cal is not None:
                cal.dual_iso_white20 = white20

    out_sub = reconstruct_batch(
        imgs[:, y_off : y_off + hh], row_bright, s_arr, a_arr, b20_arr, wd_arr, ce_arr, ov_arr,
        black20=black * 64, white20=white20, interp_method=cfg.hdr_interpolation_method,
        use_fullres=not cfg.hdr_no_fullres, use_alias=not cfg.hdr_no_alias_map,
        cs_method=cfg.chroma_smooth, exact_luts=bool(cfg.exact_luts))
    merged = imgs.clone()
    merged[:, y_off : y_off + hh] = out_sub
    return torch.where(torch.from_numpy(ok).to(dev)[:, None, None], merged, imgs), ok
