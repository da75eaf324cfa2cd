"""Reference copy of ``mlvfs_tpu_torch/ops/amaze.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Dual-ISO amaze-edge interpolation (``--dual-iso`` without ``--mean23``).

Counterpart of ``mlvfs_tpu/ops/amaze.py`` (amaze_interpolate,
hdr.c:954-1229), batched over frames (B, H, W):

  1. squeeze each exposure to half height by moving the other exposure's
     rows away (a per-frame row permutation), greens pre-scaled by 1/2;
  2. AMaZE-demosaic the squeezed image (``amaze_core``: kernels #8 and #10
     on the card);
  3. the gray plane g/2 + r/4 + b/4 in the original row order, in EV;
  4. the best of 12 edge directions per pixel and the EV mean of the picked
     direction and its neighbours (``amaze_edge``: kernel #6 on the card);
  5. back to raw through the inverse EV transform, inside [2, h-3] x [2, w-3].

The transforms ``ev_of``, ``ev2raw_at`` and ``frcurve_of`` are the
reconstruction's (computed, or the tables with ``exact_luts``); every shift
here is zero-filled, as the reference's ``_shift``.
"""

from __future__ import annotations

import torch

from .amaze_core import amaze_demosaic
from .amaze_edge import EDGE_DIRECTIONS, edge_pick, srow_shift
from .dualiso_analysis_dev import tdiv

FULLRES_THR = 0.8

__all__ = ["EDGE_DIRECTIONS", "squeeze_rows", "amaze_edge_interpolate"]


def squeeze_rows(row_bright: torch.Tensor) -> torch.Tensor:
    """The squeeze permutation (hdr.c:977-1026) of (B, H) bool rows:
    squeezed[b, y] = the row that row y moves to. Dark rows go to the top in
    order from the first dark row, bright rows below them from
    (H // 4) * 2 + the first bright row, capped at H - 1 (the reference stops
    at yh >= h, hdr.c:1025). int64."""
    h = row_bright.shape[-1]
    rb = row_bright.to(torch.int64)
    dark = 1 - rb
    first_dark = torch.argmax(dark, dim=-1, keepdim=True)  # the first maximum
    first_bright = torch.argmax(rb, dim=-1, keepdim=True)
    nd_before = torch.cumsum(dark, -1) - dark
    nb_before = torch.cumsum(rb, -1) - rb
    sq_dark = first_dark + nd_before
    sq_bright = ((h // 4) * 2 + first_bright + nb_before).clamp(max=h - 1)
    return torch.where(row_bright, sq_bright, sq_dark)


def _rows(x, idx):
    """x[b, idx[b, y], :] for (B, H, W) x and (B, H) row indices."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def amaze_edge_interpolate(raw, ev2raw_at, row_bright, s, ev_of, frcurve_of, white_darkened, *,
                           black20: int):
    """(dark, bright) interpolated exposures of (B, H, W) int32 20-bit frames
    (amaze_interpolate, hdr.c:954), before the border interpolation.
    ``row_bright``/``s`` are (B, H) bool/int32, ``white_darkened`` (B,)."""
    b, h, w = raw.shape
    dev = raw.device
    squeezed = squeeze_rows(row_bright)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]

    # squeeze with the green pre-scale (hdr.c:987-1019): row squeezed[y] of
    # the squeezed image is row y; a row no source lands on keeps row 0's
    # place in the permutation's inverse, and of two sources on one row
    # (the cap at H - 1) the later one wins, as the reference's scatter
    green_site = (xx % 2) != (yy % 2)
    scaled = torch.where(green_site, tdiv(raw - black20, 2) + black20, raw)
    src = torch.arange(h, device=dev).expand(b, h)
    inv = torch.zeros((b, h), dtype=torch.int64, device=dev).scatter_reduce(
        1, squeezed, src, reduce="amax", include_self=True)
    sq_img = _rows(scaled.to(torch.float32), inv)

    red, grn, blu = amaze_demosaic(sq_img.contiguous())

    # undo the green scaling, clamp (hdr.c:1045-1053), de-squeeze
    grn = torch.clamp((grn - black20) * 2.0 + black20, 0, 0xFFFFF)
    red = torch.clamp(red, 0, 0xFFFFF)
    blu = torch.clamp(blu, 0, 0xFFFFF)
    U_r, U_g, U_b = (_rows(p, squeezed) for p in (red, grn, blu))

    # grayscale in the original rows (hdr.c:1059-1062), truncated to int
    gray = (U_g / 2.0 + U_r / 4.0 + U_b / 4.0).to(torch.int32)
    evgray = ev_of(gray)

    # restricted pixels take the vertical direction (hdr.c:1105-1133)
    fc = frcurve_of(raw)
    rb2 = row_bright[:, :, None]
    restricted = torch.where(rb2, raw < white_darkened[:, None, None], fc > FULLRES_THR)

    # the taps' EV planes: each pixel's own colour, 'a' taps at y + s, 'b'
    # taps at y - 2s (hdr.c:1182-1210)
    red_mask = (yy % 2 == 0) & (xx % 2 == 0)
    blue_mask = (yy % 2 == 1) & (xx % 2 == 1)

    def ev_class(sign, mag):
        sel = [srow_shift(U, s * sign, mag) for U in (U_r, U_g, U_b)]
        v = torch.where(red_mask, sel[0], torch.where(blue_mask, sel[2], sel[1]))
        return ev_of(torch.clamp(torch.trunc(v), 0, 0xFFFFF).to(torch.int32))

    EW_a = ev_class(1, 1)
    EW_b = ev_class(-1, 2)

    interp_ev = edge_pick(evgray.contiguous(), EW_a.contiguous(), EW_b.contiguous(),
                          s.to(torch.int32).contiguous(), restricted.contiguous())
    interp_val = ev2raw_at(interp_ev)

    region = (yy >= 2) & (yy <= h - 3) & (xx >= 2) & (xx <= w - 3)
    interp = torch.where(region, interp_val, 0)
    native = torch.where(region, raw, 0)
    return torch.where(rb2, interp, native), torch.where(rb2, native, interp)

