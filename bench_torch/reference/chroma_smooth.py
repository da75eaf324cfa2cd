"""Reference copy of ``mlvfs_tpu_torch/ops/chroma_smooth.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Chroma smoothing (2x2 / 3x3 / 5x5): the CUDA kernel and its plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/chroma_smooth.py`` (u16 path). Algorithm
(reference template chroma_smooth.c, instantiated in cs.c:37-47): for every
2x2 Bayer cell in the window x in [4, w-4), y in [4, h-5) (template:26-28),
take the median of (R−G) and (B−G) in EV space over the surrounding 5/9/25
cells, and reapply those chroma offsets to the cell's mean green. Only the
R (even, even) and B (odd, odd) sites of window cells are rewritten.

Bit-exactness: C int32 arithmetic (wrapping adds, truncating ``/ 2``) and the
raw→EV table's INT_MIN at ``pixel == black``. The EV transforms are the
lookup tables of ``ops/luts.py``, which define them (the JAX package's
double-single ``evarith`` form is proven equal to them by its self-check).

:func:`chroma_smooth_batch` is the entry point of the processing pipeline. On
a CPU tensor it runs :func:`chroma_smooth_batch_plain`; on a CUDA tensor it
launches the hand-written kernel ``csrc/chroma.cu`` (built by ``_build``) or
raises. It never falls back from one to the other. :func:`chroma_smooth_20` is
the 20-bit form the full dual-ISO reconstruction calls, on the same plain
code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .luts import EV_RESOLUTION, ev2raw_lut
from .medians import median_planes
from .pixels import ev_tables, wrap32
from .unpack import to_int16_bits


METHODS = (2, 3, 5)


def _offsets(method: int):
    """Neighbourhood cell offsets (dx, dy) in pixels (chroma_smooth.c:1-16,41-48)."""
    m = 4 if method == 5 else 2
    offs = []
    for i in range(-m, m + 1, 2):
        for j in range(-m, m + 1, 2):
            if method == 2 and abs(i) + abs(j) == 4:
                continue
            offs.append((i, j))
    return offs


def cell_window(height: int, width: int):
    """(ny, nx): rows and columns of 2x2 cells smoothed, top-left at (4, 4)."""
    return max(0, (height - 8) // 2), max(0, (width - 7) // 2)


def _check(imgs: torch.Tensor, method: int):
    if method not in METHODS:
        raise ValueError(f"unsupported chroma smooth method {method}")
    if imgs.dim() != 3:
        raise ValueError(f"chroma smoothing takes (B, H, W) frames, got shape {tuple(imgs.shape)}")
    h, w = imgs.shape[1:]
    ny, nx = cell_window(h, w)
    if method == 5 and w % 2 and ny and nx:
        # the 5x5 neighbourhood of the last cell column reads one column past
        # the frame; the reference's slices refuse such frames too
        raise ValueError(f"5x5 chroma smoothing needs an even frame width, got {w}")


def _div2_trunc(t: torch.Tensor) -> torch.Tensor:
    """C's int32 ``t / 2`` (truncation toward zero)."""
    return torch.div(t, 2, rounding_mode="trunc")


def _smooth_plain(src: torch.Tensor, method: int, lut: torch.Tensor, inv: torch.Tensor,
                  black: int) -> torch.Tensor:
    """The smoothing of (B, H, W) int64 pixel values through the raw→EV table
    ``lut`` (indexed by the pixel value, clamped to the table) and the EV→raw
    table ``inv`` (indexed by ``ev + 10·EVR``) → a new (B, H, W) int64."""
    h, w = src.shape[1:]
    ny, nx = cell_window(h, w)
    if ny == 0 or nx == 0:
        return src.clone()
    ev = lut[src.clamp(0, lut.shape[0] - 1)]  # one whole-frame raw→EV lookup

    def ev_cells(dy, dx):
        # the cells' pixels at (4 + dy + 2cy, 4 + dx + 2cx)
        return ev[:, 4 + dy : 4 + dy + 2 * ny : 2, 4 + dx : 4 + dx + 2 * nx : 2]

    ge = _div2_trunc(wrap32(ev_cells(0, 1) + ev_cells(1, 0)))
    med_r, med_b = [], []
    for i, j in _offsets(method):
        gen = _div2_trunc(wrap32(ev_cells(j, i + 1) + ev_cells(j + 1, i)))
        med_r.append(wrap32(ev_cells(j, i) - gen))
        med_b.append(wrap32(ev_cells(j + 1, i + 1) - gen))
    er = wrap32(ge + median_planes(med_r))
    eb = wrap32(ge + median_planes(med_b))

    # skip dark cells and negative results (template:35, 64-65)
    ok = (ge >= 2 * EV_RESOLUTION) & (er > EV_RESOLUTION) & (eb > EV_RESOLUTION)

    def to_raw(e):
        return inv[e.clamp(0, 14 * EV_RESOLUTION - 1) + 10 * EV_RESOLUTION] + black

    out = src.clone()
    r_sites = out[:, 4 : 4 + 2 * ny : 2, 4 : 4 + 2 * nx : 2]
    b_sites = out[:, 5 : 5 + 2 * ny : 2, 5 : 5 + 2 * nx : 2]
    r_sites.copy_(torch.where(ok, to_raw(er), r_sites))
    b_sites.copy_(torch.where(ok, to_raw(eb), b_sites))
    return out


def chroma_smooth_batch_plain(imgs: torch.Tensor, method: int, black: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W) int16 (u16 bits) → a new
    (B, H, W) int16.

    Runs on any device; :func:`chroma_smooth_batch` uses it for CPU tensors,
    and the GPU smoke test holds the kernel against it on the card. int32
    arithmetic runs in int64, wrapped back to int32 where C would wrap.
    """
    _check(imgs, method)
    lut, inv = ev_tables(int(black), imgs.device)
    out = _smooth_plain(imgs.to(torch.int64) & 0xFFFF, method, lut, inv, black)
    return to_int16_bits(out & 0xFFFF)


def chroma_smooth_20(frames: torch.Tensor, method: int, lut20: torch.Tensor,
                     inv20: torch.Tensor) -> torch.Tensor:
    """The 20-bit form inside the full dual-ISO reconstruction (hdr.c:1488-1500,
    ``mlvfs_tpu/ops/dualiso_full.py:372-392``): (B, H, W) int32 frames at 20
    bits, black 0, through ``lut20`` = raw2ev_lut20(black20, white20) and
    ``inv20`` = ev2raw_lut20(black20, white20), both int64 on the frames'
    device → a new (B, H, W) int32.

    Plain torch on every device: the reference runs this stage in XLA, not
    through the chroma kernel."""
    _check(frames, method)
    return _smooth_plain(frames.to(torch.int64), method, lut20, inv20, 0).to(torch.int32)


def chroma_smooth_batch(imgs: torch.Tensor, method: int, black: int) -> torch.Tensor:
    """Chroma smoothing of a batch (chroma_smooth, cs.c:49-84): (B, H, W)
    int16 (u16 bits) → a new (B, H, W) int16.

    Here the plain version on any device.
    """
    return chroma_smooth_batch_plain(imgs, method, black)
