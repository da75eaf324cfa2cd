"""Reference copy of ``mlvfs_tpu_torch/ops/amaze_edge.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

The dual-ISO edge scorer and directional pick: kernel #6 and its plain twin.

Counterpart of ``mlvfs_tpu/ops/amaze_edge_pallas.py`` (``edge_pick``, the
Pallas kernel) and of ``mlvfs_tpu/ops/amaze.py:edge_pick_xla`` (its XLA
form): the per-pixel best of 12 edge directions, scored over an 11-offset
window in EV space (hdr.c:1094-1175), then the EV mean of the picked
direction and its two neighbours (hdr.c:1182-1210), on (B, H, W) int32 EV
planes. Every tap outside the frame reads 0 (the reference's ``_shift``
fill); the row taps are y + s*k with the per-row sign s.

:func:`edge_pick` runs :func:`edge_pick_plain` on a CPU tensor and launches
``csrc/amaze_edge.cu`` on a CUDA tensor, or raises. It never falls back from
one to the other. Both are integer arithmetic and agree bit for bit.
"""

from __future__ import annotations

import torch

from .alias import shift
from .dualiso_analysis_dev import tdiv
from .luts import EV_RESOLUTION


# edge direction table (hdr.c:916-938): (ack, a, b, bck) as (dx, row class);
# a row class k reads row y + s*k. Index D0 is "vertical, preferred".
EDGE_DIRECTIONS = (
    ((-4, 2), (-2, 1), (4, -2), (6, -3)),
    ((-3, 2), (-1, 1), (3, -2), (4, -3)),
    ((-2, 2), (-1, 1), (2, -2), (3, -3)),
    ((-1, 2), (-1, 1), (1, -2), (2, -3)),
    ((-1, 2), (0, 1), (1, -2), (1, -3)),
    ((0, 2), (0, 1), (0, -2), (0, -3)),
    ((1, 2), (0, 1), (-1, -2), (-1, -3)),
    ((1, 2), (1, 1), (-1, -2), (-2, -3)),
    ((2, 2), (1, 1), (-2, -2), (-3, -3)),
    ((3, 2), (1, 1), (-3, -2), (-4, -3)),
    ((4, 2), (2, 1), (-4, -2), (-6, -3)),
    ((6, 2), (3, 1), (-6, -2), (-9, -3)),
)
D0 = len(EDGE_DIRECTIONS) // 2
SEARCH_AREA = 5


def srow_shift(a, s, mag):
    """a[..., y + s*mag, x] (0 outside the frame) with the per-frame,
    per-row sign s (B, H): +1 where s == 1, else -1."""
    return torch.where((s == 1)[:, :, None], shift(a, mag, 0), shift(a, -mag, 0))


def _check(evgray, EW_a, EW_b, s, restricted):
    if evgray.dim() != 3 or any(t.shape != evgray.shape for t in (EW_a, EW_b, restricted)):
        raise ValueError("edge_pick takes (B, H, W) planes of one shape")
    if s.shape != evgray.shape[:2]:
        raise ValueError(f"edge_pick takes a (B, H) row sign, got {tuple(s.shape)}")
    if any(t.dtype != torch.int32 for t in (evgray, EW_a, EW_b, s)) or restricted.dtype != torch.bool:
        raise TypeError("edge_pick takes int32 EV planes and row signs and a bool restricted map")
    if any(t.device != evgray.device for t in (EW_a, EW_b, s, restricted)):
        raise ValueError("edge_pick takes its inputs on one device")


def edge_pick_plain(evgray, EW_a, EW_b, s, restricted):
    """Plain twin of the kernel: the picked EV-index plane (B, H, W) int32.
    Runs on any device."""
    _check(evgray, EW_a, EW_b, s, restricted)
    _, h, w = evgray.shape
    yy = torch.arange(h, device=evgray.device)[:, None]
    xx = torch.arange(w, device=evgray.device)[None, :]
    T = {2: srow_shift(evgray, s, 2), 1: srow_shift(evgray, s, 1),
         -2: srow_shift(evgray, -s, 2), -3: srow_shift(evgray, -s, 3)}

    def box11(d):
        # sum_{j=-5..5} d(x+j) by shift-doubling partial sums, as the
        # reference; equal to the direct sum inside the scored window
        s2 = d + shift(d, 0, 1)
        s4 = s2 + shift(s2, 0, 2)
        s8 = s4 + shift(s4, 0, 4)
        return shift(s8, 0, -SEARCH_AREA) + shift(s2, 0, 3) + shift(d, 0, SEARCH_AREA)

    best = d_best = None
    for di, (ack, a, b, bck) in enumerate(EDGE_DIRECTIONS):
        p1, p2, p3, p4 = (shift(T[k], 0, dx) for dx, k in (ack, a, b, bck))
        d = (p1 - p2).abs() + (p2 - p3).abs() + (p3 - p4).abs()
        score = box11(d) + abs(di - D0) * EV_RESOLUTION // 8
        if best is None:
            best, d_best = score, torch.zeros_like(score)
        else:
            take = score < best  # the first minimum wins
            best = torch.where(take, score, best)
            d_best = torch.where(take, di, d_best)
    window = (yy >= 5) & (yy < h - 5) & (xx >= 5) & (xx < w - 5)
    d_best = torch.where(restricted | ~window, D0, d_best)

    idxp = (d_best + 1).clamp(max=len(EDGE_DIRECTIONS) - 1)
    idxm = (d_best - 1).clamp(min=0)
    pi0 = pip = pim = None
    for di, (_, a, b, _) in enumerate(EDGE_DIRECTIONS):
        val = tdiv(shift(EW_a, 0, a[0]) * 2 + shift(EW_b, 0, b[0]), 3)
        if pi0 is None:
            pi0 = pip = pim = val
        else:
            pi0 = torch.where(d_best == di, val, pi0)
            pip = torch.where(idxp == di, val, pip)
            pim = torch.where(idxm == di, val, pim)
    return tdiv(2 * pi0 + pip + pim, 4).to(torch.int32)


def edge_pick(evgray, EW_a, EW_b, s, restricted):
    """The picked EV-index plane of a batch: (B, H, W) int32 EV planes of the
    grayscale and of the 'a' and 'b' taps, the (B, H) int32 row signs and the
    (B, H, W) bool map of pixels held to the vertical direction → (B, H, W)
    int32.

    Here the plain version on any device.
    """
    return edge_pick_plain(evgray, EW_a, EW_b, s, restricted)
