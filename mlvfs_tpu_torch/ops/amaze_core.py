"""AMaZE demosaic (Aliasing Minimization and Zipper Elimination): kernel #8,
its plain PyTorch twin, and the tile grid of its raster passes.

Counterpart of ``mlvfs_tpu/ops/amaze_core.py`` (the XLA form the reference
runs on the CPU) and of the stencil stages of
``mlvfs_tpu/ops/amaze_pallas.py:_split_path`` (the Pallas kernels). It
demosaics a batch (B, H, W) of float32 RGGB mosaics on the 0..65535 scale
into (R, G, B) planes, with the reference's semantics on the CPU:

  * the frame is divided by 65535 and reflect-padded by 16 on each side;
    every stencil reads the padded frame with wrap-around (a roll), both
    rows and columns;
  * the reference's half-index arrays are per-2-pixel-cell values: the
    value of the cell's site lane (x % 2 == y % 2 for R/B, the other lane
    for green) on both of its pixels;
  * the four in-place raster passes (Nyquist dilation, the hvwt and pmwt
    refinements, chrominance smoothing) restart on the reference's tile
    grid: 160-row tiles every 128 rows (``SCAN_TILE``/``SCAN_STEP``), rows
    below the frame edge-padded, the rows below a tile read from the
    frame. They are ``ops/amaze_scans.py`` (kernel #10) and its twins here.

All arithmetic is float32, one IEEE operation at a time in the order the
reference writes it, except where XLA on the CPU contracts a product into
the sum it feeds: there the twin fuses it too (``evmath.fma``, one
rounding), and the division by 65535 is a multiply by the float32
reciprocal, as XLA folds it. The CUDA kernels (``csrc/amaze.cu``,
``csrc/amaze_scans.cu`` and ``csrc/amaze_mega.cu``, built with
``-fmad=false``, their arithmetic in ``csrc/amaze_stages.cuh``,
``csrc/amaze_tiles.cuh`` and ``csrc/amaze_passes.cuh``) repeat the same
operations and fuse the same products with ``__fmaf_rn``, so on the card
they give the twin's values. Which products XLA fuses depends on how it
fuses the whole program, so the twin is held to the reference at its own
tolerance between AMaZE forms (rtol 1e-5, atol 0.01 on the 0..65535
planes), not bit for bit.

:func:`amaze_demosaic` runs the twin on a CPU tensor and the kernels on a
CUDA tensor, or raises. It never falls back from one to the other. On the
card :func:`pallas_mode` picks the kernels, as ``MLVFS_AMAZE_PALLAS_MODE``
picks the reference's Pallas path (``mlvfs_tpu/ops/amaze_pallas.py``):
``split`` (the default) runs kernel #8's stage launches with kernel #10's
raster passes between them, any other value kernel #9 (``csrc/amaze_mega.cu``),
the whole demosaic in one launch. Both give the twin's bits.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from ..utils import metrics
from .evmath import fma

# Launches of kernel #8 by amaze_demosaic: one per call that runs the
# stencil stages on the card (the stages are several CUDA launches in a
# fixed order, between the raster passes; see csrc/amaze.cu). Only the
# wrapper adds to it.
KERNEL_LAUNCHES = 0
# Launches of kernel #9 (csrc/amaze_mega.cu) by amaze_demosaic in mega mode:
# one per call on the card. Only its wrapper adds to it; it never touches
# KERNEL_LAUNCHES or amaze_scans.KERNEL_LAUNCHES.
MEGA_LAUNCHES = 0

# The reference's selector of its AMaZE Pallas path
# (mlvfs_tpu/ops/amaze_pallas.py:743), with the same meaning here.
MODE_ENV = "MLVFS_AMAZE_PALLAS_MODE"

EPS = 1e-5
EPSSQ = 1e-10
ARTHRESH = 0.75
NYQTHRESH = 0.5
CLIP_PT = 1.0  # 1/initialGain, initialGain == 1 (amaze_demosaic_RT.c:37,133)
CLIP_PT8 = 0.8

GAUSSODD = (0.14659727707323927, 0.103592713382435, 0.0732036125103057, 0.0365543548389495)
GAUSSGRAD = (
    0.07384411893421103,
    0.06207511968171489,
    0.0521818194747806,
    0.03687419286733595,
    0.03099732204057846,
    0.018413194161458882,
)
GAUSSEVEN = (0.13719494435797422, 0.05640252782101291)
GQUINC = (0.169917, 0.108947, 0.069855, 0.0287182)

PAD = 16  # the reflect pad, and the tiles' apron
INV_65535 = float(torch.tensor(1.0 / 65535.0, dtype=torch.float32))

# The raster passes' tile grid (amaze_demosaic_RT.c:135): tile t covers
# padded rows [SCAN_STEP * t, SCAN_STEP * t + SCAN_TILE).
SCAN_TILE = 160
SCAN_STEP = 128


def _sh(a, dy, dx):
    """out[..., y, x] = a[..., y+dy, x+dx], wrapping."""
    if dy == 0 and dx == 0:
        return a
    return torch.roll(a, (-dy, -dx), (-2, -1))


def _ulim(a, b, c):
    return torch.clamp(a, torch.minimum(b, c), torch.maximum(b, c))


def _cells(vals, site):
    """Per-site values collapsed into per-cell values on both pixels of the
    2-pixel cell (the reference's indx>>1 arrays): left lane + right lane,
    the lane that is not the site holding 0."""
    t = torch.where(site, vals, torch.zeros((), dtype=vals.dtype))
    c = t[..., 0::2] + t[..., 1::2]
    return c.repeat_interleave(2, dim=-1)


def _ring(a, offs):
    return sum(_sh(a, dy, dx) for dy, dx in offs)


def _wsum(weights, a, rings, *, fuse_first=True):
    """weights[0] * a + weights[1] * ring 1 + ... as XLA on the CPU contracts
    it: each product after the second fused into the running sum, and of the
    first two either the first (``fuse_first``) or the second."""
    if fuse_first:
        acc = fma(weights[0], a, weights[1] * _ring(a, rings[0]))
    else:
        acc = fma(weights[1], _ring(a, rings[0]), weights[0] * a)
    for wt, offs in zip(weights[2:], rings[1:]):
        acc = fma(wt, _ring(a, offs), acc)
    return acc


# ------------------------------------------------------------ the tile grid


def n_tiles(hp: int) -> int:
    return max(1, -(-(hp - (SCAN_TILE - SCAN_STEP)) // SCAN_STEP))


def chunk_rows(arr, T):
    """(..., hp, wp) → (..., T, SCAN_TILE, wp): overlapping row chunks on the
    scan grid, rows below the frame repeating its last row."""
    hp = arr.shape[-2]
    need = SCAN_STEP * T + (SCAN_TILE - SCAN_STEP)
    rows = torch.arange(need, device=arr.device).clamp(max=hp - 1)
    idx = rows.unfold(0, SCAN_TILE, SCAN_STEP)  # (T, SCAN_TILE)
    return arr[..., idx, :]


def unchunk_rows(out, hp):
    """Inverse of chunk_rows keeping each tile's centre rows [PAD, PAD+STEP),
    the first tile's top rows and the last tile's tail."""
    first = out[..., 0, :PAD, :]
    mid = out[..., :, PAD : PAD + SCAN_STEP, :].flatten(-3, -2)
    last = out[..., -1, PAD + SCAN_STEP :, :]
    return torch.cat([first, mid, last], dim=-2)[..., :hp, :]


def _replicate_rows(vals, r):
    """Cell replication of rows at padded row parity r % 2."""
    wp = vals.shape[-1]
    site = (torch.arange(wp, device=vals.device) % 2) == (r % 2)
    return _cells(vals, site)


# ------------------------------------------------- the raster passes (#10)


def refine_plain(wt):
    """hvwt/pmwt refinement (amaze:1054-1058, :1280-1281) of (B, hp, wp)
    float32: a value is replaced by the mean of its four diagonal neighbours
    when that mean is further from 1/2. Row y reads the updated row y-1 (the
    tile's first row reads itself) and the original row y+1."""
    hp, wp = wt.shape[-2:]
    T = n_tiles(hp)
    tiles = chunk_rows(wt, T)                   # (B, T, 160, wp)
    nxt_tiles = chunk_rows(_sh(wt, 1, 0), T)
    prev = tiles[..., 0, :]
    rows = []
    for r in range(SCAN_TILE):
        old, nxt = tiles[..., r, :], nxt_tiles[..., r, :]
        alt = 0.25 * (torch.roll(prev, 1, -1) + torch.roll(prev, -1, -1)
                      + torch.roll(nxt, 1, -1) + torch.roll(nxt, -1, -1))
        new = torch.where((0.5 - old).abs() < (0.5 - alt).abs(), alt, old)
        prev = _replicate_rows(new, r)
        rows.append(prev)
    return unchunk_rows(torch.stack(rows, dim=-2), hp)


def _compose(f, g):
    """Transfer functions {0,1} → {0,1} as (f(0), f(1)): f after g."""
    return torch.where(g[0] == 0, f[0], f[1]), torch.where(g[1] == 0, f[0], f[1])


def dilate_plain(nyq):
    """Nyquist majority-vote dilation (amaze:998-1010) of (B, hp, wp) int32
    0/1 cells. Within a row each cell reads the updated cell to its left, so
    a row is a chain of transfer functions new = f(new[x-2]), composed here
    by doubling (the reference's associative scan), seeded with 0 at the
    tile's left edge."""
    hp, wp = nyq.shape[-2:]
    T = n_tiles(hp)
    t_o = chunk_rows(nyq, T)
    t_d1 = chunk_rows(_sh(nyq, 1, 0), T)
    t_d2 = chunk_rows(_sh(nyq, 2, 0), T)
    r2 = r1 = torch.zeros_like(t_o[..., 0, :])
    rows = []
    for r in range(SCAN_TILE):
        o, d1, d2 = t_o[..., r, :], t_d1[..., r, :], t_d2[..., r, :]
        K = (r2 + torch.roll(r1, 1, -1) + torch.roll(r1, -1, -1) + o + torch.roll(o, -2, -1)
             + torch.roll(d1, 1, -1) + torch.roll(d1, -1, -1) + d2)
        f0 = torch.where(K > 4, 1, torch.where(K < 4, 0, o))
        f1 = torch.where(K + 1 > 4, 1, torch.where(K + 1 < 4, 0, o))
        site = (torch.arange(wp, device=nyq.device) % 2) == (r % 2)
        f = tuple((torch.where(site, v, 0)[..., 0::2] + torch.where(site, v, 0)[..., 1::2])
                  for v in (f0, f1))
        n = f[0].shape[-1]
        shift = 1
        while shift < n:
            g = (torch.nn.functional.pad(f[0][..., :-shift], (shift, 0), value=0),
                 torch.nn.functional.pad(f[1][..., :-shift], (shift, 0), value=1))
            f = _compose(f, g)
            shift *= 2
        new = f[0].repeat_interleave(2, dim=-1).to(nyq.dtype)
        r2, r1 = r1, new
        rows.append(new)
    return unchunk_rows(torch.stack(rows, dim=-2), hp)


def chroma_plain(D, update_parity: int):
    """Directional chrominance interpolation (amaze:1386-1398) of one
    (B, hp, wp) float32 plane: rows of padded parity ``update_parity`` get
    the interpolation from rows y-1, y-3 (updated: zero above the tile's
    top) and y+1, y+3 (original); the other rows keep their values. Plane 0
    (G-R) updates on B rows (parity 1), plane 1 (G-B) on R rows (parity 0)."""
    hp, wp = D.shape[-2:]
    T = n_tiles(hp)
    t_o = chunk_rows(D, T)
    t_d1 = chunk_rows(_sh(D, 1, 0), T)
    t_d3 = chunk_rows(_sh(D, 3, 0), T)
    zero = torch.zeros_like(t_o[..., 0, :])
    news = []
    for r in range(SCAN_TILE):
        o = t_o[..., r, :]
        if r % 2 != update_parity:
            news.append(o)
            continue
        um1 = news[r - 1] if r >= 1 else zero
        um3 = news[r - 3] if r >= 3 else zero
        d1, d3 = t_d1[..., r, :], t_d3[..., r, :]

        def at(row, dx):
            return torch.roll(row, -dx, -1)

        nm1, pp1, nm3, pp3 = at(um1, -1), at(um1, 1), at(um3, -3), at(um3, 3)
        om1, op1, om3, op3 = at(d1, 1), at(d1, -1), at(d3, 3), at(d3, -3)
        wtnw = 1.0 / (EPS + (nm1 - om1).abs() + (nm1 - nm3).abs() + (om1 - nm3).abs())
        wtne = 1.0 / (EPS + (pp1 - op1).abs() + (pp1 - pp3).abs() + (op1 - pp3).abs())
        wtsw = 1.0 / (EPS + (op1 - pp1).abs() + (op1 - om3).abs() + (pp1 - op3).abs())
        wtse = 1.0 / (EPS + (om1 - nm1).abs() + (om1 - op3).abs() + (nm1 - om3).abs())
        def taps(c1, c3, a, b):  # 1.325 c1 - 0.175 c3 - 0.075 a - 0.075 b
            return fma(-0.075, b, fma(-0.075, a, fma(1.325, c1, -(0.175 * c3))))

        val = fma(wtse, taps(om1, om3, at(d1, 3), at(d3, 1)),
                  fma(wtsw, taps(op1, op3, at(d1, -3), at(d3, -1)),
                      fma(wtnw, taps(nm1, nm3, at(um1, -3), at(um3, -1)),
                          wtne * taps(pp1, pp3, at(um1, 3), at(um3, 1))))
                  ) / (wtnw + wtne + wtsw + wtse)
        news.append(_replicate_rows(val, r))
    return unchunk_rows(torch.stack(news, dim=-2), hp)


# ---------------------------------------------------------- the demosaic


def pad_mosaic(raw):
    """(B, H, W) float32 on the 0..65535 scale → the padded (B, H+32, W+32)
    frame on the 0..1 scale that every stage reads."""
    # XLA divides by a constant as a multiply by its float32 reciprocal
    cfa = raw.to(torch.float32) * INV_65535
    return torch.nn.functional.pad(cfa, (PAD, PAD, PAD, PAD), mode="reflect")


def _check(raw):
    if raw.dim() != 3:
        raise ValueError(f"amaze_demosaic takes (B, H, W) mosaics, got shape {tuple(raw.shape)}")
    if raw.dtype != torch.float32:
        raise TypeError(f"amaze_demosaic takes float32 mosaics, got {raw.dtype}")
    h, w = raw.shape[-2:]
    if h < PAD + 1 or w < PAD + 1 or w % 2:
        raise ValueError(f"amaze_demosaic takes frames of at least 17x17 px with an even width, "
                         f"got {h}x{w}")


def _stencil_stages_plain(cfa, passes):
    """The demosaic of the padded frame ``cfa`` (B, hp, wp); ``passes`` gives
    the raster passes (refine, dilate, chroma). Returns (R, G, B) padded."""
    hp, wp = cfa.shape[-2:]
    dev = cfa.device
    yy = torch.arange(hp, device=dev)[:, None]
    xx = torch.arange(wp, device=dev)[None, :]
    green = ((yy + xx) % 2) == 1
    rbmask = ~green
    sgn = torch.where(green, -1.0, 1.0).to(torch.float32)
    s = _sh

    # ---- gradients (amaze:568-579)
    delh = (s(cfa, 0, 1) - s(cfa, 0, -1)).abs()
    delv = (s(cfa, 1, 0) - s(cfa, -1, 0)).abs()
    dirwts0 = EPS + (s(cfa, 2, 0) - cfa).abs() + (cfa - s(cfa, -2, 0)).abs() + delv
    dirwts1 = EPS + (s(cfa, 0, 2) - cfa).abs() + (cfa - s(cfa, 0, -2)).abs() + delh
    delhvsqsum = fma(delh, delh, delv * delv)

    # ---- diagonal gradients per cell (amaze:607-625)
    def sq(v):
        return v * v

    delp = _cells((s(cfa, -1, 1) - s(cfa, 1, -1)).abs(), rbmask)
    delm = _cells((s(cfa, 1, 1) - s(cfa, -1, -1)).abs(), rbmask)
    def sqsum(a, b):
        return fma(a, a, b * b)

    dgsqp = _cells(sqsum(cfa - s(cfa, -1, 1), cfa - s(cfa, 1, -1)), green)
    dgsqm = _cells(sqsum(cfa - s(cfa, 1, 1), cfa - s(cfa, -1, -1)), green)

    # ---- cardinal interpolation (amaze:690-746)
    def ratio(n, dwfar, dw, far):
        return n * (dwfar + dw) / fma(dwfar, EPS + cfa, dw * (EPS + far))

    cru = ratio(s(cfa, -1, 0), s(dirwts0, -2, 0), dirwts0, s(cfa, -2, 0))
    crd = ratio(s(cfa, 1, 0), s(dirwts0, 2, 0), dirwts0, s(cfa, 2, 0))
    crl = ratio(s(cfa, 0, -1), s(dirwts1, 0, -2), dirwts1, s(cfa, 0, -2))
    crr = ratio(s(cfa, 0, 1), s(dirwts1, 0, 2), dirwts1, s(cfa, 0, 2))

    guha = s(cfa, -1, 0) + 0.5 * (cfa - s(cfa, -2, 0))
    gdha = s(cfa, 1, 0) + 0.5 * (cfa - s(cfa, 2, 0))
    glha = s(cfa, 0, -1) + 0.5 * (cfa - s(cfa, 0, -2))
    grha = s(cfa, 0, 1) + 0.5 * (cfa - s(cfa, 0, 2))

    guar = torch.where((1.0 - cru).abs() < ARTHRESH, cfa * cru, guha)
    gdar = torch.where((1.0 - crd).abs() < ARTHRESH, cfa * crd, gdha)
    glar = torch.where((1.0 - crl).abs() < ARTHRESH, cfa * crl, glha)
    grar = torch.where((1.0 - crr).abs() < ARTHRESH, cfa * crr, grha)

    hwt = s(dirwts1, 0, -1) / (s(dirwts1, 0, -1) + s(dirwts1, 0, 1))
    vwt = s(dirwts0, -1, 0) / (s(dirwts0, 1, 0) + s(dirwts0, -1, 0))

    Gintvha = fma(vwt, gdha, (1.0 - vwt) * guha)
    Ginthha = fma(hwt, grha, (1.0 - hwt) * glha)
    vcdalt = sgn * (Gintvha - cfa)
    hcdalt = sgn * (Ginthha - cfa)

    clipmask = (cfa > CLIP_PT8) | (Gintvha > CLIP_PT8) | (Ginthha > CLIP_PT8)
    guar = torch.where(clipmask, guha, guar)
    gdar = torch.where(clipmask, gdha, gdar)
    glar = torch.where(clipmask, glha, glar)
    grar = torch.where(clipmask, grha, grar)
    vcd = torch.where(clipmask, vcdalt, sgn * (fma(vwt, gdar, (1.0 - vwt) * guar) - cfa))
    hcd = torch.where(clipmask, hcdalt, sgn * (fma(hwt, grar, (1.0 - hwt) * glar) - cfa))

    dgintv = torch.minimum(sq(guha - gdha), sq(guar - gdar))
    dginth = torch.minimum(sq(glha - grha), sq(glar - grar))

    # ---- variance-based selection + bounding (amaze:805-874)
    def var3(a, d1, d2):
        x0, x1, x2 = s(a, *d1), a, s(a, *d2)
        t = x0 + x1 + x2
        return fma(3.0, fma(x2, x2, fma(x0, x0, x1 * x1)), -(t * t))

    hcdvar = var3(hcd, (0, -2), (0, 2))
    hcdaltvar = var3(hcdalt, (0, -2), (0, 2))
    vcdvar = var3(vcd, (-2, 0), (2, 0))
    vcdaltvar = var3(vcdalt, (-2, 0), (2, 0))
    hcd = torch.where(hcdaltvar < hcdvar, hcdalt, hcd)
    vcd = torch.where(vcdaltvar < vcdvar, vcdalt, vcd)

    cl, cr_ = s(cfa, 0, -1), s(cfa, 0, 1)
    cu, cd = s(cfa, -1, 0), s(cfa, 1, 0)

    def bound_green(cdv, lo, hi):
        gint = -cdv + cfa
        wt = 1.0 - 3.0 * cdv / (EPS + gint + cfa)
        c_hi = -_ulim(gint, lo, hi) + cfa
        out = torch.where(cdv > 0, torch.where(3.0 * cdv > (gint + cfa), c_hi,
                                               fma(wt, cdv, (1.0 - wt) * c_hi)), cdv)
        return torch.where(gint > CLIP_PT, c_hi, out)

    def bound_rb(cdv, lo, hi):
        gint = cdv + cfa
        wt = 1.0 + 3.0 * cdv / (EPS + gint + cfa)
        c_lo = _ulim(gint, lo, hi) - cfa
        out = torch.where(cdv < 0, torch.where(3.0 * cdv < -(gint + cfa), c_lo,
                                               fma(wt, cdv, (1.0 - wt) * c_lo)), cdv)
        return torch.where(gint > CLIP_PT, c_lo, out)

    hcd, vcd = (torch.where(green, bound_green(hcd, cl, cr_), bound_rb(hcd, cl, cr_)),
                torch.where(green, bound_green(vcd, cu, cd), bound_rb(vcd, cu, cd)))
    cddiffsq = sq(vcd - hcd)  # meaningful at R/B sites

    # ---- directional weights hvwt (amaze:922-962)
    uave = vcd + s(vcd, -1, 0) + s(vcd, -2, 0) + s(vcd, -3, 0)
    dave = vcd + s(vcd, 1, 0) + s(vcd, 2, 0) + s(vcd, 3, 0)
    lave = hcd + s(hcd, 0, -1) + s(hcd, 0, -2) + s(hcd, 0, -3)
    rave = hcd + s(hcd, 0, 1) + s(hcd, 0, 2) + s(hcd, 0, 3)

    def var4(a, d1, d2, d3, ave):
        e = [a - ave] + [s(a, *d) - ave for d in (d1, d2, d3)]
        return fma(e[3], e[3], fma(e[2], e[2], fma(e[0], e[0], e[1] * e[1])))

    Dgrbvvaru = var4(vcd, (-1, 0), (-2, 0), (-3, 0), uave)
    Dgrbvvard = var4(vcd, (1, 0), (2, 0), (3, 0), dave)
    Dgrbhvarl = var4(hcd, (0, -1), (0, -2), (0, -3), lave)
    Dgrbhvarr = var4(hcd, (0, 1), (0, 2), (0, 3), rave)

    vcdvar_w = fma(1.0 - vwt, Dgrbvvaru, fma(vwt, Dgrbvvard, EPSSQ))
    hcdvar_w = fma(1.0 - hwt, Dgrbhvarl, fma(hwt, Dgrbhvarr, EPSSQ))

    fluct_u = dgintv + s(dgintv, -1, 0) + s(dgintv, -2, 0)
    fluct_d = dgintv + s(dgintv, 1, 0) + s(dgintv, 2, 0)
    fluct_l = dginth + s(dginth, 0, -1) + s(dginth, 0, -2)
    fluct_r = dginth + s(dginth, 0, 1) + s(dginth, 0, 2)
    vcdvar1 = fma(1.0 - vwt, fluct_u, fma(vwt, fluct_d, EPSSQ))
    hcdvar1 = fma(1.0 - hwt, fluct_l, fma(hwt, fluct_r, EPSSQ))

    varwt = hcdvar_w / (vcdvar_w + hcdvar_w)
    diffwt = hcdvar1 / (vcdvar1 + hcdvar1)
    agree = ((0.5 - varwt) * (0.5 - diffwt) > 0) & ((0.5 - diffwt).abs() < (0.5 - varwt).abs())
    hvwt = _cells(torch.where(agree, varwt, diffwt), rbmask)

    # ---- Nyquist test (amaze:967-996)
    DIAG1 = [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    AXIS2 = [(-2, 0), (0, -2), (0, 2), (2, 0)]
    DIAG2 = [(-2, -2), (-2, 2), (2, -2), (2, 2)]
    nyqtest = _wsum(GAUSSODD, cddiffsq, [DIAG1, AXIS2, DIAG2])
    nyqtest = nyqtest - NYQTHRESH * _wsum(GAUSSGRAD, delhvsqsum, [
        [(-1, 0), (0, 1), (0, -1), (1, 0)], DIAG1, AXIS2,
        [(-2, -1), (-2, 1), (-1, -2), (-1, 2), (1, -2), (1, 2), (2, -1), (2, 1)], DIAG2], fuse_first=False)
    nyq0 = _cells(torch.where(rbmask & (nyqtest > 0), 1, 0).to(torch.int32), rbmask)

    nyq = passes["dilate"](nyq0)

    # ---- area interpolation in Nyquist regions (amaze:1016-1045)
    qh = cfa - 0.5 * (cl + cr_)
    qv = cfa - 0.5 * (cu + cd)
    qsh = 0.5 * fma(cfa - cl, cfa - cl, sq(cfa - cr_))
    qsv = 0.5 * fma(cfa - cu, cfa - cu, sq(cfa - cd))
    nm = (nyq > 0) & rbmask
    nmf = nm.to(torch.float32)

    def ring77(a):
        # the 7x7 stride-2 box, separable: rows of 7 taps, then 7 rows
        r = sum(s(a, 0, j) for j in range(-6, 7, 2))
        return sum(s(r, i, 0) for i in range(-6, 7, 2))

    sumh = ring77(qh * nmf)
    sumv = ring77(qv * nmf)
    sumsqh = ring77(qsh * nmf)
    sumsqv = ring77(qsv * nmf)
    areawt = ring77(nmf)
    hcdvar_a = EPSSQ + fma(areawt, sumsqh, -(sumh * sumh)).abs()
    vcdvar_a = EPSSQ + fma(areawt, sumsqv, -(sumv * sumv)).abs()
    hvwt_area = hcdvar_a / (vcdvar_a + hcdvar_a)
    nyqc = _cells(nmf, rbmask) > 0
    hvwt = torch.where(nyqc, _cells(torch.where(nm, hvwt_area, 0.0), rbmask), hvwt)

    # ---- hvwt refinement + populate G (amaze:1050-1075)
    hvwt = passes["refine"](hvwt)
    Dgrb0 = _cells(torch.where(rbmask, fma(hcd, 1.0 - hvwt, vcd * hvwt), 0.0), rbmask)
    rgbgreen = torch.where(rbmask, cfa + Dgrb0, cfa)
    curv_h = sq(rgbgreen - 0.5 * (s(rgbgreen, 0, -1) + s(rgbgreen, 0, 1)))
    curv_v = sq(rgbgreen - 0.5 * (s(rgbgreen, -1, 0) + s(rgbgreen, 1, 0)))
    Dgrb2h = torch.where(nyqc, _cells(torch.where(nm, curv_h, 0.0), rbmask), 0.0)
    Dgrb2v = torch.where(nyqc, _cells(torch.where(nm, curv_v, 0.0), rbmask), 0.0)

    # ---- Nyquist refinement via G curvature (amaze:1085-1102)
    def gquinc(D):
        return EPSSQ + _wsum(GQUINC, D, [DIAG1, AXIS2, DIAG2], fuse_first=False)

    gvarh, gvarv = gquinc(Dgrb2h), gquinc(Dgrb2v)
    refined = fma(hcd, gvarv, vcd * gvarh) / (gvarv + gvarh)
    Dgrb0 = torch.where(nyqc & rbmask, _cells(torch.where(nm, refined, 0.0), rbmask), Dgrb0)
    rgbgreen = torch.where(rbmask, cfa + Dgrb0, rgbgreen)

    # ---- diagonal interpolation (amaze:1183-1256)
    cm1, cm2 = s(cfa, 1, 1), s(cfa, 2, 2)
    cm1n, cm2n = s(cfa, -1, -1), s(cfa, -2, -2)
    cp1, cp2 = s(cfa, -1, 1), s(cfa, -2, 2)
    cp1n, cp2n = s(cfa, 1, -1), s(cfa, 2, -2)

    def diag_est(c1, c2):
        crv = 2.0 * c1 / (EPS + cfa + c2)
        return torch.where((1.0 - crv).abs() < ARTHRESH, cfa * crv, c1 + 0.5 * (cfa - c2))

    rbse, rbnw = diag_est(cm1, cm2), diag_est(cm1n, cm2n)
    rbne, rbsw = diag_est(cp1, cp2), diag_est(cp1n, cp2n)

    wtse = EPS + delm + s(delm, 1, 1) + s(delm, 2, 2)
    wtnw = EPS + delm + s(delm, -1, -1) + s(delm, -2, -2)
    wtne = EPS + delp + s(delp, -1, 1) + s(delp, -2, 2)
    wtsw = EPS + delp + s(delp, 1, -1) + s(delp, 2, -2)

    rbm_ = fma(wtse, rbnw, wtnw * rbse) / (wtse + wtnw)
    rbp_ = fma(wtne, rbsw, wtsw * rbne) / (wtne + wtsw)

    GE_NEAR = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    GE_FAR = [(-2, -2), (-2, 0), (-1, -1), (-1, 1), (1, -1), (1, 1), (2, -2), (2, 0)]
    rbvarm = EPSSQ + fma(GAUSSEVEN[0], _ring(dgsqm, GE_NEAR), GAUSSEVEN[1] * _ring(dgsqm, GE_FAR))
    rbvarp = EPSSQ + fma(GAUSSEVEN[0], _ring(dgsqp, GE_NEAR), GAUSSEVEN[1] * _ring(dgsqp, GE_FAR))
    pmwt_site = rbvarm / (rbvarp + rbvarm)

    # bound rbp/rbm (amaze:1231-1249)
    def bound_diag(v, lo, hi):
        wt = 2.0 * (cfa - v) / (EPS + v + cfa)
        vb = _ulim(v, lo, hi)
        return torch.where(v < cfa, torch.where(2.0 * v < cfa, vb, fma(wt, v, (1.0 - wt) * vb)), v)

    rbp_ = bound_diag(rbp_, cp1n, cp1)
    rbm_ = bound_diag(rbm_, cm1n, cm1)
    rbp_ = torch.where(rbp_ > CLIP_PT, _ulim(rbp_, cp1n, cp1), rbp_)
    rbm_ = torch.where(rbm_ > CLIP_PT, _ulim(rbm_, cm1n, cm1), rbm_)

    rbp = _cells(torch.where(rbmask, rbp_, 0.0), rbmask)
    rbm = _cells(torch.where(rbmask, rbm_, 0.0), rbmask)
    pmwt = _cells(torch.where(rbmask, pmwt_site, 0.0), rbmask)

    # pmwt refinement + rbint (amaze:1277-1284)
    pmwt = passes["refine"](pmwt).contiguous()  # a full plane, as evmath.fma's kernel takes it
    rbint = _cells(torch.where(rbmask, 0.5 * fma(rbp, pmwt, fma(rbm, 1.0 - pmwt, cfa)), 0.0), rbmask)

    # ---- G correction via R+B (amaze:1287-1352)
    def g_est(c, dy, dx):
        far = s(rbint, dy, dx)
        crv = c * 2.0 / (EPS + rbint + far)
        return torch.where((1.0 - crv).abs() < ARTHRESH, rbint * crv, c + 0.5 * (rbint - far))

    gu, gd = g_est(cu, -2, 0), g_est(cd, 2, 0)
    gl, gr = g_est(cl, 0, -2), g_est(cr_, 0, 2)

    Gintv2 = fma(s(dirwts0, -1, 0), gd, s(dirwts0, 1, 0) * gu) / (s(dirwts0, 1, 0) + s(dirwts0, -1, 0))
    Ginth2 = fma(s(dirwts1, 0, -1), gr, s(dirwts1, 0, 1) * gl) / (s(dirwts1, 0, -1) + s(dirwts1, 0, 1))

    def bound_g(G, lo, hi):
        wt = 2.0 * (rbint - G) / (EPS + G + rbint)
        Gb = _ulim(G, lo, hi)
        return torch.where(G < rbint, torch.where(2.0 * G < rbint, Gb, fma(wt, G, (1.0 - wt) * Gb)), G)

    Gintv2 = bound_g(Gintv2, cu, cd)
    Ginth2 = bound_g(Ginth2, cl, cr_)
    Ginth2 = torch.where(Ginth2 > CLIP_PT, _ulim(Ginth2, cl, cr_), Ginth2)
    Gintv2 = torch.where(Gintv2 > CLIP_PT, _ulim(Gintv2, cu, cd), Gintv2)

    use_diag = (0.5 - pmwt).abs() >= (0.5 - hvwt).abs()
    g_diag = fma(Ginth2, 1.0 - hvwt, Gintv2 * hvwt)
    rgbgreen = torch.where(rbmask & use_diag, g_diag, rgbgreen)
    Dgrb0_site = torch.where(use_diag, g_diag - cfa, Dgrb0)
    Dgrb0 = _cells(torch.where(rbmask, Dgrb0_site, 0.0), rbmask)

    # ---- chrominance smoothing (amaze:1358-1398): B cells (odd rows) carry
    # G-B in plane 1, R cells G-R in plane 0
    bcell = (yy % 2 == 1).expand(hp, wp)
    Dgrb1 = torch.where(bcell, Dgrb0, 0.0)
    Dgrb0 = torch.where(bcell, 0.0, Dgrb0)
    Dgrb0 = passes["chroma"](Dgrb0, 1)
    Dgrb1 = passes["chroma"](Dgrb1, 0)

    # ---- output (amaze:1401-1468)
    hv_u, hv_d = s(hvwt, -1, 0), s(hvwt, 1, 0)
    hv_l, hv_r = s(hvwt, 0, -1), s(hvwt, 0, 1)
    wsum = hv_u + (1.0 - hv_r) + (1.0 - hv_l) + hv_d

    def chroma_at_green(D):
        acc = fma(hv_d, s(D, 1, 0), fma(1.0 - hv_l, s(D, 0, -1),
                                        fma(hv_u, s(D, -1, 0), (1.0 - hv_r) * s(D, 0, 1))))
        return acc / wsum

    red = torch.where(green, rgbgreen - chroma_at_green(Dgrb0), rgbgreen - Dgrb0) * 65535.0
    blue = torch.where(green, rgbgreen - chroma_at_green(Dgrb1), rgbgreen - Dgrb1) * 65535.0
    return red, rgbgreen * 65535.0, blue


PLAIN_PASSES = {"refine": refine_plain, "dilate": dilate_plain, "chroma": chroma_plain}


def amaze_demosaic_plain(raw):
    """Plain twin of the kernels: (B, H, W) float32 RGGB mosaics on the
    0..65535 scale → (R, G, B) planes, each (B, H, W) float32. Runs on any
    device; amaze_demosaic uses it for CPU tensors, and the GPU smoke test
    holds the kernels against it on the card."""
    _check(raw)
    h, w = raw.shape[-2:]
    planes = _stencil_stages_plain(pad_mosaic(raw), PLAIN_PASSES)
    return tuple(p[..., PAD : PAD + h, PAD : PAD + w].contiguous() for p in planes)


def pallas_mode() -> str:
    """``split`` or ``mega``, from ``MLVFS_AMAZE_PALLAS_MODE`` read at each
    call: unset or ``split`` is split, any other value mega, as the
    reference reads it (``amaze_pallas.py:743,758``)."""
    return "split" if os.environ.get(MODE_ENV, "split") == "split" else "mega"


@metrics.traced("amaze", metrics.DEVICE)
def amaze_demosaic(raw):
    """Demosaic a batch (B, H, W) float32 RGGB mosaics (0..65535 scale) →
    (R, G, B), each (B, H, W) float32.

    CPU tensor: the plain twin, whatever the mode (the reference's CPU path
    is its XLA form in either). CUDA tensor: in split mode kernel #8's
    stencil stages with kernel #10's raster passes between them, in mega
    mode kernel #9. Anything else raises."""
    if raw.device.type == "cpu":
        return amaze_demosaic_plain(raw)
    if raw.device.type == "cuda":
        return _amaze_demosaic_cuda(raw) if pallas_mode() == "split" else _amaze_demosaic_mega_cuda(raw)
    raise ValueError(f"amaze_demosaic: unsupported device {raw.device}")


# The planes the stencil stages read and write, in the order of enum Plane
# (csrc/amaze_stages.cuh): every intermediate of the stages
PLANES = (
    "cfa", "dirwts0", "dirwts1", "delhvsqsum", "delp", "delm", "dgsqp", "dgsqm",
    "hcd0", "vcd0", "hcdalt", "vcdalt", "dgintv", "dginth", "hcd", "vcd",
    "hvwt0", "nyq0", "nyq", "hvwt1", "hvwt", "dgrb0a", "dgrb2h", "dgrb2v", "dgrb0b", "rgbgreen",
    "pmwt0", "rbp", "rbm", "pmwt", "rbint", "rgbgreen2", "d0", "d1", "d0s", "d1s",
)
# Workspace planes of the CUDA kernels #8 and #9, in the order of enum
# SplitSlot (csrc/amaze_stages.cuh): only those that cross a stage group;
# the rest live in shared memory or are recomputed (csrc/amaze_tiles.cuh)
SPLIT_PLANES = (
    "cfa", "hcd", "vcd", "hvwt0", "nyq0", "nyq", "hvwt1", "hvwt", "dgrb0b",
    "rbp", "rbm", "pmwt0", "pmwt", "rgbgreen2", "d0", "d1", "d0s", "d1s",
)
INT_PLANES = ("nyq0", "nyq")  # int32 planes in the float32 workspace


def _outputs_and_workspace(raw, planes):
    """The checked batch's (R, G, B) outputs and, for a non-empty batch, the
    workspace of ``planes`` of the CUDA kernels (None for an empty one)."""
    _check(raw)
    b, h, w = raw.shape
    if b > 65535:
        raise ValueError(f"amaze kernel takes at most 65535 frames per batch, got {b}")
    outs = [torch.empty((b, h, w), dtype=torch.float32, device=raw.device) for _ in range(3)]
    if b == 0:
        return outs, None
    ws = torch.empty((len(planes), b, h + 2 * PAD, w + 2 * PAD), dtype=torch.float32, device=raw.device)
    return outs, ws


def _amaze_demosaic_cuda(raw):
    global KERNEL_LAUNCHES
    from . import amaze_scans

    outs, ws = _outputs_and_workspace(raw, SPLIT_PLANES)
    if ws is None:
        return tuple(outs)
    b, hp, wp = ws.shape[1:]
    plane = {name: ws[i] for i, name in enumerate(SPLIT_PLANES)}
    for name in INT_PLANES:
        plane[name] = plane[name].view(torch.int32)
    plane["cfa"].copy_(pad_mosaic(raw))
    lib = _build.library("amaze")

    def stage(k):
        with torch.cuda.device(raw.device):
            stream = torch.cuda.current_stream(raw.device).cuda_stream
            rc = lib.mlvfs_amaze_stage(k, ws.data_ptr(), *(o.data_ptr() for o in outs), b, hp, wp, stream)
        if rc != 0:
            raise RuntimeError(f"amaze kernel stage group {k} launch failed (cudaError {rc})")

    # the stage groups of csrc/amaze.cu, one launch each, with the raster
    # passes between them
    stage(1)  # gradients, cardinal interpolation, selection, hvwt, Nyquist test
    amaze_scans.dilate(plane["nyq0"], out=plane["nyq"])
    stage(2)  # area interpolation in Nyquist regions
    amaze_scans.refine(plane["hvwt1"], out=plane["hvwt"])
    stage(3)  # populate G, Nyquist refinement, diagonal interpolation
    amaze_scans.refine(plane["pmwt0"], out=plane["pmwt"])
    stage(4)  # rbint, G correction, the two chroma planes
    amaze_scans.chroma(plane["d0"], 1, out=plane["d0s"])
    amaze_scans.chroma(plane["d1"], 0, out=plane["d1s"])
    stage(5)  # output
    KERNEL_LAUNCHES += 1
    return tuple(outs)


# kernel #9's steps, in its order (csrc/amaze_mega.cu): the times of
# amaze_demosaic_mega_steps
MEGA_STEPS = ("pad", "group 1", "dilate nyq0", "group 2", "refine hvwt1", "group 3", "refine pmwt0",
              "group 4", "chroma d0 d1", "group 5")


def _amaze_demosaic_mega_cuda(raw, stamps=None):
    """Kernel #9: the whole demosaic in one cooperative launch, which reads
    the mosaics and pads them itself and, given an int64 device tensor
    ``stamps`` of len(MEGA_STEPS) + 1, writes its step stamps there. A
    launch the card refuses raises with its CUDA error; nothing falls back
    to the split kernels or the twin."""
    global MEGA_LAUNCHES

    outs, ws = _outputs_and_workspace(raw, SPLIT_PLANES)
    if ws is None:
        return tuple(outs)
    raw = raw.contiguous()
    b, h, w = raw.shape
    lib = _build.library("amaze_mega")
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = lib.mlvfs_amaze_mega(raw.data_ptr(), ws.data_ptr(), *(o.data_ptr() for o in outs), b, h, w,
                                  n_tiles(h + 2 * PAD), INV_65535,
                                  None if stamps is None else stamps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"amaze mega kernel launch failed (cudaError {rc})")
    MEGA_LAUNCHES += 1
    return tuple(outs)


def mega_plan(h: int, w: int) -> dict:
    """How kernel #9 launches on the current card for (h, w) frames: block
    size, blocks an SM, SMs, dynamic shared memory bytes, and whether refine
    and dilate take their rings (else their row walks)."""
    out = (ctypes.c_longlong * 6)()
    rc = _build.library("amaze_mega").mlvfs_amaze_mega_plan(h, w, out)
    if rc != 0:
        raise RuntimeError(f"amaze mega kernel cannot launch {h}x{w} (cudaError {rc})")
    keys = ("threads", "blocks_per_sm", "sms", "smem_bytes", "refine_ring", "dilate_ring")
    return dict(zip(keys, out))


def amaze_demosaic_mega_steps(raw):
    """Kernel #9 on a CUDA batch with its step stamps: ((R, G, B), {step of
    MEGA_STEPS: ms}), each step's time up to the grid sync after it, read
    from block 0's %globaltimer."""
    stamps = torch.zeros(len(MEGA_STEPS) + 1, dtype=torch.int64, device=raw.device)
    outs = _amaze_demosaic_mega_cuda(raw, stamps)
    ns = stamps.cpu().tolist()
    return outs, {name: (ns[k + 1] - ns[k]) / 1e6 for k, name in enumerate(MEGA_STEPS)}
