"""Numpy models of the hand-written designs of kernels #6, #7, #10, #5, #2
and #1, held bit for bit to the port's plain twins on the CPU.

A CUDA kernel cannot run here, so the arithmetic and bookkeeping of each
design are modelled step for step as the sources run them, and compared
with the unchanged twins:

* #6, ``csrc/amaze_edge.cu``: tiles of 8 rows x 128 columns; per tile the
  scored pixels (inside the window, not restricted), the rows that hold
  one, and one of two forms: the rows form (each active row's tap
  differences D_d once per column, the 11-wide box as a running sum over
  runs of 4 columns) or the direct form (each scored pixel's 12 x 11
  columns summed on their own), picked per tile by the count of scored
  pixels against ``per_row`` times the active rows;
* #7, ``csrc/alias.cu``: tiles of 64 x 64; a tile without a selected pixel
  writes the capped cell max of alias; otherwise pairs of aux pixels two
  rows apart share the top 6 of their 30 common diamond taps (sorted row
  runs merged by bitonic steps), and each pixel of the pair finishes with
  its own 7 taps.

* #10, ``csrc/amaze_passes.cuh`` refine_ring / dilate_ring: per tile the
  source rows stream through a ring (6 rows for refine, 8 for dilate),
  each slot checked to hold the row a step reads; dilate holds rows as
  words of 32 cells, counts each cell's neighbours bit-sliced and
  composes each row's chain in one warp (a word a lane, its bits by
  doubling, a shuffle scan over the lanes; wider rows take the row walk
  of kernel #9); its chroma pass stages blocks of 32 rows x 256 lanes with their
  three-row and three-lane surround in shared memory;
* #5, ``csrc/dualiso_preview.cu``: the rows stream through a ring of 5
  chunks of 32 rows, and the even and odd rows of a column are two chains.
* #2, ``csrc/chroma.cu``: tiles of 64 x 32 cells with their apron, the
  raw->EV table staged below 16,384, a thread walking 8 cells down a column
  with a ring of rows sorted once, the median selected from the sorted rows
  (the networks read from the source and proven bit-sliced by the 0-1
  principle), EV->raw from the packed octave;
* #1, ``csrc/unpack.cu``: groups of 8 pixel blocks staged a warp at a time
  through shared memory by vectors as wide as each frame's bases allow,
  word pairs by byte permutes, rotated output vectors, the plain formula
  after the last whole group.

#6 and #7 are exact whatever the ties: integer sums wrap as the twins'
int32 does, and the 6th largest of a multiset is a value. #10's
composition is exact in any grouping, since composing functions is
associative.
"""

import itertools
import math
import os
import re

import numpy as np
import pytest
import torch

from mlvfs_tpu_torch import _build
from mlvfs_tpu_torch.ops import alias as alias_ops
from mlvfs_tpu_torch.ops import amaze_core, amaze_edge, dualiso
from mlvfs_tpu_torch.ops import chroma_smooth as chroma_ops
from mlvfs_tpu_torch.ops import unpack as unpack_ops
from mlvfs_tpu_torch.ops.luts import ev2raw_lut, raw2ev_lut

I32_MIN = np.int32(np.iinfo(np.int32).min)

# ---------------------------------------------------------------- kernel #6

TR, TW = 8, 128             # tile rows and columns
HALO = 14                   # gray columns held either side
DC = TW + 10                # tap-difference columns: x0-5 .. x0+TW+4
RUN = 4                     # output columns a thread slides the box over
ND, DIR0 = 12, 6
TAP_DX = [[dx for dx, _ in taps] for taps in amaze_edge.EDGE_DIRECTIONS]
DIRECT_PER_ROW = amaze_edge.DIRECT_PER_ROW  # the wrapper's default form threshold


def _edge_tile_rows(sv, y0):
    """Gray-row offsets (into rows y0-3 .. y0+TR+2) of the four row
    classes of each tile row, from the row signs ``sv``."""
    out = []
    for r in range(TR):
        y, s = y0 + r, int(sv[r])
        ys = (y + 2 if s == 1 else y - 2, y + 1 if s == 1 else y - 1,
              y + 2 if s == -1 else y - 2, y + 3 if s == -1 else y - 3)
        out.append([yy - (y0 - 3) for yy in ys])
    return out


def _tap_diff(g, rows, cols, d):
    """D_d = |p1 - p2| + |p2 - p3| + |p3 - p4| (int32, wrapping) at gray
    columns ``cols`` (indices into the held gray rows, before the taps'
    offsets), on the gray rows ``rows[k]`` of the four row classes."""
    p = [g[rows[k], cols + TAP_DX[d][k]] for k in range(4)]
    with np.errstate(over="ignore"):
        return np.abs(p[0] - p[1]) + np.abs(p[1] - p[2]) + np.abs(p[2] - p[3])


def edge_model(evgray, ewa, ewb, s, restricted, per_row=DIRECT_PER_ROW, stats=None):
    """The picked EV-index planes, computed as csrc/amaze_edge.cu does."""
    b, h, w = evgray.shape
    out = np.zeros((b, h, w), np.int32)
    for f, y0, x0 in itertools.product(range(b), range(0, h, TR), range(0, w, TW)):
        g = np.zeros((TR + 6, TW + 2 * HALO), np.int32)  # rows y0-3.., columns x0-HALO..
        ys, xs = np.arange(y0 - 3, y0 + TR + 3), np.arange(x0 - HALO, x0 + TW + HALO)
        iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
        g[np.ix_(iy, ix)] = evgray[f][np.ix_(ys[iy], xs[ix])]
        sv = np.zeros(TR, np.int32)
        sv[: min(TR, h - y0)] = s[f, y0 : y0 + TR]
        rows = _edge_tile_rows(sv, y0)
        ty, tx = np.arange(y0, y0 + TR)[:, None], np.arange(x0, x0 + TW)[None, :]
        inside = (ty < h) & (tx < w)
        window = (ty >= 5) & (ty < h - 5) & (tx >= 5) & (tx < w - 5)
        rmap = np.ones((TR, TW), bool)
        rmap[: min(TR, h - y0), : min(TW, w - x0)] = restricted[f, y0 : y0 + TR, x0 : x0 + TW]
        scored = inside & window & ~rmap
        n = int(scored.sum())
        active = [r for r in range(TR) if scored[r].any()]
        dirs = np.full((TR, TW), DIR0, np.int32)
        form = "none" if n == 0 else ("direct" if n <= per_row * len(active) else "rows")
        if stats is not None:
            stats[form] = stats.get(form, 0) + 1
        if form == "rows":
            for r in active:
                # D_d once per column c (gray column c + HALO - 5), then the
                # box of output column j = D[j .. j+10] slid along runs of 4
                cols = np.arange(DC) + HALO - 5
                best = dbest = None
                t = np.arange(TW // RUN) * RUN
                for d in range(ND):
                    D = _tap_diff(g, rows[r], cols, d)
                    with np.errstate(over="ignore"):
                        box = [np.int32(abs(d - DIR0) * 4096) + sum(D[t + k] for k in range(11))]
                        for k in range(1, RUN):
                            box.append(box[-1] + D[t + k + 10] - D[t + k - 1])
                    score = np.stack(box, 1).reshape(TW)
                    if d == 0:
                        best, dbest = score, np.zeros(TW, np.int32)
                    else:
                        take = score < best
                        best, dbest = np.where(take, score, best), np.where(take, d, dbest)
                dirs[r] = np.where(scored[r], dbest, DIR0)
        elif form == "direct":
            rr, cc = np.nonzero(scored)
            prow = np.array(rows)[rr].T  # (4, n): each pixel's gray rows
            best = dbest = None
            for d in range(ND):
                score = np.full(len(rr), abs(d - DIR0) * 4096, np.int32)
                for j in range(-5, 6):
                    with np.errstate(over="ignore"):
                        score = score + _tap_diff(g, prow, cc + j + HALO, d)
                if d == 0:
                    best, dbest = score, np.zeros(len(rr), np.int32)
                else:
                    take = score < best
                    best, dbest = np.where(take, score, best), np.where(take, d, dbest)
            dirs[rr, cc] = dbest
        # the picked value from the tile's EW_a / EW_b rows
        ea = np.zeros((TR, TW + 16), np.int32)  # columns x0-8 ..
        eb = np.zeros((TR, TW + 16), np.int32)
        xe = np.arange(x0 - 8, x0 + TW + 8)
        ie = (xe >= 0) & (xe < w)
        nr = min(TR, h - y0)
        ea[:nr][:, ie] = ewa[f, y0 : y0 + nr][:, xe[ie]]
        eb[:nr][:, ie] = ewb[f, y0 : y0 + nr][:, xe[ie]]
        cidx = np.arange(TW)[None, :] + 8
        ridx = np.arange(TR)[:, None]

        def val(dd):
            a = np.take(np.array(TAP_DX)[:, 1], dd)
            bb = np.take(np.array(TAP_DX)[:, 2], dd)
            with np.errstate(over="ignore"):
                v = ea[ridx, cidx + a] * 2 + eb[ridx, cidx + bb]
            return _tdiv(v, 3)

        with np.errstate(over="ignore"):
            o = _tdiv(2 * val(dirs) + val(np.minimum(dirs + 1, ND - 1)) + val(np.maximum(dirs - 1, 0)), 4)
        out[f, y0 : y0 + nr, x0 : x0 + TW][:, : min(TW, w - x0)] = o[:nr, : min(TW, w - x0)]
    return out


def _tdiv(a, d):
    """C division of int32 arrays (truncating toward zero)."""
    q = np.abs(a.astype(np.int64)) // d
    return np.where(a < 0, -q, q).astype(np.int32)


def _edge_inputs(rng, b, h, w, density, flat=False):
    ev = lambda: rng.integers(-2 * 32768, 14 * 32768, (b, h, w), dtype=np.int32)  # noqa: E731
    evgray, ewa, ewb = ev(), ev(), ev()
    if flat:
        evgray[:] = 5 * 32768  # every direction ties but for its penalty
        ewa[:, :, ::3] = ewa[:, :, :1]
    else:
        evgray[:, h // 3 :, : w // 2] //= 64
    ys = np.arange(h)
    s = np.stack([np.where((((ys - i) % 4) >= 2) == (((ys + 1 - i) % 4) >= 2), -1, 1)
                  for i in range(b)]).astype(np.int32)
    restricted = rng.random((b, h, w)) < density
    return evgray, ewa, ewb, s, restricted


def _edge_twin(args):
    return amaze_edge.edge_pick_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()


@pytest.mark.parametrize("b, h, w, density, per_row", [
    (2, 37, 300, 0.5, DIRECT_PER_ROW),  # rows form, odd height, three tiles across
    (1, 21, 270, 0.96, DIRECT_PER_ROW),  # the main path's sparse scoring: direct form
    (1, 19, 140, 0.5, 0),               # rows form forced
    (1, 19, 140, 0.5, TW),              # direct form forced
    (2, 11, 12, 0.0, DIRECT_PER_ROW),   # narrower than a tile, one scored row
    (1, 5, 7, 0.0, DIRECT_PER_ROW),     # no window: nothing scored
])
def test_edge_model_matches_twin(b, h, w, density, per_row):
    """Kernel #6's tiles, row classes, per-column tap differences, running
    box sums and both scoring forms pick exactly the twin's values."""
    rng = np.random.default_rng(h * w + b)
    args = _edge_inputs(rng, b, h, w, density)
    stats = {}
    np.testing.assert_array_equal(edge_model(*args, per_row=per_row, stats=stats), _edge_twin(args))
    if per_row == 0 and h > 10:
        assert stats.get("rows") and not stats.get("direct")
    if per_row == TW and h > 10:
        assert stats.get("direct") and not stats.get("rows")


@pytest.mark.parametrize("case", ["flat", "all_restricted", "one_pixel", "block"])
def test_edge_model_ties_and_work_layouts(case):
    """Flat planes (every direction ties but for its penalty), every pixel
    restricted, one scored pixel at a tile's corner, and a block of scored
    pixels with whole tiles and rows without work; both forms."""
    rng = np.random.default_rng(len(case))
    b, h, w = 1, 26, 270
    evgray, ewa, ewb, s, restricted = _edge_inputs(rng, b, h, w, 0.0, flat=case == "flat")
    if case == "all_restricted":
        restricted[:] = True
    elif case == "one_pixel":
        restricted[:] = True
        restricted[0, 8, 128] = False  # the first pixel of the second tile down and across
    elif case == "block":
        restricted[:] = True
        restricted[0, 9:14, 20:60] = False
    args = (evgray, ewa, ewb, s, restricted)
    want = _edge_twin(args)
    for per_row in (0, TW):
        np.testing.assert_array_equal(edge_model(*args, per_row=per_row), want, err_msg=f"{case} {per_row}")


# ---------------------------------------------------------------- kernel #7

ATH, ATW = 64, 64           # output tile rows and columns
R = 6                       # radius of the diamond and of the blur
XH, XW = ATH + 2 * R, ATW + 2 * R  # the aux area: tile + 6 each side
S3 = [(0, 1), (1, 2), (0, 1)]
S5 = [(0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2)]
S7 = [(0, 6), (2, 3), (4, 5), (0, 2), (1, 4), (3, 6), (0, 1), (2, 5), (3, 4), (1, 2), (4, 6), (2, 3),
      (4, 5), (1, 2), (3, 4), (5, 6)]


def _sort(v, net):
    """Descending, by compare-exchanges (max to the lower index)."""
    v = list(v)
    for i, j in net:
        v[i], v[j] = np.maximum(v[i], v[j]), np.minimum(v[i], v[j])
    return v


def _merge6(a, b):
    """The top 6, descending, of two descending lists of at most 6 with at
    least 6 between them: c_i = max(a_i, b_{7-i}) over the lists padded to
    8 with INT32_MIN is bitonic and holds the top 8; three bitonic steps
    sort it (those that only feed positions 6 and 7 dropped)."""
    pad = lambda v, i: v[i] if i < len(v) else I32_MIN  # noqa: E731
    c = [np.maximum(pad(a, i), pad(b, 7 - i)) for i in range(8)]
    for i, j in ((0, 4), (1, 5), (2, 6), (3, 7), (0, 2), (1, 3)):
        c[i], c[j] = np.maximum(c[i], c[j]), np.minimum(c[i], c[j])
    c[4], c[5] = np.maximum(c[4], c[6]), np.maximum(c[5], c[7])
    for i, j in ((0, 1), (2, 3), (4, 5)):
        c[i], c[j] = np.maximum(c[i], c[j]), np.minimum(c[i], c[j])
    return c[:6]


def _kth6(x, y):
    """The 6th largest of the union of two descending lists of 6."""
    return np.minimum.reduce([np.maximum(x[i], y[5 - i]) for i in range(6)])


def aux_pairs(A, cy, cx):
    """The 6th largest of the diamonds centred at (cy, cx) and (cy + 2, cx)
    of the padded alias plane A, by the kernel's shared selection."""
    tap = lambda dy, dx: A[cy + dy, cx + dx]  # noqa: E731
    run = lambda dy, k: [tap(dy, 2 * j) for j in range(-k, k + 1)]  # noqa: E731
    common = _merge6(_merge6(_merge6(_sort(run(-4, 1), S3), _sort(run(-2, 2), S5)),
                             _merge6(_sort(run(0, 3), S7)[:6], _sort(run(2, 3), S7)[:6])),
                     _merge6(_sort(run(4, 2), S5), _sort(run(6, 1), S3)))
    up = run(-6, 1) + [tap(-4, -4), tap(-4, 4), tap(-2, -6), tap(-2, 6)]
    down = run(8, 1) + [tap(6, -4), tap(6, 4), tap(4, -6), tap(4, 6)]
    return _kth6(common, _sort(up, S7)[:6]), _kth6(common, _sort(down, S7)[:6])


def _blur(aux, yy, xx):
    """The integer gaussian of csrc/alias.cu at aux-plane positions (yy,
    xx): the 20 distinct taps summed per group, each group's product
    floor-divided by 1024 (int32 wrapping)."""
    t = lambda dy, dx: aux[yy + dy, xx + dx].astype(np.int64)  # noqa: E731
    g4 = t(-2, 0) + t(0, -2) + t(0, 2) + t(2, 0)
    gd = t(-2, -2) + t(-2, 2) + t(2, -2) + t(2, 2)
    g6 = t(-6, 0) + t(0, -6) + t(0, 6) + t(6, 0)
    gk = t(-6, -2) + t(-6, 2) + t(-2, -6) + t(-2, 6) + t(2, -6) + t(2, 6) + t(6, -2) + t(6, 2)
    wrap = lambda v: ((v + (1 << 31)) % (1 << 32) - (1 << 31))  # noqa: E731
    acc = aux[yy, xx].astype(np.int64)
    for g, wt in ((g4, 820), (gd, 657), (g4, 421), (2 * gd, 337), (gd, 173), (g6, 139), (gk, 111),
                  (gk, 57)):
        acc += wrap(wrap(g) * wt) >> 10
    return wrap(acc).astype(np.int32)


def alias_model(alias, skip, stats=None):
    """The filter chain of csrc/alias.cu, tile by tile."""
    b, h, w = alias.shape
    out = np.zeros_like(alias)
    ny, nx = alias_ops.cell_grid(h, w)
    for f, y0, x0 in itertools.product(range(b), range(0, h, ATH), range(0, w, ATW)):
        ys, xs = np.arange(y0 - R, y0 + ATH + R), np.arange(x0 - R, x0 + ATW + R)
        inner = ((ys >= 6) & (ys < h - 6))[:, None] & ((xs >= 6) & (xs < w - 6))[None, :]
        sk = np.ones((XH, XW), bool)
        iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
        sk[np.ix_(iy, ix)] = skip[f][np.ix_(ys[iy], xs[ix])]
        sel = inner & ~sk
        # the alias plane over the aux area plus the diamond's reach
        A = np.zeros((XH + 2 * R, XW + 2 * R), np.int32)
        ay, ax = np.arange(y0 - 2 * R, y0 + ATH + 2 * R), np.arange(x0 - 2 * R, x0 + ATW + 2 * R)
        jy, jx = (ay >= 0) & (ay < h), (ax >= 0) & (ax < w)
        A[np.ix_(jy, jx)] = alias[f][np.ix_(ay[jy], ax[jx])]
        tile = A[2 * R : 2 * R + ATH, 2 * R : 2 * R + ATW].copy()  # the blur's buffer
        if not sel[R : R + ATH, R : R + ATW].any():
            if stats is not None:
                stats["skipped"] = stats.get("skipped", 0) + 1
        else:
            aux = A[R : R + XH, R : R + XW].copy()
            # pairs (r, r + 2) of aux rows, r = 4k or 4k + 1, one per column
            pr = np.array([r for r in range(XH) if r % 4 < 2])
            rr, cc = np.meshgrid(pr, np.arange(XW), indexing="ij")
            need = sel[rr, cc] | sel[rr + 2, cc]
            rr, cc = rr[need], cc[need]
            if stats is not None:
                stats["pairs"] = stats.get("pairs", 0) + len(rr)
            k0, k1 = aux_pairs(A, rr + R, cc + R)
            aux[rr, cc] = np.where(sel[rr, cc], k0, aux[rr, cc])
            aux[rr + 2, cc] = np.where(sel[rr + 2, cc], k1, aux[rr + 2, cc])
            ty, tx = np.mgrid[0:ATH, 0:ATW]
            tsel = sel[R : R + ATH, R : R + ATW]
            tile = np.where(tsel, _blur(aux, ty + R, tx + R), tile)
        # the capped 2x2 cell max on the grid from (2, 2)
        gy, gx = np.arange(y0, y0 + ATH)[:, None], np.arange(x0, x0 + ATW)[None, :]
        on = (gy >= 2) & (gy < 2 + 2 * ny) & (gx >= 2) & (gx < 2 + 2 * nx)
        cy, cx = np.arange(ATH)[:, None] & ~1, np.arange(ATW)[None, :] & ~1
        cell = np.maximum(np.maximum(tile[cy, cx], tile[cy, cx + 1]),
                          np.maximum(tile[cy + 1, cx], tile[cy + 1, cx + 1]))
        o = np.where(on, np.minimum(cell, alias_ops.ALIAS_MAP_MAX), tile)
        nh, nw = min(ATH, h - y0), min(ATW, w - x0)
        out[f, y0 : y0 + nh, x0 : x0 + nw] = o[:nh, :nw]
    return out


def _alias_twin(a, skip):
    return alias_ops.alias_filter_plain(torch.from_numpy(a), torch.from_numpy(skip)).numpy()


def test_alias_networks_select_exactly():
    """The sorting networks sort every 0/1 input (so every input), and the
    pair selection gives the 6th largest of both diamonds on values with
    many ties."""
    for n, net in ((3, S3), (5, S5), (7, S7)):
        for v in itertools.product([0, 1], repeat=n):
            got = [int(x) for x in _sort([np.int32(x) for x in v], net)]
            assert got == sorted(v, reverse=True), (n, v)
    rng = np.random.default_rng(3)
    A = rng.integers(0, 4, (40, 40)).astype(np.int32)
    cy, cx = np.mgrid[12:26, 12:26]
    k0, k1 = aux_pairs(A, cy, cx)
    offs = alias_ops.FILTER_OFFS
    for y, x, v0, v1 in zip(cy.ravel(), cx.ravel(), k0.ravel(), k1.ravel()):
        assert v0 == sorted((A[y + dy, x + dx] for dx, dy in offs), reverse=True)[5]
        assert v1 == sorted((A[y + 2 + dy, x + dx] for dx, dy in offs), reverse=True)[5]


@pytest.mark.parametrize("b, h, w, density", [
    (1, 150, 140, 0.2),   # three tiles down and across, partial last ones
    (2, 77, 66, 0.9),     # the main path's sparse selection: tiles without work
    (1, 13, 13, 0.0),     # one inner pixel, narrower than a tile
    (2, 12, 31, 0.0),     # no inner pixel
    (1, 5, 9, 1.0),       # no cell grid, all skipped
])
def test_alias_model_matches_twin(b, h, w, density):
    """Kernel #7's tiles, tile skip, pair list, shared top-6 selection,
    blur and capped cell max give exactly the twin's map."""
    rng = np.random.default_rng(h * w)
    a = rng.integers(0, 65531, (b, h, w), dtype=np.int32)
    skip = rng.random((b, h, w)) < density
    stats = {}
    np.testing.assert_array_equal(alias_model(a, skip, stats), _alias_twin(a, skip))
    if density == 0.9 and h > 64:
        assert stats.get("skipped") and stats.get("pairs")


@pytest.mark.parametrize("case", ["flat", "runs", "one_corner", "none"])
def test_alias_model_ties_and_work_layouts(case):
    """Flat maps and runs of equal values (ties in every selection), one
    unskipped pixel at a tile's corner (that tile works, its neighbours
    skip), and every pixel skipped."""
    rng = np.random.default_rng(len(case))
    b, h, w = 1, 131, 140
    skip = np.zeros((b, h, w), bool)
    a = rng.integers(0, 65531, (b, h, w), dtype=np.int32)
    if case == "flat":
        a[:] = 777
    elif case == "runs":
        a = (np.arange(w)[None, None, :] // 3 % 4 * 5000 + np.arange(h)[None, :, None] // 5 % 2)
        a = np.broadcast_to(a, (b, h, w)).astype(np.int32).copy()
        skip = rng.random((b, h, w)) < 0.3
    elif case == "one_corner":
        skip[:] = True
        skip[0, 64, 64] = False
    else:
        skip[:] = True
    stats = {}
    np.testing.assert_array_equal(alias_model(a, skip, stats), _alias_twin(a, skip), err_msg=case)
    if case == "one_corner":
        assert stats["skipped"] == 8 and stats["pairs"] == 1
    if case == "none":
        assert stats["skipped"] == 9 and "pairs" not in stats


# ------------------------------------------------------------- kernel #10

TILE, STEP, APRON = 160, 128, 16
LANES = 32
REFINE_RING, DILATE_RING = 6, 8
IDENTITY = 2
# f after g for 2-bit transfer functions (f(0) | f(1) << 1)
AFTER = np.array([[((f >> (g & 1)) & 1) | (((f >> (g >> 1)) & 1) << 1) for g in range(4)]
                  for f in range(4)], np.uint8)


def _tiles(hp):
    """Per tile (y0, rlast, kept rows) of the 160/128 grid of hp rows."""
    T = amaze_core.n_tiles(hp)
    out = []
    for t in range(T):
        rlast = min(TILE - 1 if t == T - 1 else APRON + STEP - 1, hp - 1 - STEP * t)
        keep = [(r >= APRON or t == 0) and (r < APRON + STEP or t == T - 1) for r in range(rlast + 1)]
        out.append((STEP * t, rlast, keep))
    return out


class Ring:
    """A ring of ``slots`` rows filled as the kernels fill it: the rows
    0 .. ``depth`` - 2 first, then row r + ``depth`` - 1 at the top of step
    r into the slot of row r - 1, each tile row k from plane row
    (y0 + k) % hp up to row ``n_rows`` - 1. ``row(k)`` checks that the
    slot still holds row k."""

    def __init__(self, plane, y0, n_rows, slots):
        self.plane, self.y0, self.n_rows, self.slots = plane, y0, n_rows, slots
        hp, wp = plane.shape[-2:]
        self.data = np.zeros(plane.shape[:-2] + (slots, wp), plane.dtype)
        self.holds = [-1] * slots
        for k in range(slots - 1):
            self.fetch(k)

    def fetch(self, k):
        if k < self.n_rows:
            hp = self.plane.shape[-2]
            self.data[..., k % self.slots, :] = self.plane[..., (self.y0 + k) % hp, :]
            self.holds[k % self.slots] = k

    def step(self, r):
        self.fetch(r + self.slots - 1)

    def row(self, k):
        assert self.holds[k % self.slots] == k, (k, self.holds)
        return self.data[..., k % self.slots, :]


def refine_model(wt):
    """csrc/amaze_passes.cuh refine_ring on (B, hp, wp) float32: per tile
    the ring of source rows, row 0 reading itself, the updated row above
    as lanes."""
    b, hp, wp = wt.shape
    out = np.full_like(wt, np.nan)
    c = np.arange(wp // 2)
    for y0, rlast, keep in _tiles(hp):
        ring = Ring(wt, y0, rlast + 2, REFINE_RING)
        prev = None
        for r in range(rlast + 1):
            ring.step(r)
            orow, nrow = ring.row(r), ring.row(r + 1)
            prev = orow if r == 0 else prev
            xs = 2 * c + (r & 1)
            xm, xp = (xs - 1) % wp, (xs + 1) % wp
            alt = np.float32(0.25) * (((prev[:, xm] + prev[:, xp]) + nrow[:, xm]) + nrow[:, xp])
            old = orow[:, xs]
            v = np.where(np.abs(np.float32(0.5) - old) < np.abs(np.float32(0.5) - alt), alt, old)
            prev = np.repeat(v, 2, axis=1)
            if keep[r]:
                out[:, y0 + r] = prev
    return out


def _words(cells):
    """(B, ncell) 0/1 cells as (B, ceil(ncell / 32)) uint32 words, cell
    32w + j in bit j of word w, 0 past the last cell."""
    b, n = cells.shape
    pad = np.zeros((b, -(-n // 32) * 32), np.uint32)
    pad[:, :n] = cells != 0
    return np.bitwise_or.reduce(pad.reshape(b, -1, 32) << np.arange(32, dtype=np.uint32), axis=-1)


def _cells(words, ncell):
    return ((words[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(words.shape[0], -1)[:, :ncell]


def _prev_word(X, ncell):
    """Bit j of word w: cell 32w + j - 1, wrapping around the row."""
    last = (X[:, (ncell - 1) >> 5] >> np.uint32((ncell - 1) & 31)) & 1
    return (X << np.uint32(1)) | np.concatenate([last[:, None], X[:, :-1] >> np.uint32(31)], axis=1)


def _next_word(X, ncell):
    """Bit j of word w: cell 32w + j + 1, cell 0 after the last."""
    hi = np.concatenate([(X[:, 1:] & 1) << np.uint32(31), (X[:, :1] & 1) << np.uint32((ncell - 1) & 31)],
                        axis=1)
    return (X >> np.uint32(1)) | hi


def _chain_words(P0, P1, ncell):
    """One row's chain at the kernel's layout: (P0, P1) the cells' transfer
    functions (f(0), f(1)) as (B, nwords) words, a word a lane of one
    warp; each word's bits composed by doubling, a shuffle scan over the
    lanes, each word's cells applied to the value entering it. Returns the
    new cells as words."""
    b, nwords = P0.shape
    assert nwords <= LANES
    top = np.uint32(31)
    valid = np.full(nwords, 0xFFFFFFFF, np.uint32)
    valid[-1] = np.uint32(0xFFFFFFFF) >> np.uint32(31 - ((ncell - 1) & 31))
    P0, P1 = P0 & valid, P1 | ~valid
    for sh in (1, 2, 4, 8, 16):
        sh = np.uint32(sh)
        G0, G1 = P0 << sh, (P1 << sh) | ((np.uint32(1) << sh) - np.uint32(1))
        P0, P1 = (G0 & P1) | (~G0 & P0), (G1 & P1) | (~G1 & P0)
    F = np.full((b, LANES), IDENTITY, np.uint8)
    F[:, :nwords] = (P0 >> top) | ((P1 >> top) << np.uint32(1))
    lane = np.arange(LANES)
    for off in (1, 2, 4, 8, 16):
        G = np.concatenate([F[..., :off], F[..., :-off]], axis=-1)  # shfl_up: lanes < off keep theirs
        F = np.where(lane >= off, AFTER[F, G], F)
    in_fn = np.concatenate([np.full((b, 1), IDENTITY, np.uint8), F[..., :-1]], axis=-1)
    v = (in_fn[:, :nwords] & 1).astype(bool)
    return np.where(v, P1, P0) & valid


def _transfer_words(taps, ov):
    """The cells' transfer functions from their eight taps' words,
    bit-sliced: K by full adders, f(0) = K > 4 or (K == 4 and ov),
    f(1) = K > 3 or (K == 3 and ov)."""
    a1, a2, a3, a4, a5, a6, a7, a8 = taps
    x1 = a1 ^ a2
    s1, c1 = x1 ^ a3, (a1 & a2) | (a3 & x1)
    x2 = a4 ^ a5
    s2, c2 = x2 ^ a6, (a4 & a5) | (a6 & x2)
    s3, c3 = a7 ^ a8, a7 & a8
    x4 = s1 ^ s2
    b0, c4 = x4 ^ s3, (s1 & s2) | (s3 & x4)
    x5 = c1 ^ c2
    t1, d1 = x5 ^ c3, (c1 & c2) | (c3 & x5)
    b1, d2 = t1 ^ c4, t1 & c4
    b2, b3 = d1 ^ d2, d1 & d2
    ge5, ge4 = b3 | (b2 & (b1 | b0)), b3 | b2
    eq4, eq3 = b2 & ~(b1 | b0), ~(b3 | b2) & b1 & b0
    return ge5 | (eq4 & ov), ge4 | (eq3 & ov)


def dilate_model(nyq):
    """csrc/amaze_passes.cuh dilate_ring on (B, hp, wp) int32 0/1 cells:
    per tile the ring of source rows, each turned into its even and odd
    cells' words a step before its first use (rows 0 .. 2 before the
    first), the updated rows above as words, each row's cells bit-sliced
    and its chain composed in one warp (_chain_words). Planes of more than
    32 words of cells a row (wp > 2049) take dilate_tile instead."""
    b, hp, wp = nyq.shape
    ncell = wp // 2
    assert ncell <= 32 * LANES
    out = np.full_like(nyq, -1)
    for y0, rlast, keep in _tiles(hp):
        ring = Ring(nyq, y0, rlast + 3, DILATE_RING)
        bits, holds = [None] * 4, [-1] * 4

        def to_bits(k):
            if k <= rlast + 2:
                row = ring.row(k)
                bits[k & 3] = (_words(row[:, 0::2]), _words(row[:, 1::2]))
                holds[k & 3] = k

        def src(k, parity):
            assert holds[k & 3] == k, (k, holds)
            return bits[k & 3][parity]

        for k in range(3):
            to_bits(k)
        r2 = r1 = np.zeros((b, -(-ncell // 32)), np.uint32)
        for r in range(rlast + 1):
            ring.step(r)
            to_bits(r + 3)
            par = r & 1
            M0, N1, M2 = src(r, par), src(r + 1, 1 - par), src(r + 2, par)
            taps = (r2, r1 if par else _prev_word(r1, ncell), _next_word(r1, ncell) if par else r1, M0,
                    _next_word(M0, ncell), N1 if par else _prev_word(N1, ncell),
                    _next_word(N1, ncell) if par else N1, M2)
            cur = _chain_words(*_transfer_words(taps, M0), ncell)
            r2, r1 = r1, cur
            if keep[r]:
                out[:, y0 + r] = np.repeat(_cells(cur, ncell), 2, axis=1)
    return out


@pytest.mark.parametrize("b, hp, wp", [
    (1, 40, 34),      # one short tile; 17 cells: fewer than the block's threads, no multiple of 32
    (1, 4, 34),       # four rows: fewer than either ring holds
    (2, 6, 38),
    (1, 290, 50),     # three tiles, the last reading rows below it (wrap at hp)
    (2, 224, 192),    # two tiles
    (1, 170, 600),    # 300 cells: runs of 2
    (1, 290, 1952),   # the 1080p padded width: runs of 4
    (1, 40, 2048),    # the widest plane dilate_ring takes: 32 words, every lane
])
def test_raster_pass_models_match_twins(b, hp, wp):
    """Kernel #10's ring walks (refine, and dilate with the block-wide
    composition of each row's chain) give exactly the twins' planes."""
    rng = np.random.default_rng(hp + wp)
    wt = rng.random((b, hp, wp), np.float32)
    nyq = (rng.random((b, hp, wp)) > 0.6).astype(np.int32)
    np.testing.assert_array_equal(refine_model(wt), amaze_core.refine_plain(torch.from_numpy(wt)).numpy())
    np.testing.assert_array_equal(dilate_model(nyq), amaze_core.dilate_plain(torch.from_numpy(nyq)).numpy())


def test_dilate_chain_words_any_grouping():
    """The warp's grouping of a row's chain (32 cells a word composed by
    doubling, the words by a lane scan) gives the chain walked cell by
    cell, for every cell count from 1 to 300, for the widths the card runs
    and for the most cells one warp takes."""
    rng = np.random.default_rng(7)
    for n in [*range(1, 301), 952, 976, 1023, 1024]:
        f0, f1 = (rng.integers(0, 2, (3, n)) for _ in range(2))
        v = np.zeros(3, np.int64)
        want = np.zeros((3, n), np.int64)
        for i in range(n):
            v = np.where(v == 0, f0[:, i], f1[:, i])
            want[:, i] = v
        got = _cells(_chain_words(_words(f0), _words(f1), n), n)
        np.testing.assert_array_equal(got, want, err_msg=str(n))


def test_dilate_transfer_words_count_exactly():
    """The bit-sliced neighbour count gives transfer(K, ov) of the twin's
    rule for every one of the 2^9 tap patterns."""
    pats = np.array(list(itertools.product([0, 1], repeat=9)), np.uint32)  # 512 cells: 8 taps, ov
    taps = [_words(pats[None, :, i]) for i in range(8)]
    F0, F1 = _transfer_words(taps, taps[3])
    K = pats[:, :8].sum(1)
    ov = pats[:, 3]  # the cell's own original value is its fourth tap
    np.testing.assert_array_equal(_cells(F0, 512)[0], np.where(K > 4, 1, np.where(K < 4, 0, ov)))
    np.testing.assert_array_equal(_cells(F1, 512)[0], np.where(K + 1 > 4, 1, np.where(K + 1 < 4, 0, ov)))


CHROMA_ROWS, CHROMA_LANES, CHROMA_HALO = 32, 256, 3
F32 = np.float32


def _chroma_value(up1, up3, dn1, dn3):
    """The chroma value of cells from their taps, in the twin's float32
    operations and order, its products fused where it fuses them."""
    eps = F32(1.e-05)
    nm1, pp1, nm3, pp3 = up1(-1), up1(1), up3(-3), up3(3)
    om1, op1, om3, op3 = dn1(1), dn1(-1), dn3(3), dn3(-3)

    def wt(a, b, c, d, e, g):
        return F32(1) / (((eps + np.abs(a - b)) + np.abs(c - d)) + np.abs(e - g))

    wtnw, wtne = wt(nm1, om1, nm1, nm3, om1, nm3), wt(pp1, op1, pp1, pp3, op1, pp3)
    wtsw, wtse = wt(op1, pp1, op1, om3, pp1, op3), wt(om1, nm1, om1, op3, nm1, om3)

    def taps(c1, c3, a, b):
        k = lambda v: np.full_like(c1, F32(v))  # noqa: E731
        return _fma_f32(k(-0.075), b, _fma_f32(k(-0.075), a, _fma_f32(k(1.325), c1, -(F32(0.175) * c3))))

    tnw, tne = taps(nm1, nm3, up1(-3), up3(-1)), taps(pp1, pp3, up1(3), up3(1))
    tsw, tse = taps(op1, op3, dn1(-3), dn3(-1)), taps(om1, om3, dn1(3), dn3(1))
    acc = _fma_f32(wtse, tse, _fma_f32(wtsw, tsw, _fma_f32(wtnw, tnw, wtne * tne)))
    return acc / (((wtnw + wtne) + wtsw) + wtse) + F32(0)


def chroma_model(D, parity):
    """csrc/amaze_passes.cuh chroma_tile on (B, hp, wp) float32: blocks of
    CHROMA_ROWS rows x CHROMA_LANES lanes, each staged with three rows and
    lanes around (rows wrapping below the plane, lanes around it) and its
    cells computed from the stage; rows above a raster tile's top read 0."""
    b, hp, wp = D.shape
    T = amaze_core.n_tiles(hp)
    out = np.full_like(D, np.nan)
    h = CHROMA_HALO
    for Y0, X0 in itertools.product(range(0, hp, CHROMA_ROWS), range(0, wp, CHROMA_LANES)):
        ys = np.arange(Y0 - h, Y0 + CHROMA_ROWS + h)
        xs = np.arange(X0 - h, X0 + CHROMA_LANES + h) % wp
        stage = D[:, np.where(ys < 0, 0, ys % hp)][:, :, xs]
        cl = np.arange(min(CHROMA_LANES, wp - X0) // 2)
        for rr in range(min(CHROMA_ROWS, hp - Y0)):
            y, lane = Y0 + rr, 2 * cl + h
            cells = (X0 + 2 * cl)[None, :]
            if (y & 1) != parity:
                out[:, y, cells[0]], out[:, y, cells[0] + 1] = stage[:, rr + h, lane], stage[:, rr + h, lane + 1]
                continue
            t = 0 if y < APRON else min((y - APRON) // STEP, T - 1)
            r = y - STEP * t
            site, zero = lane + (y & 1), np.zeros((b, len(cl)), F32)
            v = _chroma_value(lambda dx: stage[:, rr + h - 1, site + dx] if r >= 1 else zero,
                              lambda dx: stage[:, rr + h - 3, site + dx] if r >= 3 else zero,
                              lambda dx: stage[:, rr + h + 1, site + dx],
                              lambda dx: stage[:, rr + h + 3, site + dx])
            out[:, y, cells[0]] = out[:, y, cells[0] + 1] = v
    return out


@pytest.mark.parametrize("b, hp, wp", [(1, 40, 34), (1, 4, 34), (1, 290, 50), (2, 224, 192), (1, 170, 600),
                                       (1, 36, 1952)])
def test_chroma_model_matches_twin(b, hp, wp):
    """Kernel #10's staged chroma pass (blocks of 32 rows x 256 lanes with
    their three-row and three-lane surround, wrapping) gives exactly the
    twin's plane, for both parities."""
    rng = np.random.default_rng(hp * wp)
    D = rng.normal(0, 0.1, (b, hp, wp)).astype(np.float32)
    for parity in (0, 1):
        want = amaze_core.chroma_plain(torch.from_numpy(D), parity).numpy()
        np.testing.assert_array_equal(chroma_model(D, parity), want, err_msg=str(parity))


# -------------------------------------------------------------- kernel #5

CHUNK, PREVIEW_RING = 32, 5


def _fma_f32(x, y, z):
    """x * y + z (float32) rounded once: the product is exact in float64,
    the sum's error by TwoSum decides a float64 rounding onto a float32
    midpoint (as ops/dualiso.py fma_f32)."""
    p = x.astype(np.float64) * y.astype(np.float64)
    zd = z.astype(np.float64)
    s = p + zd
    bv = s - p
    err = (p - (s - bv)) + (zd - bv)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    toward = np.nextafter(r, np.where(s > rd, np.float32(np.inf), np.float32(-np.inf)))
    tie = (s != rd) & (np.abs(s - rd) * 2 == np.abs(toward.astype(np.float64) - rd))
    beyond = (err != 0) & ((err > 0) == (s > rd))
    return np.where(tie & beyond, toward, r)


def preview_model(imgs, a, bb, shadow, drs, black, white):
    """csrc/dualiso_preview.cu on (B, H, W) u16: the rows stream through a
    ring of PREVIEW_RING chunks of CHUNK rows (chunk k + 4 fetched at the
    top of chunk k into chunk k-1's slot), and the even and the odd rows of
    each column are two chains, each carrying its own transformed row y-2
    and its row y and that row's scaling, read as row y+2 a step before."""
    b, h, w = imgs.shape
    src = imgs.astype(np.float32)
    nchunks = -(-h // CHUNK)
    ring = np.zeros((b, PREVIEW_RING, CHUNK, w), np.float32)
    holds = [-1] * PREVIEW_RING

    def fetch(k):
        if k < nchunks:
            rows = src[:, k * CHUNK : (k + 1) * CHUNK]
            ring[:, k % PREVIEW_RING, : rows.shape[1]] = rows
            holds[k % PREVIEW_RING] = k

    def at(y):
        assert holds[(y // CHUNK) % PREVIEW_RING] == y // CHUNK, (y, holds)
        return ring[:, (y // CHUNK) % PREVIEW_RING, y % CHUNK]

    f32 = np.float32
    af, bf, sf = a[:, None], bb[:, None], shadow[:, None]
    blackf, whitef = f32(black), f32(white)

    def scale(p):
        return np.minimum(whitef, _fma_f32(p - blackf, np.broadcast_to(af, p.shape),
                                           np.full(p.shape, blackf)) + bf)

    def half_sum(u, v):
        return np.trunc((u + v) / f32(2))

    out = np.zeros((b, h, w), np.uint16)
    for k in range(PREVIEW_RING - 1):
        fetch(k)
    prev2, row, srow = [None, None], [None, None], [None, None]  # each chain's carries
    for k in range(nchunks):
        fetch(k + PREVIEW_RING - 1)
        if k == 0:
            prev2 = [at(0), at(0)]
            row = [at(0), at(min(1, h - 1))]
            srow = [scale(r) for r in row]
        for p in (0, 1):
            for y in range(k * CHUNK + p, min((k + 1) * CHUNK, h), 2):
                below = at(min(y + 2, h - 1))
                sb = scale(below)
                up_ok, down_ok = y > 2, y < h - 2
                bright = (((y - drs + 4) % 4 + 4) % 4 >= 2)[:, None]
                mate = np.where(bright, below, sb)
                edge = np.where(bright, below, np.trunc(sb))
                take = np.where(bright, row[p] >= whitef, row[p] < sf)
                keep = np.where(bright, np.trunc(srow[p]), row[p])
                if up_ok:
                    repl = half_sum(prev2[p], mate) if down_ok else prev2[p]
                else:
                    repl = edge
                o = np.clip(np.where(take, repl, keep), 0, 65535).astype(f32)
                out[:, y] = (o.astype(np.uint32) << 2) & 0xFFFF
                prev2[p] = o
                row[p], srow[p] = below, sb  # row y+2 is the next step's row
    return out


@pytest.mark.parametrize("b, h, w", [
    (4, 5, 96),      # heights below one chunk
    (4, 6, 96),
    (4, 7, 300),
    (2, 70, 97),     # a height that is no multiple of the chunk, an odd width
    (2, 161, 64),    # more chunks than the ring holds
])
def test_preview_model_matches_twin(b, h, w):
    """Kernel #5's parity chains over the ring's chunks give exactly the
    twin's frames, over the four dark-row phases, with over-white and
    below-shadow pixels."""
    rng = np.random.default_rng(h * w)
    imgs = rng.integers(0, 1 << 14, (b, h, w)).astype(np.uint16)
    imgs[:, h // 4 : h // 2 + 1, : w // 3] = 15007
    imgs[:, h // 2 :, w // 2 :] = 5
    a = rng.uniform(0.05, 2.0, b).astype(np.float32)
    bb = rng.uniform(-20, 20, b).astype(np.float32)
    shadow = np.full(b, 2948.0, np.float32)
    drs = (np.arange(b) % 4).astype(np.int32)
    want = dualiso.apply_preview_plain(torch.from_numpy(imgs.view(np.int16)),
                                       *map(torch.from_numpy, (a, bb, shadow, drs)), 2048, 15000)
    np.testing.assert_array_equal(preview_model(imgs, a, bb, shadow, drs, 2048, 15000),
                                  want.numpy().view(np.uint16))


# -------------------------------------------------------------- kernel #2

CHROMA_SRC = os.path.join(_build.SRC_DIR, "chroma.cu")
EVR = 32768


def _source_int(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def chroma_networks():
    """The compare-exchange sequences csrc/chroma.cu runs, read from its
    source: {function name: ([(a, b), ...], index of the result or None)}."""
    with open(CHROMA_SRC) as f:
        src = f.read()
    nets = {}
    for name in ("median5", "sort3", "sort5", "select9", "select25"):
        body = re.search(r"\b%s\(int\* v\) \{(.*?)\n\}" % name, src, re.S).group(1)
        pairs = [(int(a), int(b)) for a, b in re.findall(r"CX\((\d+), (\d+)\)", body)]
        out = re.search(r"return v\[(\d+)\];", body)
        nets[name] = (pairs, int(out.group(1)) if out else None)
    return nets


def _bits_network(wires, pairs):
    """A compare-exchange sequence on 0/1 inputs held as bits: min is AND,
    max is OR."""
    w = list(wires)
    for a, b in pairs:
        w[a], w[b] = w[a] & w[b], w[a] | w[b]
    return w


def _row_sorted_median_network(rows, sort, select):
    """The network one cell runs, over rows x rows wires: each row sorted by
    ``sort`` (shared between the cells of a column in the kernel), then
    ``select``."""
    pairs = [(rows * r + a, rows * r + b) for r in range(rows) for a, b in sort]
    return pairs + select[0], select[1]


def _prove_median(pairs, out, n):
    """All 2^n 0-1 inputs, 64 a uint64 word a wire: output ``out`` is 1
    exactly where more than half of the n inputs are 1 (the 0-1 principle:
    then the network selects the median of any input)."""
    words = max(1, 2 ** n // 64)
    idx = np.arange(words, dtype=np.uint64)
    lanes = np.arange(64, dtype=np.uint64)
    wires = []
    for k in range(n):
        if k < 6:
            pattern = np.uint64(sum(1 << int(b) for b in lanes if (int(b) >> k) & 1))
            wires.append(np.full(words, pattern, np.uint64))
        else:
            wires.append((np.uint64(0) - ((idx >> np.uint64(k - 6)) & np.uint64(1))).astype(np.uint64))
    got = _bits_network(wires, pairs)[out]
    ones_in_word = np.array([bin(int(i)).count("1") for i in range(64)])
    high = np.array([bin(int(i)).count("1") for i in range(words)]) if n > 6 else np.zeros(words, int)
    want = np.zeros(words, np.uint64)
    for t in range(0, n - 5 if n > 6 else 1):
        mask = np.uint64(sum(1 << b for b in range(min(64, 2 ** n)) if ones_in_word[b] + t > n // 2))
        want[high == t] = mask
    if n <= 6:
        got = got & np.uint64((1 << 2 ** n) - 1 if 2 ** n < 64 else 2 ** 64 - 1)
    return np.array_equal(got, want)


def test_chroma_selection_networks_proven():
    """Every selection the kernel runs gives the median, bit-sliced over
    all 0-1 inputs: 2x2's median of 5 (2^5 inputs), 3x3's three sorted rows
    and select9 (2^9), 5x5's five sorted rows and select25 (2^25 inputs as
    2^19 words a wire). Each sort also sorts every 0-1 row."""
    nets = chroma_networks()
    assert _prove_median(*nets["median5"], 5)
    for rows, sort, select in ((3, "sort3", "select9"), (5, "sort5", "select25")):
        for v in itertools.product([0, 1], repeat=rows):
            w = list(v)
            for a, b in nets[sort][0]:
                w[a], w[b] = min(w[a], w[b]), max(w[a], w[b])
            assert w == sorted(v), (sort, v)
        pairs, out = _row_sorted_median_network(rows, nets[sort][0], nets[select])
        assert _prove_median(pairs, out, rows * rows), select
    # the counts the source's note gives: live min/max operations a median
    live = {}
    for name in ("median5", "select9", "select25"):
        pairs, out = nets[name]
        alive, n = {out}, 0
        for a, b in reversed(pairs):
            la, lb = a in alive, b in alive
            if la or lb:
                n += la + lb
                alive |= {a, b}
        live[name] = (len(pairs), n)
    assert live == {"median5": (7, 10), "select9": (10, 12), "select25": (61, 98)}


def test_chroma_proof_catches_a_wrong_network():
    """The proof is not vacuous: dropping any single compare-exchange from
    select9 or reading the wrong wire fails it."""
    nets = chroma_networks()
    pairs, out = _row_sorted_median_network(3, nets["sort3"][0], nets["select9"])
    rows = 3 * len(nets["sort3"][0])
    for i in range(rows, len(pairs)):
        assert not _prove_median(pairs[:i] + pairs[i + 1 :], out, 9), i
    assert not _prove_median(pairs, out + 1, 9)


def test_ev2raw_octave_matches_table():
    """The packed octave the kernel stages gives the EV->raw table at every
    EV in [0, 14 EVR)."""
    oct_ = chroma_ops.ev2raw_octave().astype(np.int64)
    assert oct_.shape == (8192,)
    e = np.arange(14 * EVR, dtype=np.int64)
    np.testing.assert_array_equal(_ev_to_raw(oct_, e), ev2raw_lut()[10 * EVR :])


_POPC3 = np.array([bin(i).count("1") for i in range(8)])


def _ev_to_raw(oct_, e):
    m = e & (EVR - 1)
    x = oct_[m >> 2]
    t = 8192 + (x & 0x1FFF) + _POPC3[(x >> 13) & ((1 << (m & 3)) - 1)]
    return t >> (13 - (e >> 15))


def _wrap(x):
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _cdiv2(x):
    return np.where(x < 0, -((-x) // 2), x // 2)


def _apply(pairs, vals):
    v = list(vals)
    for a, b in pairs:
        v[a], v[b] = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
    return v


def chroma_smooth_model(imgs, method, black, stats=None):
    """csrc/chroma.cu on (B, H, W) u16: persistent tiles of TX cell columns x
    TY cell rows (TG threads down a column, RUN cells each); stage 1 turns
    each cell of the tile and its apron into q_r, q_b (raw->EV from the
    staged first TAB entries, the device table above) and keeps the tile's
    own words and green means; stage 2 walks each
    thread's RUN cells down its column with a ring of the last 2R+1 sorted
    rows (sort3 / sort5 once a row, select9 / select25 a cell; 2x2 median5);
    stage 3 writes the words back, R and B from the packed octave where the
    rule holds."""
    with open(CHROMA_SRC) as f:
        src = f.read()
    R = 2 if method == 5 else 1
    TAB, TX, TG, RUN = (_source_int(src, n) for n in ("TAB", "TX", "TG", "RUN"))
    TY = TG * RUN
    nets = chroma_networks()
    b, h, w = imgs.shape
    lut = raw2ev_lut(black, size=1 << 16).astype(np.int64)
    tab = lut[:TAB]
    oct_ = chroma_ops.ev2raw_octave().astype(np.int64)
    ny, nx = chroma_ops.cell_window(h, w)
    grid_h, grid_w = (h + 1) // 2, (w + 1) // 2
    out = np.full((b, h, w), 0xABCD, np.int64)
    written = np.zeros((b, h, w), np.int64)
    pad = np.zeros((b, h + 1, w + 1), np.int64)
    pad[:, :h, :w] = imgs

    def to_ev(v):
        if stats is not None:
            stats["device_table"] = stats.get("device_table", 0) + int((v >= TAB).sum())
        return np.where(v < TAB, tab[np.minimum(v, TAB - 1)], lut[v])

    for f in range(b):
        for gy0 in range(0, grid_h, TY):
            for gx0 in range(0, grid_w, TX):
                gy = gy0 + np.arange(-R, TY + R)[:, None]
                gx = gx0 + np.arange(-R, TX + R)[None, :]
                inside = (gy >= 0) & (gx >= 0) & (gy < grid_h) & (gx < grid_w)
                y, x = np.clip(2 * gy, 0, h), np.clip(2 * gx, 0, w)
                below, right = inside & (2 * gy + 1 < h), inside & (2 * gx + 1 < w)
                r = np.where(inside, pad[f, y, x], 0)
                g1 = np.where(right, pad[f, y, np.minimum(x + 1, w)], 0)
                g2 = np.where(below, pad[f, np.minimum(y + 1, h), x], 0)
                bl = np.where(below & right, pad[f, np.minimum(y + 1, h), np.minimum(x + 1, w)], 0)
                whole = below & right
                ge = _cdiv2(_wrap(to_ev(g1) + to_ev(g2)))
                qr = np.where(whole, _wrap(to_ev(r) - ge), 0)
                qb = np.where(whole, _wrap(to_ev(bl) - ge), 0)
                ge = np.where(whole, ge, 0)
                meds = []
                for q in (qr, qb):  # shared planes, cell (ly, lx) at [ly + R, lx + R]
                    med = np.zeros((TY, TX), np.int64)
                    cols = np.arange(TX) + R
                    for t in range(TG):
                        ly0 = t * RUN
                        if method == 2:
                            for k in range(RUN):
                                c = ly0 + k + R
                                v = [q[c - 1, cols], q[c, cols - 1], q[c, cols], q[c, cols + 1], q[c + 1, cols]]
                                med[ly0 + k] = _apply(nets["median5"][0], v)[nets["median5"][1]]
                            continue
                        d = 2 * R + 1
                        sort = nets["sort3" if d == 3 else "sort5"][0]
                        select, at = nets["select9" if d == 3 else "select25"]

                        def sorted_row(ly):
                            if stats is not None:
                                stats["row_sorts"] = stats.get("row_sorts", 0) + 1
                            return _apply(sort, [q[ly + R, cols - R + p] for p in range(d)])

                        ring = [sorted_row(ly0 - R + j) for j in range(d - 1)]
                        for k in range(RUN):
                            ring.append(sorted_row(ly0 + k + R))
                            med[ly0 + k] = _apply(select, [v for row in ring for v in row])[at]
                            ring.pop(0)
                    meds.append(med)
                own = (slice(R, R + TY), slice(R, R + TX))
                g, mr, mb = ge[own], meds[0], meds[1]
                er, eb = _wrap(g + mr), _wrap(g + mb)
                cy, cx = (gy[own[0]] - 2), (gx[:, own[1]] - 2)
                smooth = (cy >= 0) & (cy < ny) & (cx >= 0) & (cx < nx) & (g >= 2 * EVR) & (er > EVR) & (eb > EVR)
                new_r = (_ev_to_raw(oct_, np.clip(er, 0, 14 * EVR - 1)) + black) & 0xFFFF
                new_b = (_ev_to_raw(oct_, np.clip(eb, 0, 14 * EVR - 1)) + black) & 0xFFFF
                vals = {(0, 0): np.where(smooth, new_r, r[own]), (0, 1): g1[own], (1, 0): g2[own],
                        (1, 1): np.where(smooth, new_b, bl[own])}
                for (dy, dx), v in vals.items():
                    yy = np.broadcast_to(2 * gy[own[0]] + dy, (TY, TX))
                    xx = np.broadcast_to(2 * gx[:, own[1]] + dx, (TY, TX))
                    ok = inside[own] & (yy < h) & (xx < w)
                    out[f, yy[ok], xx[ok]] = v[ok]
                    written[f, yy[ok], xx[ok]] += 1
    assert (written == 1).all(), "every pixel written once"
    return out.astype(np.uint16)


def _chroma_frames(rng, b, h, w, black, wide=False):
    hi = 65536 if wide else 16000
    imgs = rng.integers(black - 40 if not wide else 0, hi, (b, h, w))
    imgs[:, 3:9, 5:20] = black
    imgs[:, -4:, : w // 3] = black + rng.integers(0, 4, (b, min(4, h), w // 3))
    return imgs.astype(np.uint16)


@pytest.mark.parametrize("method, b, h, w, black, wide", [
    (3, 1, 70, 140, 2047, False),     # two tiles across and down
    (5, 1, 70, 140, 2048, False),
    (2, 2, 40, 58, 2047, False),
    (3, 1, 75, 133, 2047, False),     # odd width and height: 16-bit accesses
    (2, 1, 9, 7, 2048, False),        # one cell column of window
    (3, 1, 66, 260, 8188, True),      # 16-bit values at black * 4
    (5, 1, 66, 132, 8192, True),
    (5, 1, 8, 16, 2048, False),       # no window: a copy
])
def test_chroma_smooth_model_matches_twin(method, b, h, w, black, wide):
    """Kernel #2's tiles, staged table, ring of shared sorted rows and packed
    EV->raw octave give exactly the twin's frames."""
    rng = np.random.default_rng(h * w + method)
    imgs = _chroma_frames(rng, b, h, w, black, wide)
    stats = {}
    got = chroma_smooth_model(imgs, method, black, stats)
    want = chroma_ops.chroma_smooth_batch_plain(torch.from_numpy(imgs.view(np.int16)), method, black)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint16))
    if wide:
        assert stats["device_table"] > 0  # values past the staged table were read
    if method != 2 and h > 10:
        # a thread sorts RUN + 2R rows for its RUN cells, a row serving 2R + 1
        # of them (the model sorts a row of all 64 columns at once)
        r, run = (2, 8) if method == 5 else (1, 8)
        tiles = -(-((h + 1) // 2) // (4 * run)) * -(-((w + 1) // 2) // 64)
        assert stats["row_sorts"] == 2 * b * tiles * 4 * (run + 2 * r)


# -------------------------------------------------------------- kernel #1

UNPACK_SRC = os.path.join(_build.SRC_DIR, "unpack.cu")
UNPACK_BPPS = (8, 10, 12, 14, 16)  # the instantiated forms; every other bpp is plain


def _byte_perm(x, y, s):
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    r = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        r |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return r


def _pair_selectors():
    """The __byte_perm selectors csrc/unpack.cu assembles word pairs with:
    (w[a] odd a, w[a] even a)."""
    with open(UNPACK_SRC) as f:
        src = f.read()
    odd = re.search(r"__byte_perm\(x\[A >> 1\], x\[\(A >> 1\) \+ 1\], (0x[0-9a-f]+)\)", src).group(1)
    even = re.search(r"__byte_perm\(x\[A >> 1\], 0u, (0x[0-9a-f]+)\)", src).group(1)
    return int(odd, 16), int(even, 16)


def _vector(addr):
    return 16 if addr % 16 == 0 else 8 if addr % 8 == 0 else 4 if addr % 4 == 0 else 2


def unpack_model(words, bpp, n_pixels, in_off=0, out_off=0, stats=None):
    """csrc/unpack.cu on (B, n_words) u16 at byte address 2 * in_off, out at
    2 * out_off: groups of 8 pixel blocks, a warp's 32 staged through shared
    memory by vectors as wide as each frame's base allows; a lane assembles
    its words' pairs by __byte_perm from little-endian 32-bit words, writes
    its 16-B output vectors rotated by its lane, and the warp stores them
    unrotated; the pixels after the last whole group (all of them at a bpp
    without its own form) by the plain formula, a warp's lanes on
    consecutive pixels."""
    b, n_words = words.shape
    lcm = math.lcm(16, bpp)
    ppb, wpb = lcm // bpp, lcm // 16
    IN, OUT = 16 * wpb, 16 * ppb
    odd_sel, even_sel = _pair_selectors()
    mask = (1 << bpp) - 1
    n_groups = min(n_pixels // (8 * ppb), n_words // (8 * wpb)) if bpp in UNPACK_BPPS else 0
    body = -(-n_groups // 32) * 32
    out = np.zeros((b, n_pixels), np.uint16)
    written = np.zeros((b, n_pixels), np.int64)
    for f in range(b):
        src = words[f].astype("<u2").tobytes()
        in_base, out_base = 2 * (in_off + f * n_words), 2 * (out_off + f * n_pixels)
        frame_out = bytearray(2 * n_pixels)
        for g0 in range(0, body, 32):
            ng = min(32, n_groups - g0)
            vec = _vector(in_base)
            start, size = g0 * IN, ng * IN
            assert (in_base + start) % vec == 0 and size % vec == 0
            stage = np.frombuffer(src[start : start + size], "<u4").reshape(ng, 4 * wpb)  # a lane's group
            lanes = []
            for n in range(8 * ppb):
                off = n * bpp
                a, sh = off >> 4, off & 15
                xa = stage[:, a >> 1].astype(np.uint64)
                if sh + bpp <= 16:
                    v = (xa >> np.uint64((a & 1) * 16 + 16 - bpp - sh)) & np.uint64(mask)
                else:
                    pair = (_byte_perm(xa, stage[:, (a >> 1) + 1], odd_sel) if a & 1
                            else _byte_perm(xa, np.zeros_like(xa), even_sel))
                    v = (pair >> np.uint64(32 - bpp - sh)) & np.uint64(mask)
                lanes.append(v.astype(np.uint16))
            px = np.stack(lanes, 1).reshape(ng, ppb, 8)  # lane, vector j, 8 pixels
            slot = np.zeros_like(px)
            for lane in range(ng):
                for j in range(ppb):
                    slot[lane, (j + lane) % ppb] = px[lane, j]
            flat = slot.reshape(ng * ppb, 8)
            vec = _vector(out_base)
            for c in range(ng * ppb):
                g, j = divmod(c, ppb)
                addr = g0 * OUT + 16 * c
                assert (out_base + addr) % vec == 0
                frame_out[addr : addr + 16] = flat[g * ppb + (j + g) % ppb].astype("<u2").tobytes()
                written[f, addr // 2 : addr // 2 + 8] += 1
            if stats is not None:
                stats["groups"] = stats.get("groups", 0) + ng
        out[f] = np.frombuffer(bytes(frame_out), "<u2")
        plain_from = n_groups * 8 * ppb
        for j in range(-(-(n_pixels - plain_from) // 256) * 32):
            for k in range(8):
                p = plain_from + 256 * (j >> 5) + (j & 31) + 32 * k
                if p >= n_pixels:
                    break
                bit = p * bpp
                a, sh = bit >> 4, bit & 15
                w0 = int(words[f, a]) if a < n_words else 0
                if sh + bpp <= 16:
                    v = w0 >> (16 - bpp - sh)
                else:
                    w1 = int(words[f, a + 1]) if a + 1 < n_words else 0
                    v = ((w0 << 16) | w1) >> (32 - bpp - sh)
                out[f, p] = v & mask
                written[f, p] += 1
                if stats is not None:
                    stats["plain"] = stats.get("plain", 0) + 1
    assert (written == 1).all(), "every pixel written once"
    return out


@pytest.mark.parametrize("bpp, h, w, b, cut, in_off, out_off", [
    (14, 32, 64, 2, 0, 0, 0),       # whole groups, aligned
    (14, 33, 71, 2, 0, 1, 3),       # a partial last warp and group, unaligned bases
    (14, 20, 64, 2, 700, 0, 0),     # a stream cut inside the last groups
    (12, 24, 40, 3, 0, 4, 2),       # 8- and 4-byte vectors
    (10, 17, 96, 2, -5, 0, 0),      # a long stream
    (16, 9, 64, 2, 0, 2, 0),
    (8, 40, 50, 3, 0, 0, 1),
    (11, 13, 40, 2, 3, 0, 0),       # no form of its own: every pixel plain
    (1, 3, 40, 1, 0, 0, 0),
])
def test_unpack_model_matches_twin(bpp, h, w, b, cut, in_off, out_off):
    """Kernel #1's grouped layout, staged copies, pair assembly and rotated
    vectors, with its plain head-free tail, give exactly the twin's pixels."""
    rng = np.random.default_rng(bpp * h * w)
    n_words = max(unpack_ops.words_for_pixels(h * w, bpp) - cut, 0)
    words = rng.integers(0, 1 << 16, (b, n_words), dtype=np.uint16)
    stats = {}
    got = unpack_model(words, bpp, h * w, in_off, out_off, stats)
    want = unpack_ops.unpack_batch_plain(torch.from_numpy(words.view(np.int16)), bpp, h, w)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint16).reshape(b, h * w))
    ppb, wpb = 16 // math.gcd(16, bpp), bpp // math.gcd(16, bpp)
    groups = min(h * w // (8 * ppb), n_words // (8 * wpb)) if bpp in UNPACK_BPPS else 0
    assert stats.get("groups", 0) == b * groups
    assert stats.get("plain", 0) == b * (h * w - groups * 8 * ppb)


# ---------------------------------------------------------------- kernel #9
#
# csrc/amaze_mega.cu: one cooperative launch of persistent blocks that runs
# split mode's steps (#8's stage groups on 32 x 32 tiles, #10's walks) in
# its order, a grid sync between steps, each block taking the items of a
# step in a grid-stride loop, with one dynamic shared memory size for all.

MEGA_SRC = os.path.join(_build.SRC_DIR, "amaze_mega.cu")
TILES_SRC = os.path.join(_build.SRC_DIR, "amaze_tiles.cuh")
PASSES_SRC = os.path.join(_build.SRC_DIR, "amaze_passes.cuh")
SCANS_SRC = os.path.join(_build.SRC_DIR, "amaze_scans.cu")
STAGES_SRC = os.path.join(_build.SRC_DIR, "amaze_stages.cuh")


def _read(path):
    with open(path) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def _enum_names(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return [t.strip() for t in body.replace("\n", " ").split(",") if t.strip()]


def group_smem_bytes():
    """{group: bytes} of the shared-memory planes of #8's stage groups, from
    csrc/amaze_tiles.cuh's reach table: a plane of reach (ry, rx) holds
    (TILE_H + 2 ry) x (TILE_W + 2 rx) floats."""
    src = _read(TILES_SRC)
    th, tw = _constant(src, "TILE_H"), _constant(src, "TILE_W")
    body = src[src.index("constexpr Reach reach(int G, int P)"):src.index("constexpr bool in_shared")]
    out = {}
    for g, block in re.findall(r"if \(G == (\d)\) \{(.*?)\n  \}", body, re.S):
        floats = 0
        for planes, ry, rx in re.findall(r"((?:\s*(?:\|\|)?\s*P == \w+)+)\s*\?\s*Reach\{(\d+), (\d+)\}", block):
            n = len(re.findall(r"P == \w+", planes))
            floats += n * (th + 2 * int(ry)) * (tw + 2 * int(rx))
        out[int(g)] = 4 * floats
    return out


def mega_walks(wp):
    """(refine by its ring, dilate by its ring) for planes of wp padded
    columns, as #10 chooses (csrc/amaze_scans.cu): the refine ring where its
    rows fit a block's shared memory, the dilate ring where a row of cells is
    at most 32 words."""
    src = _read(PASSES_SRC)
    ring_rows, max_smem = _constant(src, "REFINE_RING"), _constant(src, "MAX_SMEM")
    return (ring_rows + 2) * wp * 4 <= max_smem, wp // 2 <= 32 * 32


def mega_smem_model(wp):
    """Kernel #9's dynamic shared memory: the most of groups 1, 3 and 4, the
    chosen refine and dilate walks and a staged chroma block."""
    src = _read(PASSES_SRC)
    groups = group_smem_bytes()
    refine_ring, dilate_ring = mega_walks(wp)
    refine = (_constant(src, "REFINE_RING") + 2) * wp * 4 if refine_ring else 2 * wp * 4
    nwords = (wp // 2 + 31) // 32
    dilate = (_constant(src, "DILATE_RING") * wp * 4 + 11 * nwords * 4) if dilate_ring else 3 * wp * 4 + wp // 2
    rows, lanes, halo = (_constant(src, n) for n in ("CHROMA_ROWS", "CHROMA_LANES", "CHROMA_HALO"))
    chroma = (rows + 2 * halo) * (lanes + 2 * halo) * 4
    return max(groups[1], groups[3], groups[4], refine, dilate, chroma)


def test_mega_group_shared_memory_from_reach():
    """The reach table gives group 1 the mosaic at 50 x 50, three planes at
    46 x 46, six at 42 x 42 and two at 38 x 38 (22,320 floats), and groups 3
    and 4 less; only 1, 3 and 4 hold planes in shared memory."""
    groups = group_smem_bytes()
    assert set(groups) == {1, 3, 4}
    assert groups[1] == 4 * (50 * 50 + 3 * 46 * 46 + 6 * 42 * 42 + 2 * 38 * 38) == 4 * 22320
    assert groups[3] < groups[1] and groups[4] < groups[3]


@pytest.mark.parametrize("wp, refine_ring, dilate_ring, smem", [
    (50, True, True, 89280),        # group 1's tile planes bound it
    (1952, True, True, 89280),      # 1080p: the rings (62,464 and 63,828 B) fit under group 1
    (2049, True, True, 89280),      # the widest row of 1,024 cells: dilate's ring still
    (2050, True, False, 89280),     # 1,025 cells: dilate's row walk (26,625 B)
    (7264, True, False, 232448),    # the widest refine ring, all of a block's shared memory
    (7300, False, False, 91250),    # past it: both row walks, dilate's three rows the most
])
def test_mega_walks_and_shared_memory(wp, refine_ring, dilate_ring, smem):
    """Kernel #9 picks refine's and dilate's walks per width as #10 does, and
    its dynamic shared memory is the most of the groups and the chosen
    walks; the source computes both from the same terms."""
    assert mega_walks(wp) == (refine_ring, dilate_ring)
    assert mega_smem_model(wp) == smem
    mega, scans = _read(MEGA_SRC), _read(SCANS_SRC)
    assert "ps::refine_ring_smem(wp) <= ps::MAX_SMEM" in mega and "refine_ring_smem(wp) <= MAX_SMEM" in scans
    assert "ps::dilate_ring_fits(wp)" in mega and "dilate_ring_fits(wp)" in scans
    body = mega[mega.index("inline size_t mega_smem("):mega.index("__device__ __forceinline__ long long globaltimer")]
    for term in ("smem_bytes(1)", "smem_bytes(3)", "smem_bytes(4)", "ps::refine_ring_smem(wp)",
                 "ps::refine_smem(wp)", "ps::dilate_ring_smem(wp)", "ps::dilate_smem(wp)",
                 "ps::CHROMA_H * ps::CHROMA_W"):
        assert term in body, term


def mega_steps_from_source():
    """Kernel #9's steps in order, read from its kernel body: ("pad",),
    ("group", G), (pass, source slot, destination slot[, parity]); and the
    count of grid syncs between them."""
    src = _read(MEGA_SRC)
    body = src[src.index("amaze_mega_kernel(const float* raw"):src.index("// How a launch of (h, w) frames")]
    body = body[body.index("pad(q"):]
    steps, syncs = [], 0
    for line in body.splitlines():
        line = line.strip()
        if line == "sync();":
            syncs += 1
        elif line.startswith("pad(q"):
            steps.append(("pad",))
        elif m := re.match(r"tiles<(\d)>\(", line):
            steps.append(("group", int(m.group(1))))
        elif m := re.match(r"(dilate|refine)\(q, \w+, (S_\w+), (S_\w+)", line):
            steps.append(m.groups())
        elif m := re.match(r"chroma\(q, (S_\w+), (S_\w+), (\d), (S_\w+), (S_\w+), (\d)", line):
            a, b, p, c, d, e = m.groups()
            steps.append(("chroma", (a, b, int(p)), (c, d, int(e))))
        elif line.startswith("output(q"):
            steps.append(("group", 5))
        elif line.startswith("if (stamps != nullptr)"):
            break
    return steps, syncs


def split_steps_from_source():
    """Split mode's steps in order, read from ops/amaze_core.py
    _amaze_demosaic_cuda, its planes named by their workspace slots."""
    with open(amaze_core.__file__) as f:
        src = f.read()
    body = src[src.index("def _amaze_demosaic_cuda("):src.index("def _amaze_demosaic_mega_cuda(")]
    slot = dict(zip(amaze_core.SPLIT_PLANES, _enum_names(_read(STAGES_SRC), "SplitSlot")))
    steps, chroma = [], []
    for line in body.splitlines():
        line = line.strip()
        if line.startswith('plane["cfa"].copy_(pad_mosaic(raw))'):
            steps.append(("pad",))
        elif m := re.match(r"stage\((\d)\)", line):
            steps.append(("group", int(m.group(1))))
        elif m := re.match(r'amaze_scans\.(dilate|refine)\(plane\["(\w+)"\], out=plane\["(\w+)"\]\)', line):
            steps.append((m.group(1), slot[m.group(2)], slot[m.group(3)]))
        elif m := re.match(r'amaze_scans\.chroma\(plane\["(\w+)"\], (\d), out=plane\["(\w+)"\]\)', line):
            chroma.append((slot[m.group(1)], slot[m.group(3)], int(m.group(2))))
            if len(chroma) == 2:
                steps.append(("chroma", *chroma))
    return steps


def test_mega_steps_follow_split_mode():
    """Kernel #9 runs split mode's steps in its order, with the same planes in
    and out of each pass and a grid sync between each two (9 syncs);
    MEGA_STEPS names them, and the kernel's N_STAMPS is one more, as the
    wrapper's stamps buffer is."""
    steps, syncs = mega_steps_from_source()
    assert steps == split_steps_from_source()
    assert [s[0] for s in steps] == ["pad", "group", "dilate", "group", "refine", "group", "refine", "group",
                                     "chroma", "group"]
    assert syncs == len(steps) - 1 == 9
    assert len(amaze_core.MEGA_STEPS) == len(steps)
    assert _constant(_read(MEGA_SRC), "N_STAMPS") == len(steps) + 1


def mega_teams():
    """{group 1..4, "chroma": teams a block splits into}, from
    csrc/amaze_mega.cu's block size NT, TEAM_THREADS (0: the whole block)
    and CHROMA_TEAM."""
    src = _read(MEGA_SRC)
    nt = _constant(src, "NT")
    per_group = [int(v) for v in re.search(r"TEAM_THREADS\[5\] = \{([\d, ]+)\}", src).group(1).split(",")]
    teams = {g: nt // (nt if per_group[g] == 0 else per_group[g]) for g in range(1, 5)}
    teams["chroma"] = nt // _constant(src, "CHROMA_TEAM")
    return teams


def mega_coverage(b, h, w, grid):
    """Counts, per padded pixel, of the writes of kernel #9's item loops
    modelled as its source runs them: a stage
    group's (frame, tile row, tile column) items, team k of block j taking
    items (j + m * grid) * teams + k, and each tile's own pixels (and the
    cell regions' own sites, both lanes); the passes' (frame, raster tile)
    items and each tile's kept rows; the chroma pass's (plane, frame, row
    block, lane block) items, taken by teams likewise, and their cells; the
    output's pixels. Returns {step: counts}."""
    tiles_src = _read(TILES_SRC)
    th, tw = _constant(tiles_src, "TILE_H"), _constant(tiles_src, "TILE_W")
    hp, wp = h + 2 * amaze_core.PAD, w + 2 * amaze_core.PAD
    ny, nx = -(-hp // th), -(-wp // tw)
    teams = mega_teams()
    out = {}
    for g in range(1, 5):
        out[f"group {g}"], out[f"group {g} cells"] = _group_cover(b, hp, wp, ny, nx, th, tw, grid, teams[g])
    _mega_rest(out, b, h, w, hp, wp, grid, teams)
    return out


def _group_cover(b, hp, wp, ny, nx, th, tw, grid, teams):
    """Writes per padded pixel of a stage group's tiles: the items the teams
    take, each mapped to its (frame, tile row, tile column), and the pixels
    each tile writes (its own, and its own cell sites with both lanes)."""
    taken = np.concatenate([np.arange(r.start, r.stop, r.step) for r in _team_items(b * ny * nx, grid, teams)])
    f, r = taken // (ny * nx), taken % (ny * nx)
    hits = np.zeros((b, ny, nx), np.int32)
    np.add.at(hits, (f, r // nx, r % nx), 1)
    px = np.zeros((b, hp, wp), np.int32)
    cells = np.zeros((b, hp, wp), np.int32)
    ty, tx = np.mgrid[0:th, 0:tw]
    cy, cc = np.mgrid[0:th, 0:tw // 2]
    for i, j in itertools.product(range(ny), range(nx)):
        Y0, X0 = i * th, j * tw
        n = hits[:, i, j][:, None]
        own = (Y0 + ty < hp) & (X0 + tx < wp)
        px[:, (Y0 + ty)[own], (X0 + tx)[own]] += n
        # the cell region: cell c of a row at its R/B site, both lanes
        site_x = 2 * cc + ((Y0 + cy) % hp & 1)
        own = (Y0 + cy < hp) & (X0 + site_x < wp)
        for lane in (0, 1):
            cells[:, (Y0 + cy)[own], (X0 + (site_x ^ lane))[own]] += n
    return px, cells


def _team_items(n_items, grid, teams):
    """The items each team of a grid of blocks takes: team k of block j
    takes (j + m * grid) * teams + k."""
    return [range(j * teams + k, n_items, grid * teams) for j in range(grid) for k in range(teams)]


def _mega_rest(out, b, h, w, hp, wp, grid, teams):
    T = amaze_core.n_tiles(hp)
    rows = np.zeros((b, hp), np.int32)
    for items in _team_items(b * T, grid, 1):
        for i in items:
            y0, _, keep = _tiles(hp)[i % T]
            for r, k in enumerate(keep):
                rows[i // T, y0 + r] += k
    out["pass rows"] = rows
    lb, rb = -(-wp // CHROMA_LANES), -(-hp // CHROMA_ROWS)
    per_frame = lb * rb
    chroma = np.zeros((2, b, hp, wp), np.int32)
    for items in _team_items(2 * b * per_frame, grid, teams["chroma"]):
        for i in items:
            second = i >= b * per_frame
            r = i - b * per_frame if second else i
            k = r % per_frame
            Y0, X0 = (k // lb) * CHROMA_ROWS, (k % lb) * CHROMA_LANES
            chroma[int(second), r // per_frame, Y0:Y0 + CHROMA_ROWS, X0:X0 + CHROMA_LANES] += 1
    out["chroma"] = chroma
    output = np.zeros(b * h * w, np.int32)
    for k in range(grid):
        output[k::grid] += 1  # a block's threads stride by grid times their count: the same cover
    out["output"] = output


@pytest.mark.parametrize("b, h, w, grid", [
    (1, 17, 18, 264),      # two blocks an SM on 132 SMs; 4 x 2 tiles, fewer items than blocks
    (1, 160, 2100, 264),   # the last tile column straddles the wrap (2,132 = 66.6 tiles)
    (1, 160, 2100, 7),     # a grid that divides no step's items
    (3, 96, 32, 6),        # a grid that divides group items (3 x 4 x 2 = 24) and pass items (3)
    (16, 64, 96, 132),     # B = 16
    (16, 1080, 1920, 264),  # 1080p, B = 16: 34,160 group items, 144 pass items
    (270, 40, 64, 264),    # 2,430 group items, 270 pass items: more than the blocks, no multiple
])
def test_mega_items_cover_every_pixel_once(b, h, w, grid):
    """Each step of kernel #9 writes every pixel of every frame exactly once:
    the stage groups' tiles (pixel and cell regions, a team of the block
    each) and the passes' kept rows and chroma blocks, whatever the grid,
    and wherever the last tiles straddle the wrap."""
    assert mega_teams() == {1: 1, 2: 4, 3: 2, 4: 4, "chroma": 2}
    cover = mega_coverage(b, h, w, grid)
    assert len(cover) == 11
    for name, counts in cover.items():
        assert (counts == 1).all(), (name, int(counts.min()), int(counts.max()))
