"""Reference copy of ``mlvfs_tpu_torch/ops/pixels.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Focus-pixel and bad-pixel correction by a static pixel list, in plain PyTorch.

Counterpart of ``mlvfs_tpu/ops/pixels.py`` (fix_focus_pixels + .fpm loading,
cs.c:87-168 and cs.c:355-503; fix_bad_pixels, cs.c:220-331). Bad pixels are
detected once per clip by the reference's host numpy (``detect_bad_pixels``,
one frame read back from the device); the list then takes the same fix as a
focus-pixel map. For every listed pixel the stencil
neighbourhood is gathered from the original frame, interpolated in EV space
with C int32 semantics, and written back. The list is static per clip, so
everything that depends on the list alone (clamped gather indices, the
edge/interior choice per entry, the targets) is computed once on the host
and uploaded once per (list, geometry, device).

int32 arithmetic runs in int64 and is wrapped back to int32 two's
complement explicitly (``wrap32``) before every operation that is not
modular (abs, shift right, division, comparison, table lookup), so the
results are the same on every device and never depend on signed overflow.

Divergence from the JAX reference's scatter, with identical results: the
reference routes out-of-bounds entries to a dummy write at index 0 and
restores pixel 0 afterwards, and leaves duplicate targets to XLA's scatter
order (the last entry wins on the CPU). Here out-of-bounds entries are
dropped, and of several entries with one target only the last is kept, so
no two writes race on CUDA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .luts import EV_RESOLUTION, ev2raw_lut, raw2ev_lut
from .unpack import to_int16_bits


_I32 = 1 << 31


def detect_bad_pixels(
    frame: np.ndarray,
    width: int,
    height: int,
    black: int,
    aggressive: bool,
    crop_x: int,
    crop_y: int,
) -> np.ndarray:
    """Auto-detect cold/hot pixels on one host frame → (N, 2) sensor coords.

    cr2hdr-derived rules (cs.c:255-306): cold = below black - 8*noise;
    hot = more than 2 EV above the 2nd-max of the 8 same-color neighbors;
    aggressive adds a 1 EV test against the 2nd and 3rd max.
    """
    img = np.asarray(frame, np.int32)
    h, w = img.shape
    assert (h, w) == (height, width)
    dark_noise = 12  # fixed guess, cs.c:256
    dark_min = black - dark_noise * 8
    dark_max = black + dark_noise * 8

    # 8 same-color neighbors at offsets {-2,0,2}^2 \ origin, interior window
    ys = slice(6, h - 6)
    xs = slice(6, w - 6)
    center = img[ys, xs]
    neigh = np.stack(
        [
            img[6 + dy : h - 6 + dy, 6 + dx : w - 6 + dx]
            for dy in (-2, 0, 2)
            for dx in (-2, 0, 2)
            if not (dy == 0 and dx == 0)
        ]
    )
    # top-3 neighbor values; reference tracks maxima of negated values seeded
    # with 0, so values clamp at >= 0 (pixels are non-negative anyway)
    part = -np.partition(-neigh, 2, axis=0)[:3]
    max2, max3 = part[1], part[2]

    lut = raw2ev_lut(black)
    ev = lut[np.minimum(center, len(lut) - 1)]
    ev_max2 = lut[np.minimum(max2, len(lut) - 1)]
    cold = center < dark_min
    hot = (ev - ev_max2 > 2 * EV_RESOLUTION) & (center > dark_max)
    bad = cold | hot
    if aggressive:
        ev_max3 = lut[np.minimum(max3, len(lut) - 1)]
        bad |= ((ev - ev_max2 > EV_RESOLUTION) | (ev - ev_max3 > EV_RESOLUTION)) & (
            center > dark_max
        )

    yy, xx = np.nonzero(bad)
    # scan order (y, then x) matches the reference's loop order
    return np.stack([xx + 6 + crop_x, yy + 6 + crop_y], axis=1).astype(np.int32)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 two's-complement value of its low 32 bits (as int64)."""
    return ((x + _I32) & 0xFFFFFFFF) - _I32


def _div_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C's truncating int32 `/` (jax.lax.div), wrapped like int32."""
    return wrap32(torch.div(a, b, rounding_mode="trunc"))


def _weighted(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C's `(e * c) >> 8` on int32."""
    return wrap32(e * c) >> 8


@functools.lru_cache(maxsize=16)
def ev_tables(black: int, device: torch.device):
    """raw→EV (indexed by any u16 value) and EV→raw tables on ``device``,
    uploaded once per (black, device)."""
    lut = torch.from_numpy(np.asarray(raw2ev_lut(black, size=1 << 16), np.int64))
    inv = torch.from_numpy(np.asarray(ev2raw_lut(), np.int64))
    return lut.to(device), inv.to(device)


# stencil offsets gathered per listed pixel, in units of (1, width)
_OFFSETS = [(0, 0), (1, 0), (-1, 0), (2, 0), (-2, 0), (3, 0), (-3, 0),
            (0, 1), (0, -1), (0, 2), (0, -2), (0, 3), (0, -3)]
_K = {off: k for k, off in enumerate(_OFFSETS)}

# value chosen per entry (fix_focus_pixels edge handling, cs.c:479-500)
_KEEP, _INTERIOR, _VERT, _HORIZ, _RIGHT2, _LEFT2 = range(6)


def build_pixel_fixer(
    pixel_list: np.ndarray,
    height: int,
    width: int,
    black: int,
    crop_x: int,
    crop_y: int,
    dual_iso: bool,
    device,
):
    """Specialize the fix to one pixel list and geometry.

    Returns ``fn(imgs[B, H, W] int16) -> fixed copy``. The per-entry choices
    are made here on the host, in the reference's order.
    """
    device = torch.device(device)
    pl = np.asarray(pixel_list, np.int64).reshape(-1, 2)
    x = pl[:, 0] - crop_x
    y = pl[:, 1] - crop_y
    n_px = height * width
    flat = x + y * width
    interior = (x > 2) & (x < width - 3) & (y > 2) & (y < height - 3)
    inbounds = (flat > 0) & (flat < n_px)
    horizontal_edge = ((x >= width - 3) & (x < width)) | ((x >= 0) & (x <= 3))
    vertical_edge = ((y >= height - 3) & (y < height)) | ((y >= 0) & (y <= 3))

    h_only = horizontal_edge & ~vertical_edge if not dual_iso else np.zeros_like(horizontal_edge)
    v_only = vertical_edge & ~horizontal_edge
    only_h = ~h_only & ~v_only
    mode = np.full(len(pl), _KEEP, np.int64)
    mode[h_only] = _VERT
    mode[v_only] = _HORIZ
    mode[only_h & (x >= 0) & (x <= 3)] = _RIGHT2
    mode[only_h & (x >= width - 3) & (x < width)] = _LEFT2
    mode[interior] = _INTERIOR

    # drop out-of-bounds entries; of entries sharing a target keep the last
    keep = np.nonzero(inbounds)[0]
    _, last_rev = np.unique(flat[keep][::-1], return_index=True)
    keep = np.sort(keep[len(keep) - 1 - last_rev])

    flat_k = flat[keep]
    idx = np.stack([np.clip(flat_k + dx + dy * width, 0, n_px - 1) for dx, dy in _OFFSETS])
    idx_t = torch.from_numpy(idx).to(device)  # (K, M)
    tgt_t = torch.from_numpy(flat_k).to(device)  # (M,)
    mode_t = torch.from_numpy(mode[keep]).to(device)  # (M,)
    lut, inv = ev_tables(int(black), device)

    def fix(imgs: torch.Tensor) -> torch.Tensor:
        b = imgs.shape[0]
        out = imgs.clone()
        if tgt_t.numel() == 0:
            return out
        f = imgs.reshape(b, n_px).to(torch.int64) & 0xFFFF
        px = f[:, idx_t]  # (B, K, M) pixel values 0..65535
        ev_all = lut[px]  # int32 EV values (INT_MIN at black)

        def at(dx, dy):
            return px[:, _K[(dx, dy)]]

        def ev(dx, dy):
            return ev_all[:, _K[(dx, dy)]]

        def ev2raw(e):
            e = e.clamp(0, 14 * EV_RESOLUTION - 1)
            return wrap32(inv[e + 10 * EV_RESOLUTION] + black)

        def absdiff(a, c):
            return wrap32(wrap32(a - c).abs())

        def weights2(d1, d2):
            # (sum-d)<<8 / sum; sum may be negative via C's ABS(INT_MIN)
            s = wrap32(d1 + d2)
            zero = s == 0
            safe = torch.where(zero, torch.ones_like(s), s)
            c1 = torch.where(zero, 0, _div_trunc(wrap32((s - d1) * 256), safe))
            c2 = torch.where(zero, 0, _div_trunc(wrap32((s - d2) * 256), safe))
            return s, c1, c2

        # horizontal stencil (cs.c:87-108)
        dh1 = absdiff(ev(3, 0), ev(1, 0))
        dh2 = absdiff(ev(-1, 0), ev(-3, 0))
        sh, ch1, ch2 = weights2(dh1, dh2)
        ev_h = wrap32(_weighted(ev(2, 0), ch1) + _weighted(ev(-2, 0), ch2))
        horiz = torch.where(sh == 0, at(2, 0), ev2raw(ev_h))

        # vertical stencil (cs.c:110-131)
        dv1 = absdiff(ev(0, 3), ev(0, 1))
        dv2 = absdiff(ev(0, -1), ev(0, -3))
        sv, cv1, cv2 = weights2(dv1, dv2)
        ev_v = wrap32(_weighted(ev(0, 2), cv1) + _weighted(ev(0, -2), cv2))
        vert = torch.where(sv == 0, at(0, 2), ev2raw(ev_v))

        # combined 4-direction stencil (cs.c:133-168)
        s4 = wrap32(dh1 + dh2 + dv1 + dv2)
        s4c = torch.where(s4 == 0, torch.ones_like(s4), wrap32(3 * s4))
        cv1f = _div_trunc(wrap32((s4 - dv1) * 256), s4c)
        cv2f = _div_trunc(wrap32((s4 - dv2) * 256), s4c)
        ch1f = _div_trunc(wrap32((s4 - dh1) * 256), s4c)
        ch2f = _div_trunc(wrap32((s4 - dh2) * 256), s4c)
        ev_4 = wrap32(
            _weighted(ev(0, 2), cv1f)
            + _weighted(ev(0, -2), cv2f)
            + _weighted(ev(2, 0), ch1f)
            + _weighted(ev(-2, 0), ch2f)
        )
        four = torch.where(s4 == 0, at(2, 0), ev2raw(ev_4))

        interior_val = horiz if dual_iso else four
        cand = torch.stack(
            [at(0, 0), interior_val, vert, horiz, at(2, 0), at(-2, 0)], dim=1
        )  # (B, 6, M)
        value = cand.gather(1, mode_t.expand(b, 1, -1))[:, 0]
        # int32 → u16 (C's truncating store), as int16 bits
        out.view(b, n_px)[:, tgt_t] = to_int16_bits(value & 0xFFFF)
        return out

    return fix


@functools.lru_cache(maxsize=32)
def _cached_fixer(pl_bytes: bytes, h, w, black, crop_x, crop_y, dual_iso, device):
    pl = np.frombuffer(pl_bytes, np.int64).reshape(-1, 2)
    return build_pixel_fixer(pl, h, w, black, crop_x, crop_y, dual_iso, device)


def fix_pixel_list_batch(imgs, pixel_list, black, crop_x, crop_y, dual_iso: bool):
    """Apply a (focus or bad) pixel list to a batch (B, H, W) int16 on its device.

    The specialized fixer is cached per (pixel list, geometry, config,
    device), so the batches of a clip reuse one upload of indices and tables.
    """
    if pixel_list is None or len(pixel_list) == 0:
        return imgs
    _, h, w = imgs.shape
    pl = np.ascontiguousarray(pixel_list, np.int64)
    fn = _cached_fixer(
        pl.tobytes(), h, w, int(black), int(crop_x), int(crop_y), bool(dual_iso), imgs.device
    )
    return fn(imgs)
