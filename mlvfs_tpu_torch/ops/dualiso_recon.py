"""The dual-ISO reconstruction's float stages: the exposure match, the
full-res select and half-res EV blend, the alias map's EV planes and
pre-map, and the final blend (hdr.c:783-809, 1355-1486, 1560-1772).

Each stage has a plain twin ``<stage>_plain`` in torch, on any device, over
the EV maps it is given (:class:`EvMaps`: the computed transforms of
:mod:`.evmath`, or ``--exact-luts``' tables), and a public ``<stage>``: on
CPU tensors the twin over the computed transforms, on CUDA tensors one
launch of ``csrc/dualiso_recon.cu`` (the same values, bit for bit), on
anything else an error; it never falls back from one to the other. Given
``maps`` (the tables), a public stage runs the twin on any device: the
tables are the config's choice, and have no kernel.

:func:`~.dualiso_full.reconstruct_batch` composes them around the
interpolation, the 20-bit chroma smoothing (``--cs*``) and kernel #7.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils import metrics
from . import evmath
from .alias import ALIAS_MAP_MAX, shift
from .evmath import fma
from .luts import EV_RESOLUTION
from .unpack import to_int16_bits

# Launches of csrc/dualiso_recon.cu by the stages below, for showing that a
# run went through the kernels (also counted as ``recon.fused_launches`` in
# utils.metrics). Only _launch adds to it, once per launch.
KERNEL_LAUNCHES = 0

FULLRES_THR = 0.8
DARK_NOISE20 = 8.0 * 64  # compute_noise's default stdev 8 (14-bit) for MLV frames


class EvMaps(NamedTuple):
    """The reconstruction's EV maps: raw → EV, EV → raw, raw → fullres curve."""
    ev_of: Callable
    ev2raw_at: Callable
    frcurve_of: Callable


def white_ev_of(black20: int, white20: int) -> int:
    """raw2ev(white20) on the host, the computed inverse's white clamp."""
    return int(round(math.log2(1 + max(white20 / 64.0 - black20 / 64.0, 0)) * EV_RESOLUTION))


@functools.lru_cache(maxsize=4)
def max_ev(black20: int, white20: int) -> torch.Tensor:
    """log2 of the white's distance from black (mix_images), a 0-dim host
    tensor, computed once per levels."""
    return evmath.log2_f32(torch.tensor(float(white20 // 64 - black20 // 64)))


def computed_maps(black20: int, white20: int) -> EvMaps:
    """The computed transforms (:mod:`.evmath`) at these levels."""
    white_ev = white_ev_of(black20, white20)
    return EvMaps(lambda x: evmath.raw2ev20(x, black20),
                  lambda e: evmath.ev2raw20(e, black20, white20, white_ev),
                  lambda x: evmath.fullres_weight(x, black20))


def _per_frame(v):
    return v[:, None, None]


# ------------------------------------------------------------ the twins


def match_plain(imgs, row_bright, a, b20, black20: int) -> torch.Tensor:
    """Promote (B, hh, W) int16 (u16 bits) to 20 bits (hdr.c:825-837) and
    match the exposures (hdr.c:783-809): (B, hh, W) int32."""
    raw = ((imgs.to(torch.int32) & 0xFFFF) << 6) & 0xFFFFF
    pf = raw.to(torch.float32)
    rb = row_bright[:, :, None]
    av, bv = _per_frame(a.to(torch.float32)), _per_frame(b20.to(torch.float32))
    darkened = fma(bv, av, fma(pf - black20, av, float(black20)))
    lifted = fma(bv, av, pf - bv)
    adj = torch.clamp(torch.trunc(torch.where(rb, darkened, lifted)), 0, 0xFFFFF).to(torch.int32)
    return torch.where(raw == 0, 0, adj)


def blend_plain(bright, dark, row_bright, wd, corr_ev, overlap, maps: EvMaps, *, black20: int,
                white20: int, use_fullres: bool):
    """The full-res reconstruction (hdr.c:1355-1380), the half-res EV blend
    (mix_images, hdr.c:1560-1611) and the overexposed mask (hdr.c:1639):
    (fullres, halfres) (B, hh, W) int32 and the mask, bool."""
    rb = row_bright[:, :, None]
    wd3 = _per_frame(wd.to(torch.int32))
    if use_fullres:
        fullres = torch.where(rb, torch.where(bright < wd3, bright, torch.maximum(bright, dark)), dark)
    else:
        fullres = torch.zeros_like(bright)
    ov = _per_frame(overlap.to(torch.float32))
    bright_ev = maps.ev_of(bright)
    dark_ev = maps.ev_of(dark)
    i_f = (bright & 0xFFFFF).to(torch.float32)
    evb = evmath.log2_add(torch.clamp(i_f / 64.0 - black20 / 64.0, min=1.0),
                          _per_frame(corr_ev.to(torch.float32)))
    t = torch.minimum(torch.clamp(evb - (max_ev(black20, white20) - ov), min=0.0), ov)
    cmix = -evmath.cos_f32(t * float(np.float32(math.pi)) / ov)
    k = torch.clamp((cmix + 1) / 2, 0, 1)
    mixed = torch.trunc(fma(bright_ev.to(torch.float32), 1 - k, dark_ev.to(torch.float32) * k)).to(torch.int32)
    over = (bright >= wd3) | (dark >= white20)
    return fullres, maps.ev2raw_at(mixed), over


def alias_planes_plain(bright, fullres_smooth, halfres_smooth, fullres, maps: EvMaps, *, use_alias: bool):
    """The alias map's planes (build_alias_map, hdr.c:1382-1486, up to the
    filter chain, kernel #7): (the fullres curve of the bright frame, the EVs
    of the smoothed half-res and full-res, the EV of the unsmoothed full-res,
    the pre-map int32, its skip mask), the last two None without the alias
    map. ``fullres`` None: the full-res was not smoothed, and its EV is the
    smoothed one's (the same tensor)."""
    f = maps.frcurve_of(bright)
    hs_ev = maps.ev_of(halfres_smooth)
    fs_ev = maps.ev_of(fullres_smooth)
    f_ev = fs_ev if fullres is None else maps.ev_of(fullres)
    if not use_alias:
        return f, hs_ev, fs_ev, f_ev, None, None
    skip = f > FULLRES_THR
    e_lin = torch.clamp((fullres_smooth - halfres_smooth).abs() - int(DARK_NOISE20) * 3 // 2, min=0)
    e_log = (fs_ev - hs_ev).abs()
    alias = torch.minimum(e_lin // 2, e_log // 16).clamp(max=65530)
    return f, hs_ev, fs_ev, f_ev, torch.where(skip, 0, alias).to(torch.int32), skip


def _blur_overexposed(over):
    """3x3-ish integer blur of the overexposure map (hdr.c:1639-1655)."""
    _, h, w = over.shape
    n4 = sum(shift(over, dy, dx) for dx, dy in [(0, -1), (-1, 0), (1, 0), (0, 1)])
    nd = sum(shift(over, dy, dx) for dx, dy in [(-1, -1), (1, -1), (-1, 1), (1, 1)])
    blurred = over + n4 * 820 // 1024 + nd * 657 // 1024
    ys = torch.arange(h, device=over.device)[:, None]
    xs = torch.arange(w, device=over.device)[None, :]
    inner = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(inner, blurred, over)


def final_plain(hs_ev, fs_ev, f_ev, f, alias, over, dark, bright, maps: EvMaps, *, black20: int) -> torch.Tensor:
    """The overexposure blur and the final blend (hdr.c:1639-1772) to 16
    bits: (B, hh, W) int16 (u16 bits). ``alias`` is the filtered map, None
    without the alias map."""
    over = _blur_overexposed(torch.where(over, 100, 0).to(torch.int32))
    hrev = hs_ev.to(torch.float32)
    frev = f_ev.to(torch.float32)
    frsev = fs_ev.to(torch.float32)
    ovf = torch.clamp(over.to(torch.float32) / 200.0, 0, 1)
    c = torch.maximum(torch.clamp(alias.to(torch.float32) / ALIAS_MAP_MAX, 0, 1), ovf) if alias is not None else ovf
    noisy = torch.maximum(ovf, 1 - f)
    f = torch.maximum(f, c)
    fev = fma(noisy, frsev, (1 - noisy) * frev)
    sig = (dark + bright) // 2
    f = torch.clamp(torch.minimum(f, (sig - black20).to(torch.float32) / (4 * DARK_NOISE20)), min=0.0)
    output = torch.trunc(fma(hrev, 1 - f, fev * f)).to(torch.int32)
    output = torch.clamp(output, -10 * EV_RESOLUTION, 14 * EV_RESOLUTION - 1)
    final20 = maps.ev2raw_at(output)
    # 20 → 16 bit; the reference's dither source is never seeded, so its
    # noise is all zero: out = trunc(v/16 + 0.5) (hdr.c:242,1760-1772)
    return to_int16_bits(torch.clamp((final20 + 8) >> 4, 0, 65535))


# ------------------------------------------------------------ the kernels


def _on_card(maps, x: torch.Tensor) -> bool:
    """Whether a stage launches its kernel: on a CUDA tensor under the
    computed transforms. The twin takes the tables on any device and the
    computed transforms on the CPU; any other device raises."""
    if maps is not None or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"dualiso_recon: unsupported device {x.device}")
    return True


def _plane(t: torch.Tensor, dtype, shape, what: str) -> int:
    """The pointer of a contiguous ``dtype`` tensor of ``shape`` (None: NULL)."""
    if t is None:
        return None
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"dualiso_recon: {what} must be a contiguous {dtype} {tuple(shape)} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.data_ptr()


def _launch(entry: str, device, *cargs) -> None:
    global KERNEL_LAUNCHES
    fn = _build.entry("dualiso_recon", entry)
    rc = _build.on_current_stream(device, lambda stream: fn(*cargs, stream))
    if rc != 0:
        raise RuntimeError(f"dualiso_recon kernel {entry} launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    metrics.count("recon.fused_launches")


def _levels(black20: int, white20: int):
    return (int(black20), int(white20), white_ev_of(black20, white20), evmath.zero_ev(int(black20)))


def match(imgs, row_bright, a, b20, *, black20: int, maps: EvMaps = None) -> torch.Tensor:
    """:func:`match_plain` of (B, hh, W) int16 frames whose rows are
    contiguous (a row slice of the batch): one launch on the card."""
    if not _on_card(maps, imgs):
        return match_plain(imgs, row_bright, a, b20, black20)
    b, hh, w = imgs.shape
    if imgs.dtype != torch.int16 or imgs.stride(2) != 1:
        raise ValueError(f"dualiso_recon.match: int16 frames with contiguous rows, got {imgs.dtype} "
                         f"strides {imgs.stride()}")
    out = torch.empty((b, hh, w), dtype=torch.int32, device=imgs.device)
    a, b20 = a.to(torch.float32).contiguous(), b20.to(torch.float32).contiguous()
    _launch("mlvfs_recon_match", imgs.device, out.data_ptr(), imgs.data_ptr(), imgs.stride(0),
            imgs.stride(1), _plane(row_bright, torch.bool, (b, hh), "row_bright"),
            _plane(a, torch.float32, (b,), "a"), _plane(b20, torch.float32, (b,), "b20"),
            b, hh, w, int(black20))
    return out


def blend(bright, dark, row_bright, wd, corr_ev, overlap, *, black20: int, white20: int,
          use_fullres: bool, planes: bool, use_alias: bool, maps: EvMaps = None):
    """:func:`blend_plain`, as (fullres, halfres, over, planes). With
    ``planes`` (no 20-bit chroma smoothing between them) the alias planes of
    that fullres and halfres follow (:func:`alias_planes_plain`) in
    ``planes``, and fullres and halfres are None; without, ``planes`` is
    None. On the card, one launch either way."""
    if not _on_card(maps, bright):
        m = maps or computed_maps(black20, white20)
        fullres, halfres, over = blend_plain(bright, dark, row_bright, wd, corr_ev, overlap, m,
                                             black20=black20, white20=white20, use_fullres=use_fullres)
        if not planes:
            return fullres, halfres, over, None
        return None, None, over, alias_planes_plain(bright, fullres, halfres, None, m, use_alias=use_alias)
    b, hh, w = bright.shape
    dev = bright.device

    def new(dtype):
        return torch.empty((b, hh, w), dtype=dtype, device=dev)

    over = new(torch.bool)
    if planes:
        fullres = halfres = None
        f, hs_ev, fs_ev = new(torch.float32), new(torch.int32), new(torch.int32)
        alias, skip = (new(torch.int32), new(torch.bool)) if use_alias else (None, None)
    else:
        fullres, halfres = new(torch.int32), new(torch.int32)
        f = hs_ev = fs_ev = alias = skip = None
    ptrs = [None if t is None else t.data_ptr() for t in (fullres, halfres, over, f, hs_ev, fs_ev, alias, skip)]
    wd, ce, ov = wd.to(torch.int32).contiguous(), corr_ev.to(torch.float32).contiguous(), \
        overlap.to(torch.float32).contiguous()
    _launch("mlvfs_recon_blend", dev, *ptrs,
            _plane(bright, torch.int32, (b, hh, w), "bright"), _plane(dark, torch.int32, (b, hh, w), "dark"),
            _plane(row_bright, torch.bool, (b, hh), "row_bright"), _plane(wd, torch.int32, (b,), "wd"),
            _plane(ce, torch.float32, (b,), "corr_ev"), _plane(ov, torch.float32, (b,), "overlap"),
            b, hh, w, *_levels(black20, white20), float(max_ev(black20, white20)), int(use_fullres),
            int(planes))
    return fullres, halfres, over, (f, hs_ev, fs_ev, fs_ev, alias, skip) if planes else None


def alias_planes(bright, fullres_smooth, halfres_smooth, fullres, *, black20: int, white20: int,
                 use_alias: bool, maps: EvMaps = None):
    """:func:`alias_planes_plain`: one launch on the card."""
    if not _on_card(maps, bright):
        m = maps or computed_maps(black20, white20)
        return alias_planes_plain(bright, fullres_smooth, halfres_smooth, fullres, m, use_alias=use_alias)
    shape = tuple(bright.shape)
    dev = bright.device

    def new(dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    f, hs_ev, fs_ev = new(torch.float32), new(torch.int32), new(torch.int32)
    f_ev = None if fullres is None else new(torch.int32)
    alias, skip = (new(torch.int32), new(torch.bool)) if use_alias else (None, None)
    _launch("mlvfs_recon_alias_planes", dev,
            *[None if t is None else t.data_ptr() for t in (f, hs_ev, fs_ev, f_ev, alias, skip)],
            *[_plane(t, torch.int32, shape, what) for t, what in (
                (bright, "bright"), (fullres_smooth, "fullres_smooth"), (halfres_smooth, "halfres_smooth"),
                (fullres, "fullres"))],
            math.prod(shape), int(black20))
    return f, hs_ev, fs_ev, fs_ev if f_ev is None else f_ev, alias, skip


def final(hs_ev, fs_ev, f_ev, f, alias, over, dark, bright, *, black20: int, white20: int,
          maps: EvMaps = None) -> torch.Tensor:
    """:func:`final_plain`: one launch on the card."""
    if not _on_card(maps, bright):
        m = maps or computed_maps(black20, white20)
        return final_plain(hs_ev, fs_ev, f_ev, f, alias, over, dark, bright, m, black20=black20)
    b, hh, w = shape = tuple(bright.shape)
    out = torch.empty(shape, dtype=torch.int16, device=bright.device)
    _launch("mlvfs_recon_final", bright.device, out.data_ptr(),
            _plane(hs_ev, torch.int32, shape, "hs_ev"), _plane(fs_ev, torch.int32, shape, "fs_ev"),
            None if f_ev is fs_ev else _plane(f_ev, torch.int32, shape, "f_ev"),
            _plane(f, torch.float32, shape, "f"), _plane(alias, torch.int32, shape, "alias"),
            _plane(over, torch.bool, shape, "over"), _plane(dark, torch.int32, shape, "dark"),
            _plane(bright, torch.int32, shape, "bright"), b, hh, w, *_levels(black20, white20))
    return out
