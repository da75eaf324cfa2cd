"""The plain reference's per-batch program: what a take's DNG payloads and
levels must be.

A copy of ``mlvfs_tpu_torch/pipeline/kernels.py`` ``run_pipeline`` (commit
1c20a80), cut to the steps the benchmark's configurations run (deflicker
median, full dual-ISO, bad pixels, chroma smoothing, stripes), over the
plain twins copied beside it. It takes the take's frames as the benchmark
generated them, not the program's unpacked ones, and the camera's fields
from the configuration, not from the program's reader. The 5D Mark III has
no focus pixels, so no focus-pixel map is applied.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import evmath


@dataclasses.dataclass
class Settings:
    """The processing flags of a cell, as ``ProcessingConfig`` spells them."""

    deflicker: int = 0
    chroma_smooth: int = 0
    fix_bad_pixels: int = 0
    fix_stripes: bool = False
    dual_iso: int = 0
    hdr_interpolation_method: int = 0
    hdr_no_fullres: bool = False
    hdr_no_alias_map: bool = False
    batch_size: int = 16
    stripes_batch_cal: bool = False
    exact_luts: bool = False


@dataclasses.dataclass
class Camera:
    """The frame header fields the program reads (black and white level,
    bits, frame bytes, the pan origin)."""

    width: int
    height: int
    bits: int
    black: int
    white: int
    pan_x: int = 0
    pan_y: int = 0

    @property
    def frame_size(self) -> int:
        return self.width * self.height * self.bits // 8


@dataclasses.dataclass
class ClipState:
    stripes_gains: np.ndarray = None
    stripes_needed: bool = False
    stripes_done: bool = False
    bad_pixel_list: np.ndarray = None
    bad_pixels_done: bool = False
    focus_pixel_list: np.ndarray = None
    dual_iso_rggb: bool = None
    dual_iso_white20: int = None


class _Header:
    """The few frame-header fields ``dualiso_full.cr2hdr20_batch`` reads."""

    def __init__(self, cam: Camera):
        self.raw_info = type("RawInfo", (), {"black_level": cam.black, "white_level": cam.white})()
        self.vidf = {"panPosX": cam.pan_x, "panPosY": cam.pan_y}


def exposure_bias(medians: np.ndarray, target: int, black: int):
    """Deflicker medians → per-frame BaselineExposure rationals (main.c:895-906)."""
    medians = np.asarray(medians, np.float64)
    corr = np.log2((target - black) / np.maximum(medians - black, 1e-9))
    return [(int(c * 10000), 10000) for c in corr]


def _fma_float32(x, y, z):
    """x * y + z in float32 with two roundings: the control's precision."""
    return x * y + z


@contextlib.contextmanager
def float32_products():
    """Run the reference with every fused multiply-add of its float32 stages
    (the EV transforms, AMaZE, the stripe fit) rounded twice, as plain
    float32 does: the next precision below the configuration's exact
    products, and the control of the dual-ISO cells."""
    exact = evmath.fma_f32
    evmath.fma_f32 = _fma_float32
    try:
        yield
    finally:
        evmath.fma_f32 = exact


def run_batch(imgs: torch.Tensor, cam: Camera, cfg: Settings, state: ClipState):
    """Process one batch (B, H, W) int16 (u16 bits) on its device as the
    take's batches are processed in order. Returns (imgs, levels, bias):
    the (B, H, W) int16 output, each frame's (black, white), and each
    frame's BaselineExposure rational (None without ``deflicker``)."""
    from . import pixels as pixel_ops

    black, white = cam.black, cam.white
    crop_x = (cam.pan_x + 7) & ~7
    crop_y = cam.pan_y & ~1
    levels_black, levels_white = black, white
    medians = None
    if cfg.deflicker:
        from . import histogram

        medians = histogram.deflicker_median(imgs, (1 << cam.bits) + 1)

    okv = None
    if cfg.dual_iso == 2:
        from . import dualiso_full

        imgs, okv = dualiso_full.cr2hdr20_batch(imgs, _Header(cam), cfg, state)
    elif cfg.dual_iso:
        raise ValueError("the reference carries the full dual-ISO path only")
    any_dual = okv is not None and bool(okv.any())
    mixed = any_dual and not bool(okv.all())
    if any_dual:
        levels_black, levels_white = black * 4, white * 4
    frame_levels = ([((black * 4, white * 4) if o else (black, white)) for o in okv]
                    if any_dual else [(black, white)] * imgs.shape[0])

    def per_frame(hi, lo):
        return torch.where(torch.as_tensor(okv, device=imgs.device)[:, None, None], hi, lo)

    if okv is None or not okv.all():
        fixed = imgs
        if cfg.fix_bad_pixels:
            if not state.bad_pixels_done:
                i0 = int(np.argmin(okv)) if any_dual else 0
                state.bad_pixel_list = pixel_ops.detect_bad_pixels(
                    fixed[i0].cpu().numpy().view(np.uint16), width=cam.width, height=cam.height,
                    black=black, aggressive=(cfg.fix_bad_pixels == 2), crop_x=crop_x, crop_y=crop_y,
                )
                state.bad_pixels_done = True
            if state.bad_pixel_list is not None and len(state.bad_pixel_list):
                fixed = pixel_ops.fix_pixel_list_batch(
                    fixed, state.bad_pixel_list, black, crop_x, crop_y, dual_iso=False
                )
        imgs = per_frame(imgs, fixed) if any_dual else fixed

    if cfg.chroma_smooth and cfg.dual_iso != 2:
        from . import chroma_smooth as cs

        m = cfg.chroma_smooth
        if not any_dual:
            imgs = cs.chroma_smooth_batch(imgs, m, black)
        elif not mixed:
            imgs = cs.chroma_smooth_batch(imgs, m, black * 4)
        else:
            imgs = per_frame(cs.chroma_smooth_batch(imgs, m, black * 4),
                             cs.chroma_smooth_batch(imgs, m, black))

    if cfg.fix_stripes:
        from . import stripes

        if not state.stripes_done:
            if cfg.stripes_batch_cal and not mixed:
                short = cfg.batch_size - imgs.shape[0]
                batch = torch.cat([imgs, imgs[-1:].expand(short, -1, -1)]) if short > 0 else imgs
                g_dev, needed_dev = stripes.calibrate_batch_device(
                    batch, levels_black, levels_white, cam.frame_size)
                state.stripes_gains, state.stripes_needed = g_dev.cpu().numpy(), bool(needed_dev)
            else:
                b0, w0 = (levels_black, levels_white) if okv is None else (
                    (black * 4, white * 4) if okv[0] else (black, white))
                state.stripes_gains, state.stripes_needed = stripes.compute_correction(
                    imgs[0].cpu().numpy().view(np.uint16), b0, w0, cam.width,
                    frame_size_bytes=cam.frame_size)
            state.stripes_done = True
        if state.stripes_needed:
            gains = state.stripes_gains
            if not mixed:
                imgs = stripes.apply_correction_batch(imgs, gains, levels_black, levels_white)
            else:
                imgs = per_frame(stripes.apply_correction_batch(imgs, gains, black * 4, white * 4),
                                 stripes.apply_correction_batch(imgs, gains, black, white))
    bias = None
    if medians is not None:
        bias = exposure_bias(medians.cpu().numpy(), cfg.deflicker, black)
    return imgs, frame_levels, bias
