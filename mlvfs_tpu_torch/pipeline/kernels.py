"""The per-batch device pipeline: composition of processing ops.

Counterpart of ``mlvfs_tpu/pipeline/kernels.py``, the orchestration mirror of
process_frame (main.c:908-1005). Ported so far, in the reference's order:

  decode → deflicker median → pattern noise → dual-ISO preview or full →
  [focus px, bad px (frames not converted)] → chroma smooth → stripes

Per-clip calibration state is computed at the same pipeline position on the
first batch that reaches it: bad-pixel detection on the first frame as
fix_bad_pixels sees it (cs.c:233-312), stripe gains on the fully processed
first frame (main.c:980-996, stripes.c:97-99). With ``--dual-iso-preview``
the reference decides per frame whether the frame is dual-ISO
(main.c:951-973): converted frames get x4 levels, and the others take the
normal-mode fixes and their own levels in every later step
(``mlvfs_tpu/pipeline/kernels.py:79-204``); ``--dual-iso`` likewise, and it
smooths chroma at 20 bits inside the reconstruction, so the 16-bit chroma
step is skipped (frames it did not convert get no smoothing); both of its
interpolations are ported (amaze-edge, the default, and ``--mean23``). With
``--stripes-batch-cal`` the stripe gains come from the whole first batch on
its device, unless that batch mixes converted and unconverted frames
(``mlvfs_tpu/pipeline/kernels.py:165-194``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import metrics
from .config import ProcessingConfig


@dataclasses.dataclass
class ClipCalibration:
    stripes_gains: np.ndarray = None  # (8,) fixed-point gains, FIXP_ONE = 65536
    stripes_needed: bool = False
    stripes_done: bool = False
    bad_pixel_list: np.ndarray = None  # (N, 2) x,y in sensor coords
    bad_pixels_done: bool = False
    focus_pixel_list: np.ndarray = None
    focus_done: bool = False
    dual_iso_rggb: bool = None  # Bayer order is per clip: the first batch's detection
    dual_iso_white20: int = None  # the reconstruction's white level (its tables and
    #                               clamps), fixed by the clip's first converted batch


def calibration_from_reference(cal) -> ClipCalibration:
    """The port's ClipCalibration holding the state of a ``mlvfs_tpu``
    ``ClipCalibration`` (numpy arrays, copied), so both packages can run a
    clip from the same per-clip state."""
    out = ClipCalibration()
    for field in dataclasses.fields(ClipCalibration):
        value = getattr(cal, field.name)
        if isinstance(value, np.ndarray):
            value = value.copy()
        setattr(out, field.name, value)
    return out


@metrics.traced("calibrate")
def calibrate_clip(fh, cfg: ProcessingConfig) -> ClipCalibration:
    """Static (data-independent) calibration: focus pixel map lookup."""
    cal = ClipCalibration()
    if cfg.fix_focus_pixels:
        from ..ops import pixels as pixel_ops

        ri = fh.raw_info
        cal.focus_pixel_list = pixel_ops.load_focus_pixel_map(
            int(fh.idnt["cameraModel"]), ri.width, ri.height, cfg.focus_pixel_dir
        )
    cal.focus_done = True
    return cal


def exposure_bias(medians: np.ndarray, target: int, black: int):
    """Deflicker medians → per-frame BaselineExposure rationals (main.c:895-906)."""
    medians = np.asarray(medians, np.float64)
    corr = np.log2((target - black) / np.maximum(medians - black, 1e-9))
    return [(int(c * 10000), 10000) for c in corr]


def _host_frame(img) -> np.ndarray:
    """One (H, W) int16 device frame → host u16 (a once-per-clip readback)."""
    with metrics.sync("frame"):
        return img.cpu().numpy().view(np.uint16)


def run_pipeline(imgs, fh, cfg: ProcessingConfig, cal: ClipCalibration, info: dict):
    """Apply the configured processing to a decoded batch (B, H, W) int16
    (u16 bits) on its device. Returns (imgs, info).

    With ``--deflicker`` the batch's medians stay on the device as
    ``info["deflicker_medians"]``; the caller turns them into
    ``exposure_bias`` (:func:`exposure_bias`) once they are read back, so
    the batch costs no synchronisation here. With ``--dual-iso-preview`` or
    ``--dual-iso`` and any frame converted, ``info["levels"]`` holds each frame's
    (black, white) and ``info["black_level"]``/``["white_level"]`` the x4
    levels.
    """
    ri = fh.raw_info
    black, white = ri.black_level, ri.white_level
    crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
    crop_y = int(fh.vidf["panPosY"]) & ~1

    if cfg.deflicker:
        from ..ops import histogram as hist_ops

        # deflicker target median → BaselineExposure tag (main.c:895-906)
        info["deflicker_medians"] = hist_ops.deflicker_median(imgs, (1 << ri.bits_per_pixel) + 1)

    if cfg.fix_pattern_noise:
        from ..ops import patternnoise as pn_ops

        imgs = pn_ops.fix_pattern_noise_batch(imgs, white)

    okv = None  # per-frame dual-ISO outcome (None: dual-ISO off)
    if cfg.dual_iso == 1:
        from ..ops import dualiso as di_ops

        imgs, okv = di_ops.hdr_preview_batch(imgs, fh, cal)
    elif cfg.dual_iso == 2:
        from ..ops import dualiso_full as dif_ops

        imgs, okv = dif_ops.cr2hdr20_batch(imgs, fh, cfg, cal)
    any_dual = okv is not None and bool(okv.any())
    mixed = any_dual and not bool(okv.all())
    if any_dual:
        # per-frame levels: frames that failed detection keep their levels
        info["levels"] = [((black * 4, white * 4) if o else (black, white)) for o in okv]
        info["black_level"] = black * 4
        info["white_level"] = white * 4

    def per_frame(hi, lo):
        """Each frame's result: ``hi`` on converted frames, ``lo`` on the others."""
        return torch.where(torch.as_tensor(okv, device=imgs.device)[:, None, None], hi, lo)

    if okv is None or not okv.all():
        # the reference's per-frame else-branch (main.c:966-973): every frame
        # whose dual-ISO conversion did not run gets the normal-mode
        # focus-pixel and bad-pixel fixes, inside a converted batch too
        from ..ops import pixels as pixel_ops

        fixed = imgs
        if cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
            fixed = pixel_ops.fix_pixel_list_batch(
                fixed, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=False
            )
        if cfg.fix_bad_pixels:
            if not cal.bad_pixels_done:
                # detect on the first frame fix_bad_pixels sees (cs.c:233-312):
                # in a mixed batch, the first frame not converted
                i0 = int(np.argmin(okv)) if any_dual else 0
                cal.bad_pixel_list = pixel_ops.detect_bad_pixels(
                    _host_frame(fixed[i0]),
                    width=fh.xres,
                    height=fh.yres,
                    black=black,
                    aggressive=(cfg.fix_bad_pixels == 2),
                    crop_x=crop_x,
                    crop_y=crop_y,
                )
                cal.bad_pixels_done = True
            if cal.bad_pixel_list is not None and len(cal.bad_pixel_list):
                fixed = pixel_ops.fix_pixel_list_batch(
                    fixed, cal.bad_pixel_list, black, crop_x, crop_y, dual_iso=False
                )
        imgs = per_frame(imgs, fixed) if any_dual else fixed

    if cfg.chroma_smooth and cfg.dual_iso != 2:
        # (with --dual-iso the reconstruction smooths at 20 bits)
        from ..ops import chroma_smooth as cs_ops

        m = cfg.chroma_smooth
        if not any_dual:
            imgs = cs_ops.chroma_smooth_batch(imgs, m, black)
        elif not mixed:
            imgs = cs_ops.chroma_smooth_batch(imgs, m, black * 4)
        else:
            # each frame is smoothed under its own black level (main.c:975-978
            # runs on the per-frame header): smooth under both, pick per frame
            imgs = per_frame(cs_ops.chroma_smooth_batch(imgs, m, black * 4),
                             cs_ops.chroma_smooth_batch(imgs, m, black))

    if cfg.fix_stripes:
        from ..ops import stripes as stripes_ops

        if not cal.stripes_done:
            if cfg.stripes_batch_cal and not mixed:
                # the whole first batch on its device, at the batch's levels.
                # The reference pads a short batch to the batch size with its
                # last frame (mlvfs_tpu/pipeline/convert.py:222-223, one
                # compiled shape), and the pads count here: pad it the same way
                short = cfg.batch_size - imgs.shape[0]
                batch = torch.cat([imgs, imgs[-1:].expand(short, -1, -1)]) if short > 0 else imgs
                g_dev, needed_dev = stripes_ops.calibrate_batch_device(
                    batch, info["black_level"], info["white_level"], int(ri.frame_size)
                )
                with metrics.sync("stripes"):
                    cal.stripes_gains, cal.stripes_needed = g_dev.cpu().numpy(), bool(needed_dev)
            else:
                # gains from the first processed frame only, under that
                # frame's own levels (stripes.c:97-99, main.c:980-996); also
                # the fallback for a mixed first batch, which has no one
                # (black, white) pair to price every frame at
                b0, w0 = (info["black_level"], info["white_level"]) if okv is None else (
                    (black * 4, white * 4) if okv[0] else (black, white))
                cal.stripes_gains, cal.stripes_needed = stripes_ops.compute_correction(
                    _host_frame(imgs[0]), b0, w0, fh.xres, frame_size_bytes=ri.frame_size
                )
            cal.stripes_done = True
        if cal.stripes_needed:
            gains = cal.stripes_gains
            if not mixed:
                imgs = stripes_ops.apply_correction_batch(
                    imgs, gains, info["black_level"], info["white_level"]
                )
            else:  # each frame under its own levels
                imgs = per_frame(
                    stripes_ops.apply_correction_batch(imgs, gains, black * 4, white * 4),
                    stripes_ops.apply_correction_batch(imgs, gains, black, white),
                )
    return imgs, info
