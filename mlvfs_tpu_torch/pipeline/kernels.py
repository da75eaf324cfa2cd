"""The per-batch device pipeline: composition of processing ops.

Counterpart of ``mlvfs_tpu/pipeline/kernels.py``, the orchestration mirror of
process_frame (main.c:908-1005). Ported so far, in the reference's order:

  decode → deflicker median → focus px → bad px → chroma smooth → stripes

Per-clip calibration state is computed at the same pipeline position on the
first batch: bad-pixel detection on the first frame as fix_bad_pixels sees it
(cs.c:233-312), stripe gains on the fully processed first frame
(main.c:980-996, stripes.c:97-99). Pattern noise, dual-ISO and the
whole-batch stripe calibration belong to slices that are not ported yet and
are refused with NotImplementedError naming the flag, never passed over
silently. The dual-ISO slice brings the per-frame mixed-batch rules
(``mlvfs_tpu/pipeline/kernels.py:99-204``: per-frame levels and fix gating),
which this port must then reproduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import ProcessingConfig

# config field → CLI flag, for the flags whose slices are not ported yet
_UNPORTED = (
    ("fix_pattern_noise", "--fix-pattern-noise"),
    ("dual_iso", "--dual-iso / --dual-iso-preview"),
    ("stripes_batch_cal", "--stripes-batch-cal"),
)


def check_supported(cfg: ProcessingConfig) -> None:
    """Raise NotImplementedError if ``cfg`` asks for a processing step whose
    slice is not ported to mlvfs_tpu_torch yet."""
    for field, flag in _UNPORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{flag} ({field}={getattr(cfg, field)!r}) is not ported to "
                "mlvfs_tpu_torch yet; use mlvfs_tpu for it"
            )


@dataclasses.dataclass
class ClipCalibration:
    stripes_gains: np.ndarray = None  # (8,) fixed-point gains, FIXP_ONE = 65536
    stripes_needed: bool = False
    stripes_done: bool = False
    bad_pixel_list: np.ndarray = None  # (N, 2) x,y in sensor coords
    bad_pixels_done: bool = False
    focus_pixel_list: np.ndarray = None
    focus_done: bool = False
    dual_iso_rggb: bool = None  # Bayer order is per-clip (dual-ISO slice)
    dual_iso_white20: int = None  # reconstruction white level (dual-ISO slice)


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
    return img.cpu().numpy().view(np.uint16)


def run_pipeline(imgs, fh, cfg: ProcessingConfig, cal: ClipCalibration, info: dict):
    """Apply the configured processing to a decoded batch (B, H, W) int16
    (u16 bits) on its device. Returns (imgs, info).

    With ``--deflicker`` the batch's medians stay on the device as
    ``info["deflicker_medians"]``; the caller turns them into
    ``exposure_bias`` (:func:`exposure_bias`) once they are read back, so
    the batch costs no synchronisation here.
    """
    check_supported(cfg)
    ri = fh.raw_info
    black, white = ri.black_level, ri.white_level
    crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
    crop_y = int(fh.vidf["panPosY"]) & ~1

    if cfg.deflicker:
        from ..ops import histogram as hist_ops

        # deflicker target median → BaselineExposure tag (main.c:895-906)
        info["deflicker_medians"] = hist_ops.deflicker_median(imgs, (1 << ri.bits_per_pixel) + 1)

    from ..ops import pixels as pixel_ops

    if cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        imgs = pixel_ops.fix_pixel_list_batch(
            imgs, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=False
        )
    if cfg.fix_bad_pixels:
        if not cal.bad_pixels_done:
            # detect on the first frame fix_bad_pixels sees (cs.c:233-312)
            cal.bad_pixel_list = pixel_ops.detect_bad_pixels(
                _host_frame(imgs[0]),
                width=fh.xres,
                height=fh.yres,
                black=black,
                aggressive=(cfg.fix_bad_pixels == 2),
                crop_x=crop_x,
                crop_y=crop_y,
            )
            cal.bad_pixels_done = True
        if cal.bad_pixel_list is not None and len(cal.bad_pixel_list):
            imgs = pixel_ops.fix_pixel_list_batch(
                imgs, cal.bad_pixel_list, black, crop_x, crop_y, dual_iso=False
            )

    if cfg.chroma_smooth:
        from ..ops import chroma_smooth as cs_ops

        imgs = cs_ops.chroma_smooth_batch(imgs, cfg.chroma_smooth, black)

    if cfg.fix_stripes:
        from ..ops import stripes as stripes_ops

        if not cal.stripes_done:
            # gains from the first processed frame only (stripes.c:97-99)
            cal.stripes_gains, cal.stripes_needed = stripes_ops.compute_correction(
                _host_frame(imgs[0]),
                info["black_level"],
                info["white_level"],
                fh.xres,
                frame_size_bytes=ri.frame_size,
            )
            cal.stripes_done = True
        if cal.stripes_needed:
            imgs = stripes_ops.apply_correction_batch(
                imgs, cal.stripes_gains, info["black_level"], info["white_level"]
            )
    return imgs, info
