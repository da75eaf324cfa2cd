"""The per-batch device pipeline: composition of processing ops.

Counterpart of ``mlvfs_tpu/pipeline/kernels.py`` for the default config,
the orchestration mirror of process_frame (main.c:908-1005). Ported so far:
decode → [focus px]. Every other processing flag belongs to a slice that is
not ported yet and is refused with NotImplementedError naming the flag,
never passed over silently.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import ProcessingConfig

# config field → CLI flag, for the flags whose slices are not ported yet
_UNPORTED = (
    ("deflicker", "--deflicker"),
    ("fix_pattern_noise", "--fix-pattern-noise"),
    ("dual_iso", "--dual-iso / --dual-iso-preview"),
    ("fix_bad_pixels", "--bad-pix / --really-bad-pix"),
    ("chroma_smooth", "--cs2x2 / --cs3x3 / --cs5x5"),
    ("fix_stripes", "--stripes"),
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


def run_pipeline(imgs, fh, cfg: ProcessingConfig, cal: ClipCalibration, info: dict):
    """Apply the configured processing to a decoded batch (B, H, W) int16
    (u16 bits) on its device. Returns (imgs, info)."""
    check_supported(cfg)
    black = fh.raw_info.black_level
    crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
    crop_y = int(fh.vidf["panPosY"]) & ~1

    if cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        from ..ops import pixels as pixel_ops

        imgs = pixel_ops.fix_pixel_list_batch(
            imgs, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=False
        )
    return imgs, info
