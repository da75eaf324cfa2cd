"""Writes one uncompressed MLV take from frames packed on the card.

The block layouts are Magic Lantern's (mlv.h:42-237, raw.h:166-207), the
same bytes ``mlvfs_tpu_torch/format/synth.py`` ``write_mlv`` writes for an
uncompressed clip without audio, kept here so that the benchmark's inputs do
not change with the program's own writer. Frames arrive as packed 16-bit
word streams, one ``writev`` a frame.
"""

from __future__ import annotations

import os

import numpy as np

_u8, _u16, _u32, _u64, _i32 = "<u1", "<u2", "<u4", "<u8", "<i4"
_HDR = [("blockType", "S4"), ("blockSize", _u32), ("timestamp", _u64)]

RAW_INFO = np.dtype([
    ("api_version", _u32), ("buffer", _u32), ("height", _i32), ("width", _i32), ("pitch", _i32),
    ("frame_size", _i32), ("bits_per_pixel", _i32), ("black_level", _i32), ("white_level", _i32),
    ("crop_x", _i32), ("crop_y", _i32), ("crop_width", _i32), ("crop_height", _i32),
    ("active_y1", _i32), ("active_x1", _i32), ("active_y2", _i32), ("active_x2", _i32),
    ("exposure_bias", _i32, (2,)), ("cfa_pattern", _i32), ("calibration_illuminant1", _i32),
    ("color_matrix1", _i32, (18,)), ("dynamic_range", _i32),
])
MLVI = np.dtype([
    ("fileMagic", "S4"), ("blockSize", _u32), ("versionString", "S8"), ("fileGuid", _u64),
    ("fileNum", _u16), ("fileCount", _u16), ("fileFlags", _u32), ("videoClass", _u16),
    ("audioClass", _u16), ("videoFrameCount", _u32), ("audioFrameCount", _u32),
    ("sourceFpsNom", _u32), ("sourceFpsDenom", _u32),
])
VIDF = np.dtype(_HDR + [
    ("frameNumber", _u32), ("cropPosX", _u16), ("cropPosY", _u16), ("panPosX", _u16),
    ("panPosY", _u16), ("frameSpace", _u32),
])
RAWI = np.dtype(_HDR + [("xRes", _u16), ("yRes", _u16), ("raw_info", RAW_INFO)])
EXPO = np.dtype(_HDR + [
    ("isoMode", _u32), ("isoValue", _u32), ("isoAnalog", _u32), ("digitalGain", _u32),
    ("shutterValue", _u64),
])
LENS = np.dtype(_HDR + [
    ("focalLength", _u16), ("focalDist", _u16), ("aperture", _u16), ("stabilizerMode", _u8),
    ("autofocusMode", _u8), ("flags", _u32), ("lensID", _u32), ("lensName", "S32"),
    ("lensSerial", "S32"),
])
RTCI = np.dtype(_HDR + [(n, _u16) for n in (
    "tm_sec", "tm_min", "tm_hour", "tm_mday", "tm_mon", "tm_year", "tm_wday", "tm_yday",
    "tm_isdst", "tm_gmtoff")] + [("tm_zone", "S8")])
IDNT = np.dtype(_HDR + [("cameraName", "S32"), ("cameraModel", _u32), ("cameraSerial", "S32")])
WBAL = np.dtype(_HDR + [(n, _u32) for n in (
    "wb_mode", "kelvin", "wbgain_r", "wbgain_g", "wbgain_b", "wbs_gm", "wbs_ba")])
DISO = np.dtype(_HDR + [("dualMode", _u32), ("isoValue", _u32)])
assert (RAW_INFO.itemsize, MLVI.itemsize, VIDF.itemsize, RAWI.itemsize) == (160, 52, 32, 180)

MLV_VIDEO_CLASS_RAW = 0x01
WB_KELVIN = 9  # the white-balance mode synth's clips carry (mlv.h)


def _block(dtype, tag: bytes, ts: int):
    rec = np.zeros((), dtype)
    rec["blockType"] = tag
    rec["blockSize"] = dtype.itemsize
    rec["timestamp"] = ts
    return rec


def header_bytes(cam: dict, frames: int, width: int, height: int, dual_iso_ev: int) -> bytes:
    """The MLVI header and the metadata blocks of a take (what
    ``synth.write_mlv`` writes before its first frame)."""
    mlvi = np.zeros((), MLVI)
    mlvi["fileMagic"], mlvi["blockSize"] = b"MLVI", MLVI.itemsize
    mlvi["versionString"] = b"v2.0"
    mlvi["fileGuid"] = int(cam["guid"], 16)
    mlvi["fileCount"] = 1
    mlvi["videoClass"] = MLV_VIDEO_CLASS_RAW
    mlvi["videoFrameCount"] = frames
    mlvi["sourceFpsNom"], mlvi["sourceFpsDenom"] = cam["fps_nom"], cam["fps_denom"]

    ts = 1000
    bpp, black, white = cam["bits_per_pixel"], cam["black_level"], cam["white_level"]
    rawi = _block(RAWI, b"RAWI", ts)
    rawi["xRes"], rawi["yRes"] = width, height
    ri = rawi["raw_info"]
    ri["api_version"] = 1
    ri["width"], ri["height"] = width, height
    ri["pitch"], ri["frame_size"] = width * bpp // 8, width * height * bpp // 8
    ri["bits_per_pixel"], ri["black_level"], ri["white_level"] = bpp, black, white
    ri["crop_width"], ri["crop_height"] = width, height
    ri["active_y2"], ri["active_x2"] = height, width
    ri["cfa_pattern"] = np.uint32(0x02010100).view(np.int32)  # RGGB
    ri["calibration_illuminant1"] = 1
    ri["dynamic_range"] = 1100

    idnt = _block(IDNT, b"IDNT", ts + 10)
    idnt["cameraName"] = cam["camera_name"].encode()
    idnt["cameraModel"] = int(cam["camera_model"], 16)
    idnt["cameraSerial"] = cam["camera_serial"].encode()
    expo = _block(EXPO, b"EXPO", ts + 20)
    expo["isoValue"] = expo["isoAnalog"] = cam["iso"]
    expo["shutterValue"] = cam["shutter_us"]
    lens = _block(LENS, b"LENS", ts + 30)
    lens["focalLength"], lens["focalDist"], lens["aperture"] = cam["focal_length"], 65535, cam["aperture"]
    lens["lensName"] = cam["lens_name"].encode()
    lens["lensSerial"] = b"0000000000"
    rtci = _block(RTCI, b"RTCI", ts + 40)
    rtci["tm_sec"], rtci["tm_min"], rtci["tm_hour"] = 30, 15, 12
    rtci["tm_mday"], rtci["tm_mon"], rtci["tm_year"] = 15, 5, 115
    rtci["tm_wday"], rtci["tm_yday"] = 1, 165
    rtci["tm_zone"] = b"UTC"
    wbal = _block(WBAL, b"WBAL", ts + 50)
    wbal["wb_mode"], wbal["kelvin"] = WB_KELVIN, cam["kelvin"]
    wbal["wbgain_r"] = wbal["wbgain_g"] = wbal["wbgain_b"] = 1024
    blocks = [mlvi, rawi, idnt, expo, lens, rtci, wbal]
    if dual_iso_ev:
        diso = _block(DISO, b"DISO", ts + 60)
        diso["dualMode"], diso["isoValue"] = 1, cam["iso"] * (1 << dual_iso_ev)
        blocks.append(diso)
    return b"".join(b.tobytes() for b in blocks)


def vidf_headers(frames: int, payload_bytes: int, fps_nom: int, fps_denom: int) -> np.ndarray:
    """(frames, 32) uint8: each frame's VIDF block header."""
    interval = int(1e6 / (fps_nom / fps_denom))
    hdr = np.zeros(frames, VIDF)
    hdr["blockType"] = b"VIDF"
    hdr["blockSize"] = VIDF.itemsize + payload_bytes
    hdr["timestamp"] = 100000 + np.arange(frames, dtype=np.uint64) * interval
    hdr["frameNumber"] = np.arange(frames)
    return hdr.view(np.uint8).reshape(frames, VIDF.itemsize)


def write_take(path: str, header: bytes, vidf: np.ndarray, payloads) -> int:
    """Write the take: ``header``, then each frame's VIDF header and packed
    payload (an iterable of (k, uint8 array) in frame order). Returns the
    bytes written."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    n = 0
    try:
        n += os.write(fd, header)
        for k, payload in payloads:
            n += os.writev(fd, [vidf[k], payload])
    finally:
        os.close(fd)
    return n
