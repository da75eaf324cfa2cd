"""MLV container format model.

Binary layouts of all Magic Lantern Video block types, expressed as NumPy
structured dtypes (little-endian, packed — the reference uses
``#pragma pack(push,1)``).

Reference: mlvfs/mlv.h:42-237 (block structs), mlvfs/raw.h:166-207
(struct raw_info, embedded in RAWI).

This module is pure NumPy/stdlib: it is the bottom layer everything else sits
on, and it also powers the synthetic clip generator used by the test suite.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# videoClass / audioClass flags (mlv.h:24-34)
MLV_VIDEO_CLASS_RAW = 0x01
MLV_VIDEO_CLASS_YUV = 0x02
MLV_VIDEO_CLASS_JPEG = 0x03
MLV_VIDEO_CLASS_H264 = 0x04
MLV_VIDEO_CLASS_FLAG_LJ92 = 0x100
MLV_VIDEO_CLASS_FLAG_LZMA = 0x80
MLV_VIDEO_CLASS_FLAG_DELTA = 0x40
MLV_AUDIO_CLASS_FLAG_LZMA = 0x80

# xref frame types (mlv.h:36-38)
FRAME_UNSPECIFIED = 0
FRAME_VIDF = 1
FRAME_AUDF = 2

_u8, _u16, _u32, _u64 = "<u1", "<u2", "<u4", "<u8"
_i16, _i32 = "<i2", "<i4"


def _dt(fields):
    return np.dtype(fields)


# Generic 16-byte block header (mlv.h:42-46)
HDR = _dt([("blockType", "S4"), ("blockSize", _u32), ("timestamp", _u64)])

# struct raw_info (raw.h:166-207) — forty int32 words, 160 bytes.
RAW_INFO = _dt(
    [
        ("api_version", _u32),
        ("buffer", _u32),  # 'do_not_use_this' on 64-bit builds
        ("height", _i32),
        ("width", _i32),
        ("pitch", _i32),
        ("frame_size", _i32),
        ("bits_per_pixel", _i32),
        ("black_level", _i32),
        ("white_level", _i32),
        # union: DNG JPEG info / crop — (x, y, width, height)
        ("crop_x", _i32),
        ("crop_y", _i32),
        ("crop_width", _i32),
        ("crop_height", _i32),
        # union: DNG active sensor area (y1, x1, y2, x2)
        ("active_y1", _i32),
        ("active_x1", _i32),
        ("active_y2", _i32),
        ("active_x2", _i32),
        ("exposure_bias", _i32, (2,)),
        ("cfa_pattern", _i32),
        ("calibration_illuminant1", _i32),
        ("color_matrix1", _i32, (18,)),
        ("dynamic_range", _i32),
    ]
)
assert RAW_INFO.itemsize == 160

# MLVI (mlv.h:48-62)
MLVI = _dt(
    [
        ("fileMagic", "S4"),
        ("blockSize", _u32),
        ("versionString", "S8"),
        ("fileGuid", _u64),
        ("fileNum", _u16),
        ("fileCount", _u16),
        ("fileFlags", _u32),
        ("videoClass", _u16),
        ("audioClass", _u16),
        ("videoFrameCount", _u32),
        ("audioFrameCount", _u32),
        ("sourceFpsNom", _u32),
        ("sourceFpsDenom", _u32),
    ]
)
assert MLVI.itemsize == 52

# VIDF (mlv.h:64-75)
VIDF = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("frameNumber", _u32),
        ("cropPosX", _u16),
        ("cropPosY", _u16),
        ("panPosX", _u16),
        ("panPosY", _u16),
        ("frameSpace", _u32),
    ]
)
assert VIDF.itemsize == 32

# AUDF (mlv.h:77-84)
AUDF = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("frameNumber", _u32),
        ("frameSpace", _u32),
    ]
)
assert AUDF.itemsize == 24

# RAWI (mlv.h:86-93)
RAWI = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("xRes", _u16),
        ("yRes", _u16),
        ("raw_info", RAW_INFO),
    ]
)
assert RAWI.itemsize == 180

# WAVI (mlv.h:95-105)
WAVI = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("format", _u16),
        ("channels", _u16),
        ("samplingRate", _u32),
        ("bytesPerSecond", _u32),
        ("blockAlign", _u16),
        ("bitsPerSample", _u16),
    ]
)
assert WAVI.itemsize == 32

# EXPO (mlv.h:107-116)
EXPO = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("isoMode", _u32),
        ("isoValue", _u32),
        ("isoAnalog", _u32),
        ("digitalGain", _u32),
        ("shutterValue", _u64),
    ]
)
assert EXPO.itemsize == 40

# LENS (mlv.h:118-131)
LENS = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("focalLength", _u16),
        ("focalDist", _u16),
        ("aperture", _u16),
        ("stabilizerMode", _u8),
        ("autofocusMode", _u8),
        ("flags", _u32),
        ("lensID", _u32),
        ("lensName", "S32"),
        ("lensSerial", "S32"),
    ]
)
assert LENS.itemsize == 96

# RTCI (mlv.h:133-148)
RTCI = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("tm_sec", _u16),
        ("tm_min", _u16),
        ("tm_hour", _u16),
        ("tm_mday", _u16),
        ("tm_mon", _u16),
        ("tm_year", _u16),
        ("tm_wday", _u16),
        ("tm_yday", _u16),
        ("tm_isdst", _u16),
        ("tm_gmtoff", _u16),
        ("tm_zone", "S8"),
    ]
)
assert RTCI.itemsize == 44

# IDNT (mlv.h:150-157)
IDNT = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("cameraName", "S32"),
        ("cameraModel", _u32),
        ("cameraSerial", "S32"),
    ]
)
assert IDNT.itemsize == 84

# XREF table entry (mlv.h:159-164)
XREF_ENTRY = _dt(
    [
        ("fileNumber", _u16),
        ("empty", _u8),
        ("frameType", _u8),
        ("frameOffset", _u64),
    ]
)
assert XREF_ENTRY.itemsize == 12

# XREF block header (mlv.h:166-173)
XREF = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("frameType", _u32),
        ("entryCount", _u32),
    ]
)
assert XREF.itemsize == 24

# INFO (mlv.h:175-180)
INFO = _dt([("blockType", "S4"), ("blockSize", _u32), ("timestamp", _u64)])

# DISO (mlv.h:182-188)
DISO = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("dualMode", _u32),
        ("isoValue", _u32),
    ]
)

# MARK (mlv.h:190-195)
MARK = _dt([("blockType", "S4"), ("blockSize", _u32), ("timestamp", _u64), ("type", _u32)])

# STYL (mlv.h:197-207)
STYL = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("picStyleId", _u32),
        ("contrast", _i32),
        ("sharpness", _i32),
        ("saturation", _i32),
        ("colortone", _i32),
        ("picStyleName", "S16"),
    ]
)

# ELVL (mlv.h:209-215)
ELVL = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("roll", _u32),
        ("pitch", _u32),
    ]
)

# WBAL (mlv.h:217-228)
WBAL = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("wb_mode", _u32),
        ("kelvin", _u32),
        ("wbgain_r", _u32),
        ("wbgain_g", _u32),
        ("wbgain_b", _u32),
        ("wbs_gm", _u32),
        ("wbs_ba", _u32),
    ]
)
assert WBAL.itemsize == 44

# DEBG (mlv.h:230-237)
DEBG = _dt(
    [
        ("blockType", "S4"),
        ("blockSize", _u32),
        ("timestamp", _u64),
        ("type", _u32),
        ("length", _u32),
    ]
)

BLOCK_DTYPES = {
    b"MLVI": MLVI,
    b"VIDF": VIDF,
    b"AUDF": AUDF,
    b"RAWI": RAWI,
    b"WAVI": WAVI,
    b"EXPO": EXPO,
    b"LENS": LENS,
    b"RTCI": RTCI,
    b"IDNT": IDNT,
    b"XREF": XREF,
    b"INFO": INFO,
    b"DISO": DISO,
    b"MARK": MARK,
    b"STYL": STYL,
    b"ELVL": ELVL,
    b"WBAL": WBAL,
    b"DEBG": DEBG,
}

# WB modes (dng.c:46-58, mlv.h:221)
WB_AUTO = 0
WB_SUNNY = 1
WB_CLOUDY = 2
WB_TUNGSTEN = 3
WB_FLUORESCENT = 4
WB_FLASH = 5
WB_CUSTOM = 6
WB_SHADE = 8
WB_KELVIN = 9


def parse_block(buf, offset=0, dtype=None):
    """Parse one block at ``offset`` in ``buf`` (bytes-like).

    Returns a zero-copy NumPy record. When ``dtype`` is None it is chosen from
    the 4-byte block type; unknown types return just the generic header. Like
    the reference (index.c:258 ``MIN(sizeof(...), blockSize)``), a block that
    is shorter on disk than our struct is zero-extended.
    """
    magic = bytes(buf[offset : offset + 4])
    if dtype is None:
        dtype = BLOCK_DTYPES.get(magic, HDR)
    size_on_disk = int(np.frombuffer(buf, _u32, 1, offset + 4)[0])
    take = min(dtype.itemsize, size_on_disk)
    if take == dtype.itemsize:
        return np.frombuffer(buf, dtype, 1, offset)[0]
    raw = bytes(buf[offset : offset + take]) + b"\0" * (dtype.itemsize - take)
    return np.frombuffer(raw, dtype, 1, 0)[0]


def new_block(dtype, block_type):
    """Allocate a zeroed block record with blockType/blockSize filled in."""
    rec = np.zeros((), dtype)
    names = dtype.names
    if "blockType" in names:
        rec["blockType"] = block_type
    elif "fileMagic" in names:
        rec["fileMagic"] = block_type
    rec["blockSize"] = dtype.itemsize
    return rec


@dataclasses.dataclass
class RawInfo:
    """Pythonic view of struct raw_info (raw.h:166-207)."""

    width: int = 0
    height: int = 0
    pitch: int = 0
    frame_size: int = 0
    bits_per_pixel: int = 14
    black_level: int = 2048
    white_level: int = 15000
    crop_origin: tuple = (0, 0)
    crop_size: tuple = (0, 0)
    active_area: tuple = (0, 0, 0, 0)  # y1, x1, y2, x2
    exposure_bias: tuple = (0, 0)
    cfa_pattern: int = 0x02010100  # RGGB
    calibration_illuminant1: int = 1
    color_matrix1: tuple = tuple([0] * 18)
    dynamic_range: int = 1100

    @classmethod
    def from_record(cls, rec) -> "RawInfo":
        return cls(
            width=int(rec["width"]),
            height=int(rec["height"]),
            pitch=int(rec["pitch"]),
            frame_size=int(rec["frame_size"]),
            bits_per_pixel=int(rec["bits_per_pixel"]),
            black_level=int(rec["black_level"]),
            white_level=int(rec["white_level"]),
            crop_origin=(int(rec["crop_x"]), int(rec["crop_y"])),
            crop_size=(int(rec["crop_width"]), int(rec["crop_height"])),
            active_area=(
                int(rec["active_y1"]),
                int(rec["active_x1"]),
                int(rec["active_y2"]),
                int(rec["active_x2"]),
            ),
            exposure_bias=(int(rec["exposure_bias"][0]), int(rec["exposure_bias"][1])),
            cfa_pattern=int(rec["cfa_pattern"]) & 0xFFFFFFFF,
            calibration_illuminant1=int(rec["calibration_illuminant1"]),
            color_matrix1=tuple(int(v) for v in rec["color_matrix1"]),
            dynamic_range=int(rec["dynamic_range"]),
        )

    def to_record(self):
        rec = np.zeros((), RAW_INFO)
        rec["api_version"] = 1
        rec["width"] = self.width
        rec["height"] = self.height
        rec["pitch"] = self.pitch
        rec["frame_size"] = self.frame_size
        rec["bits_per_pixel"] = self.bits_per_pixel
        rec["black_level"] = self.black_level
        rec["white_level"] = self.white_level
        rec["crop_x"], rec["crop_y"] = self.crop_origin
        rec["crop_width"], rec["crop_height"] = self.crop_size
        rec["active_y1"], rec["active_x1"], rec["active_y2"], rec["active_x2"] = self.active_area
        rec["exposure_bias"] = self.exposure_bias
        rec["cfa_pattern"] = np.uint32(self.cfa_pattern).view(np.int32)
        rec["calibration_illuminant1"] = self.calibration_illuminant1
        rec["color_matrix1"] = self.color_matrix1
        rec["dynamic_range"] = self.dynamic_range
        return rec


@dataclasses.dataclass
class FrameHeaders:
    """All MLV blocks associated with one video frame.

    Equivalent of struct frame_headers (mlvfs.h:51-63): the metadata snapshot
    in effect at the frame's position in the timestamp-ordered block stream.
    Records are NumPy scalars of the dtypes above.
    """

    file_number: int
    position: int
    vidf: np.void
    mlvi: np.void
    rtci: np.void
    idnt: np.void
    rawi: np.void
    expo: np.void
    lens: np.void
    wbal: np.void

    @property
    def raw_info(self) -> RawInfo:
        return RawInfo.from_record(self.rawi["raw_info"])

    @property
    def xres(self) -> int:
        return int(self.rawi["xRes"])

    @property
    def yres(self) -> int:
        return int(self.rawi["yRes"])

    @property
    def video_class(self) -> int:
        return int(self.mlvi["videoClass"])

    @property
    def compression(self) -> str:
        vc = self.video_class
        if vc & MLV_VIDEO_CLASS_FLAG_LZMA:
            return "lzma"
        if vc & MLV_VIDEO_CLASS_FLAG_LJ92:
            return "lj92"
        return "none"

    @property
    def fps(self) -> float:
        denom = int(self.mlvi["sourceFpsDenom"])
        return int(self.mlvi["sourceFpsNom"]) / denom if denom else 0.0
