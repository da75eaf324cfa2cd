"""Animated GIF preview.

10 frames sampled evenly across the clip, 4x downscaled by green-pixel
sampling, 7-bit grayscale log-gamma palette, emitted as "uncompressed GIF"
(LZW clear code every sub-block). Same parameters and exact output size as
the reference (gif.c:29-38 constants, gif_get_data gif.c:82-220,
gif_get_size gif.c:222-234).

The per-frame decode runs through the normal device unpack path; the gamma
mapping and downsample are vectorized NumPy.
"""

from __future__ import annotations

import struct

import numpy as np

BPP = 7
COLOR_TABLE_SIZE = (1 << BPP) * 3
LZW_CC = 1 << BPP
LZW_EOI = (1 << BPP) + 1
SUB_BLOCK_SIZE = (1 << BPP) - 2
FRAME_COUNT = 10
DOWNSCALE = 4

_ANIMATION_APP_BLOCK = bytes(
    [0x21, 0xFF, 0x0B] + list(b"NETSCAPE2.0") + [0x03, 0x01, 0x00, 0x00, 0x00]
)
_GRAPHICS_BLOCK = bytes([0x21, 0xF9, 0x04, 0x00, 0x32, 0x00, 0x00, 0x00])  # 0.5s delay
_HEADER_SIZE = 13 + COLOR_TABLE_SIZE
_IMAGE_DESC_SIZE = 11


def gif_frame_ids(frame_count: int) -> list:
    """The preview's evenly-spaced source-frame indices (gif.c:186 map,
    ``frame_idx = g * frame_count / FRAME_COUNT``). Single source of truth
    for callers that pre-decode the sampled frames for ``build_gif``."""
    return [g * frame_count // FRAME_COUNT for g in range(FRAME_COUNT)]


def gif_size(xres: int, yres: int) -> int:
    """Exact output size (gif_get_size, gif.c:222-234)."""
    width, height = xres // DOWNSCALE, yres // DOWNSCALE
    header_size = _HEADER_SIZE + len(_ANIMATION_APP_BLOCK)
    frame_header_size = len(_GRAPHICS_BLOCK) + _IMAGE_DESC_SIZE
    pixels = width * height + 1
    lzw_overhead = (pixels // (SUB_BLOCK_SIZE - 1) + 1) * 2
    frame_size = frame_header_size + pixels + lzw_overhead + 1
    return header_size + FRAME_COUNT * frame_size + 1


def _gamma_lut(black_level: int) -> np.ndarray:
    """7-bit log-gamma LUT over 10-bit input (gif.c:103-107)."""
    i = np.arange(1024, dtype=np.float64)
    bl = black_level >> 4
    with np.errstate(divide="ignore"):
        g = np.where(i > bl, np.log2(np.maximum(i - bl, 1e-9)) * 255 / 10, 0)
    g = g.astype(np.float32).astype(np.int64)  # C: log2f → int truncation via uint8 math
    g = np.where(i > bl, g, 0)
    return ((g * g) // 255 // 2).astype(np.uint8)


def _encode_frame(indices: np.ndarray, width: int, height: int) -> bytes:
    """Uncompressed-GIF encode: clear code + pixel byte per code, EOI at end."""
    out = bytearray()
    stream = indices.ravel()
    pos = 0
    block = bytearray([0, LZW_CC])  # [size placeholder, clear code]
    for value in stream:
        block.append(value)
        if len(block) - 1 == SUB_BLOCK_SIZE:
            block[0] = SUB_BLOCK_SIZE
            out += block
            block = bytearray([0, LZW_CC])
    block.append(LZW_EOI)
    block[0] = len(block) - 1
    out += block
    out.append(0x00)  # block terminator
    return bytes(out)


def build_gif(clip, decode_fn) -> bytes:
    """Animated preview for a clip.

    ``decode_fn(frame_index) -> (H, W) uint16`` supplies the decoded frames
    (the converter passes its device decode of ``gif_frame_ids``).

    A clip with no video frames yields an empty preview, matching the
    reference: create_preview's mlv_get_frame_headers(path, 0) fails there,
    leaving the virtual _PREVIEW.gif zero-sized (main.c:1016-1023).
    """
    if clip.frame_count == 0:
        return b""
    fh = clip.frame_headers(0)
    xres, yres = fh.xres, fh.yres
    width, height = xres // DOWNSCALE, yres // DOWNSCALE
    black = fh.raw_info.black_level
    gamma = _gamma_lut(black)

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HH", width, height)
    out += bytes([0xF6, 0, 0])  # packed, background index, aspect
    # grayscale 127-color table stepping by 2 (gif.c:119-129)
    for i in range(COLOR_TABLE_SIZE // 3):
        level = (i * 2) & 0xFF
        out += bytes([level, level, level])
    out += _ANIMATION_APP_BLOCK

    image_descriptor = struct.pack("<BHHHHBB", 0x2C, 0, 0, width, height, 0x00, BPP)
    for frame_idx in gif_frame_ids(clip.frame_count):
        img = np.asarray(decode_fn(frame_idx))
        # sample the green pixel of every DOWNSCALE x DOWNSCALE cell:
        # image_data[y*4*width*4 + x*4 + 1] (gif.c:187)
        rows = (np.arange(height) * DOWNSCALE * width * DOWNSCALE)
        cols = np.arange(width) * DOWNSCALE + 1
        flat = img.ravel()
        sampled = flat[rows[:, None] + cols[None, :]]
        indices = gamma[np.minimum(sampled >> 4, 1023)]
        out += _GRAPHICS_BLOCK
        out += image_descriptor
        out += _encode_frame(indices, width, height)
    out.append(0x3B)  # GIF EOF
    # The reference sizes the virtual file with gif_get_size, which can
    # overcount the sub-block overhead by 2 bytes per frame in edge cases;
    # pad so our file size always equals the advertised size.
    target = gif_size(xres, yres)
    assert len(out) <= target, (len(out), target)
    out += b"\0" * (target - len(out))
    return bytes(out)
