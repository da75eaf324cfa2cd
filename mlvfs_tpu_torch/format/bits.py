"""Bit packing/unpacking of raw Bayer bitstreams (host-side NumPy reference).

Encoding (raw.h:41-52): pixels are packed MSB-first into a stream of 16-bit
little-endian words; e.g. at 14bpp, 8 pixels occupy 7 words (struct
raw_pixblock, raw.h:63-79). The device-side unpack kernel lives in
``mlvfs_tpu_torch.ops.unpack``; this module is the NumPy oracle for it and the
packer used by the synthetic clip generator and DNG→MLV roundtrip tests.

Derivation of the indexing: the reference (dng.c:813-843) fetches the two
16-bit words covering pixel k, swaps them into a 32-bit window
``v = w[a]<<16 | w[a+1]`` (a = k*bpp // 16) and extracts
``(v >> (32 - bpp - k*bpp % 16)) & ((1<<bpp)-1)``.
"""

from __future__ import annotations

import numpy as np


def unpack_bits_np(words: np.ndarray, bpp: int, num_pixels: int) -> np.ndarray:
    """Unpack ``num_pixels`` values of width ``bpp`` from a u16 word stream."""
    words = np.asarray(words, np.uint16)
    k = np.arange(num_pixels, dtype=np.int64)
    off = k * bpp
    a = off >> 4
    sh = (off & 15).astype(np.uint32)
    needed = int(a[-1]) + 2 if num_pixels else 0
    if len(words) < needed:
        words = np.concatenate([words, np.zeros(needed - len(words), np.uint16)])
    hi = words[a].astype(np.uint32) << 16
    lo = words[a + 1].astype(np.uint32)
    v = hi | lo
    return ((v >> (32 - bpp - sh)) & ((1 << bpp) - 1)).astype(np.uint16)


def pack_bits_np(values: np.ndarray, bpp: int) -> np.ndarray:
    """Pack values (uint16, < 2**bpp) into the MSB-first u16 word stream.

    Vectorized over fixed-size blocks: lcm(16, bpp)/bpp pixels fill
    lcm(16, bpp)/16 words, each pixel contributing to at most two word
    columns with static shifts.
    """
    values = np.asarray(values, np.uint32).ravel()
    n = len(values)
    import math

    lcm = math.lcm(16, bpp)
    ppb, wpb = lcm // bpp, lcm // 16
    num_blocks = (n + ppb - 1) // ppb
    total_words = (n * bpp + 15) // 16
    if n < num_blocks * ppb:
        values = np.concatenate([values, np.zeros(num_blocks * ppb - n, np.uint32)])
    p = values.reshape(num_blocks, ppb)
    words = np.zeros((num_blocks, wpb), np.uint32)
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            words[:, a] |= p[:, j] << (16 - bpp - sh)
        else:
            spill = sh + bpp - 16
            words[:, a] |= p[:, j] >> spill
            words[:, a + 1] |= (p[:, j] << (16 - spill)) & 0xFFFF
    return words.reshape(-1)[:total_words].astype(np.uint16)


def packed_size_bytes(num_pixels: int, bpp: int) -> int:
    """Size in bytes of the packed stream, rounded up to whole 16-bit words."""
    return 2 * ((num_pixels * bpp + 15) // 16)
