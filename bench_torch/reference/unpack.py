"""Reference copy of ``mlvfs_tpu_torch/ops/unpack.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

Bayer bitstream unpacking: the CUDA kernel and its plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/unpack.py``. At ``bpp`` bits per pixel,
``lcm(16, bpp) / bpp`` pixels occupy ``lcm(16, bpp) / 16`` sixteen-bit words
(14 bpp: 8 pixels from 7 words, raw.h:63-79), so each output pixel is a
static word (or word pair), a shift and a mask.

u16 data travels as ``torch.int16`` tensors holding the raw bits (PyTorch's
``uint16`` has thin operator coverage, on CUDA above all); arithmetic in the
plain version runs in int32 on the bits masked back to 0..65535.

:func:`unpack_batch` is the entry point of the convert path. On a CPU tensor
it runs the plain version; on a CUDA tensor it launches the hand-written
kernel ``csrc/unpack.cu`` (built by ``_build``) or raises. It never falls
back from one to the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _block_geometry(bpp: int):
    if not 1 <= bpp <= 16:
        raise ValueError(f"bits per pixel must be in 1..16, got {bpp}")
    lcm = math.lcm(16, bpp)
    return lcm // bpp, lcm // 16  # pixels per block, words per block


def words_for_pixels(num_pixels: int, bpp: int) -> int:
    """Number of u16 words needed to hold num_pixels (not block-padded)."""
    return (num_pixels * bpp + 15) // 16


def _as_u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int16/uint16 bits → int32 values in 0..65535."""
    return x.to(torch.int32) & 0xFFFF


def to_int16_bits(x: torch.Tensor) -> torch.Tensor:
    """Integer values in 0..65535 → int16 tensor with the same 16 bits."""
    return (x - ((x & 0x8000) << 1)).to(torch.int16)


def _unpack_plain(words: torch.Tensor, bpp: int, num_pixels: int) -> torch.Tensor:
    """(B, n_words) words → (B, num_pixels) int16 pixels; missing words are 0."""
    ppb, wpb = _block_geometry(bpp)
    b = words.shape[0]
    num_blocks = (num_pixels + ppb - 1) // ppb
    needed = num_blocks * wpb
    w = _as_u16_bits(words[:, :needed])
    if w.shape[1] < needed:
        w = F.pad(w, (0, needed - w.shape[1]))
    w = w.reshape(b, num_blocks, wpb)

    mask = (1 << bpp) - 1
    cols = []
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            # pixel contained in word a
            val = (w[:, :, a] >> (16 - bpp - sh)) & mask
        else:
            # straddles words a, a+1: ((w[a] << 16) | w[a+1]) >> k with
            # k < 16, written so that no int32 intermediate overflows
            k = 32 - bpp - sh
            val = ((w[:, :, a] << (16 - k)) | (w[:, :, a + 1] >> k)) & mask
        cols.append(val)
    out = torch.stack(cols, dim=2).reshape(b, num_blocks * ppb)
    return to_int16_bits(out[:, :num_pixels])


def unpack_words(words: torch.Tensor, bpp: int, num_pixels: int) -> torch.Tensor:
    """Unpack a 1-D u16 word stream → (num_pixels,) int16 pixel bits (plain).

    ``words`` may be shorter than ``words_for_pixels(num_pixels, bpp)``: the
    missing words read as 0. Excess words are ignored.
    """
    return _unpack_plain(words.reshape(1, -1), bpp, num_pixels)[0]


def unpack_frame(words: torch.Tensor, bpp: int, height: int, width: int) -> torch.Tensor:
    """Unpack one frame's packed words into an (H, W) int16 mosaic (plain)."""
    return unpack_words(words, bpp, height * width).reshape(height, width)


def unpack_batch_plain(words: torch.Tensor, bpp: int, height: int, width: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, n_words) → (B, H, W) int16.

    Runs on any device; :func:`unpack_batch` uses it for CPU tensors, and the
    GPU smoke test holds the kernel against it on the card.
    """
    return _unpack_plain(words, bpp, height * width).reshape(-1, height, width)


def unpack_batch(words: torch.Tensor, bpp: int, height: int, width: int) -> torch.Tensor:
    """Unpack a batch: (B, n_words) int16 words → (B, H, W) int16 pixels.

    Here the plain version on any device.
    """
    return unpack_batch_plain(words, bpp, height, width)


def pack16(pixels: torch.Tensor, bpp: int) -> torch.Tensor:
    """Inverse of unpack_words: 1-D pixels → u16 word stream (block-padded),
    as int16 bits."""
    ppb, wpb = _block_geometry(bpp)
    n = pixels.shape[0]
    num_blocks = (n + ppb - 1) // ppb
    p = _as_u16_bits(pixels)
    if n < num_blocks * ppb:
        p = F.pad(p, (0, num_blocks * ppb - n))
    p = p.reshape(num_blocks, ppb)

    words = [torch.zeros(num_blocks, dtype=torch.int32, device=p.device) for _ in range(wpb)]
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            words[a] = words[a] | (p[:, j] << (16 - bpp - sh))
        else:
            spill = sh + bpp - 16
            words[a] = words[a] | (p[:, j] >> spill)
            words[a + 1] = words[a + 1] | ((p[:, j] << (16 - spill)) & 0xFFFF)
    return to_int16_bits(torch.stack(words, dim=1).reshape(num_blocks * wpb))


def bytes_to_words_np(payload: np.ndarray) -> np.ndarray:
    """Host-side: reinterpret a little-endian byte buffer as u16 words."""
    b = np.asarray(payload, np.uint8)
    if len(b) % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return b.view("<u2")


def lj92_detile(img: torch.Tensor) -> torch.Tensor:
    """Undo the 2D tiling applied to LJ92-compressed MLV frames (..., H, W).

    The reference scatter (main.c:652-668) maps source row y to
    ``dst_y = (2y) % H + (2y) // H`` (same for columns): a riffle
    interleave, done here by reshape/transpose. LJ92 MLV frames are always
    even-sized; odd sizes are refused.
    """
    h, w = img.shape[-2], img.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"lj92_detile requires even dimensions, got {h}x{w}")
    lead = img.shape[:-2]
    img = img.reshape(*lead, 2, h // 2, w)
    img = img.transpose(-3, -2).reshape(*lead, h, w)
    img = img.reshape(*lead, h, 2, w // 2)
    img = img.transpose(-2, -1).reshape(*lead, h, w)
    return img
