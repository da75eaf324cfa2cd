"""Chroma smoothing (2x2 / 3x3 / 5x5): the CUDA kernel and its plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/chroma_smooth.py`` (u16 path). Algorithm
(reference template chroma_smooth.c, instantiated in cs.c:37-47): for every
2x2 Bayer cell in the window x in [4, w-4), y in [4, h-5) (template:26-28),
take the median of (R−G) and (B−G) in EV space over the surrounding 5/9/25
cells, and reapply those chroma offsets to the cell's mean green. Only the
R (even, even) and B (odd, odd) sites of window cells are rewritten.

Bit-exactness: C int32 arithmetic (wrapping adds, truncating ``/ 2``) and the
raw→EV table's INT_MIN at ``pixel == black``. The EV transforms are the
lookup tables of ``ops/luts.py``, which define them (the JAX package's
double-single ``evarith`` form is proven equal to them by its self-check).

:func:`chroma_smooth_batch` is the entry point of the processing pipeline. On
a CPU tensor it runs :func:`chroma_smooth_batch_plain`; on a CUDA tensor it
launches the hand-written kernel ``csrc/chroma.cu`` (built by ``_build``) or
raises. It never falls back from one to the other.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .luts import EV_RESOLUTION
from .medians import median_planes
from .pixels import ev_tables, wrap32
from .unpack import to_int16_bits

# Launches of the CUDA kernel by chroma_smooth_batch, for showing that a run
# went through the kernel. Only the wrapper adds to it, once per launch.
KERNEL_LAUNCHES = 0

METHODS = (2, 3, 5)


def _offsets(method: int):
    """Neighbourhood cell offsets (dx, dy) in pixels (chroma_smooth.c:1-16,41-48)."""
    m = 4 if method == 5 else 2
    offs = []
    for i in range(-m, m + 1, 2):
        for j in range(-m, m + 1, 2):
            if method == 2 and abs(i) + abs(j) == 4:
                continue
            offs.append((i, j))
    return offs


def cell_window(height: int, width: int):
    """(ny, nx): rows and columns of 2x2 cells smoothed, top-left at (4, 4)."""
    return max(0, (height - 8) // 2), max(0, (width - 7) // 2)


def _check(imgs: torch.Tensor, method: int):
    if method not in METHODS:
        raise ValueError(f"unsupported chroma smooth method {method}")
    if imgs.dim() != 3:
        raise ValueError(f"chroma smoothing takes (B, H, W) frames, got shape {tuple(imgs.shape)}")
    h, w = imgs.shape[1:]
    ny, nx = cell_window(h, w)
    if method == 5 and w % 2 and ny and nx:
        # the 5x5 neighbourhood of the last cell column reads one column past
        # the frame; the reference's slices refuse such frames too
        raise ValueError(f"5x5 chroma smoothing needs an even frame width, got {w}")


def _div2_trunc(t: torch.Tensor) -> torch.Tensor:
    """C's int32 ``t / 2`` (truncation toward zero)."""
    return torch.div(t, 2, rounding_mode="trunc")


def chroma_smooth_batch_plain(imgs: torch.Tensor, method: int, black: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W) int16 (u16 bits) → a new
    (B, H, W) int16.

    Runs on any device; :func:`chroma_smooth_batch` uses it for CPU tensors,
    and the GPU smoke test holds the kernel against it on the card. int32
    arithmetic runs in int64, wrapped back to int32 where C would wrap.
    """
    _check(imgs, method)
    h, w = imgs.shape[1:]
    ny, nx = cell_window(h, w)
    if ny == 0 or nx == 0:
        return imgs.clone()
    lut, inv = ev_tables(int(black), imgs.device)
    src = imgs.to(torch.int64) & 0xFFFF
    ev = lut[src]  # one whole-frame raw→EV lookup; INT_MIN at black

    def ev_cells(dy, dx):
        # the cells' pixels at (4 + dy + 2cy, 4 + dx + 2cx)
        return ev[:, 4 + dy : 4 + dy + 2 * ny : 2, 4 + dx : 4 + dx + 2 * nx : 2]

    ge = _div2_trunc(wrap32(ev_cells(0, 1) + ev_cells(1, 0)))
    med_r, med_b = [], []
    for i, j in _offsets(method):
        gen = _div2_trunc(wrap32(ev_cells(j, i + 1) + ev_cells(j + 1, i)))
        med_r.append(wrap32(ev_cells(j, i) - gen))
        med_b.append(wrap32(ev_cells(j + 1, i + 1) - gen))
    er = wrap32(ge + median_planes(med_r))
    eb = wrap32(ge + median_planes(med_b))

    # skip dark cells and negative results (template:35, 64-65)
    ok = (ge >= 2 * EV_RESOLUTION) & (er > EV_RESOLUTION) & (eb > EV_RESOLUTION)

    def to_raw(e):
        return inv[e.clamp(0, 14 * EV_RESOLUTION - 1) + 10 * EV_RESOLUTION] + black

    out = src.clone()
    r_sites = out[:, 4 : 4 + 2 * ny : 2, 4 : 4 + 2 * nx : 2]
    b_sites = out[:, 5 : 5 + 2 * ny : 2, 5 : 5 + 2 * nx : 2]
    r_sites.copy_(torch.where(ok, to_raw(er), r_sites))
    b_sites.copy_(torch.where(ok, to_raw(eb), b_sites))
    return to_int16_bits(out & 0xFFFF)


@functools.lru_cache(maxsize=16)
def _kernel_tables(black: int, device: torch.device):
    """The kernel's int32 tables on ``device``, once per (black, device):
    raw→EV indexed by any u16 value (256 KiB) and EV→raw over
    [0, 14·EVR) (1.75 MiB). Both stay resident in the 50 MB L2."""
    lut, inv = ev_tables(black, device)
    return lut.to(torch.int32), inv[10 * EV_RESOLUTION :].to(torch.int32).contiguous()


def _chroma_smooth_cuda(imgs: torch.Tensor, method: int, black: int) -> torch.Tensor:
    global KERNEL_LAUNCHES
    _check(imgs, method)
    if imgs.dtype != torch.int16:
        raise TypeError(f"chroma kernel takes int16 frames, got {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("chroma kernel takes contiguous (B, H, W) frames")
    b, h, w = imgs.shape
    if b > 65535:
        raise ValueError(f"chroma kernel takes at most 65535 frames per batch, got {b}")
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    lut, inv = _kernel_tables(int(black), imgs.device)
    lib = _build.library("chroma")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.mlvfs_chroma_smooth(
            imgs.data_ptr(), out.data_ptr(), lut.data_ptr(), inv.data_ptr(),
            b, h, w, method, int(black), stream,
        )
    if rc != 0:
        raise RuntimeError(f"chroma kernel launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return out


def chroma_smooth_batch(imgs: torch.Tensor, method: int, black: int) -> torch.Tensor:
    """Chroma smoothing of a batch (chroma_smooth, cs.c:49-84): (B, H, W)
    int16 (u16 bits) → a new (B, H, W) int16.

    CPU tensor: the plain version. CUDA tensor: the CUDA kernel. Anything
    else raises.
    """
    if imgs.device.type == "cpu":
        return chroma_smooth_batch_plain(imgs, method, black)
    if imgs.device.type == "cuda":
        return _chroma_smooth_cuda(imgs, method, black)
    raise ValueError(f"chroma_smooth_batch: unsupported device {imgs.device}")
