"""Interleaved-grid pattern noise: kernel #3, its plain PyTorch twin, and the
column-offset stage.

Counterpart of ``mlvfs_tpu/ops/patternnoise_fused.py``. The edge-aware blur
runs on the Bayer frame as it lies: every pixel takes the median of its own
channel (channel offset d is lane offset 2d), and the green medians' cell
mean is added back at R and B. The result equals deinterleave → split blur →
reinterleave (``patternnoise.edge_aware_blur``), which is how the plain twin
computes it. The column stage was XLA in the reference and stays plain torch
on both devices.

:func:`blur_interleaved` launches ``csrc/patternnoise.cu`` (interleaved
entry point) on a CUDA tensor and runs :func:`blur_interleaved_plain` on a
CPU tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .patternnoise import _SENTINEL, edge_aware_blur_plain, wirth_k

# Launches of the interleaved CUDA kernel (#3) by blur_interleaved, for
# showing that a run went through the kernel. Only the wrapper adds to it.
KERNEL_LAUNCHES = 0

_SITES = ((0, 0), (0, 1), (1, 0), (1, 1))  # R, G1, G2, B of the RGGB cell


def blur_interleaved_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel #3: the smoothed interleaved frames of (..., H, W)
    int32 Bayer frames, even H and W (rs/g1s/g2s/bs at their sites)."""
    smooth = edge_aware_blur_plain(*(img[..., py::2, px::2] for py, px in _SITES))
    out = torch.empty_like(img, dtype=torch.int32)
    for (py, px), s in zip(_SITES, smooth):
        out[..., py::2, px::2] = s
    return out


def _check_frames(img: torch.Tensor):
    if img.dim() not in (2, 3):
        raise ValueError(f"blur takes (H, W) or (B, H, W) frames, got {tuple(img.shape)}")
    h, w = img.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"blur takes even frame dimensions, got {h}x{w}")
    if img.dtype != torch.int32:
        raise TypeError(f"blur takes int32 frames, got {img.dtype}")


def _blur_interleaved_cuda(img: torch.Tensor) -> torch.Tensor:
    global KERNEL_LAUNCHES
    _check_frames(img)
    if not img.is_contiguous():
        raise ValueError("blur kernel takes contiguous frames")
    h, w = img.shape[-2:]
    batch = img.shape[0] if img.dim() == 3 else 1
    if batch > 65535:
        raise ValueError(f"blur kernel takes at most 65535 frames per call, got {batch}")
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    lib = _build.library("patternnoise")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.mlvfs_pn_blur_interleaved(img.data_ptr(), out.data_ptr(), batch, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"pattern-noise blur kernel launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return out


def blur_interleaved(img: torch.Tensor) -> torch.Tensor:
    """Smoothed interleaved frames of (..., H, W) int32 Bayer frames, even H
    and W: the plain twin on a CPU tensor, kernel #3 on a CUDA tensor."""
    if img.device.type == "cpu":
        _check_frames(img)
        return blur_interleaved_plain(img)
    if img.device.type == "cuda":
        return _blur_interleaved_cuda(img)
    raise ValueError(f"blur_interleaved: unsupported device {img.device}")


# ---------------------------------------------------------------- column stage


def _shift2(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y+dy, x+dx] over the last two dims, zero-filled."""
    h, w = a.shape[-2:]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = F.pad(a, (px1, px0, py1, py0))
    return padded[..., py1 + dy : py1 + dy + h, px1 + dx : px1 + dx + w]


def _hgrad_flat_interleaved(a: torch.Tensor) -> torch.Tensor:
    """Channel-flat gradient in[i-2] - in[i+2] on the interleaved grid,
    including the reference's row wrap at channel-row boundaries
    (patternnoise.c:78-86): channel element i-2 is lane x-4, or
    (y-2, x+w-4) when the read crosses the row start."""
    h, w = a.shape[-2:]
    xx = torch.arange(w, device=a.device)[None, :]
    yy = torch.arange(h, device=a.device)[:, None]
    a_m = torch.where(xx >= 4, _shift2(a, 0, -4), _shift2(a, -2, w - 4))
    a_p = torch.where(xx < w - 4, _shift2(a, 0, 4), _shift2(a, 2, -(w - 4)))
    w2 = w // 2
    fi = (yy >> 1) * w2 + (xx >> 1)
    size = (h // 2) * w2
    return torch.where((fi >= 2) & (fi < size - 2), a_m - a_p, 0)


def _wirth_pick(values: torch.Tensor) -> torch.Tensor:
    """The Wirth-index order statistic of the last dim (the global-cast
    removal, patternnoise.c:268-279)."""
    n = values.shape[-1]
    return values.sort(-1).values[..., (n // 2) if n % 2 else (n // 2 - 1)]


def fix_column_noise_interleaved(orig: torch.Tensor, denoised: torch.Tensor, white: int):
    """Column offsets of all four channels at once on the interleaved grid
    (patternnoise.c:185-282), (..., H, W) int32 → (..., H, W) int32.

    Each (row parity, lane) column takes the median of its valid noise at
    the Wirth index (a sort and a gather: the exact order statistic the
    reference's bisection finds), unless fewer than 10 values are valid."""
    noise = orig - denoised
    valid = ~((_hgrad_flat_interleaved(orig).abs() > 500) | (orig >= white))
    nv = torch.where(valid, noise, _SENTINEL)
    h2 = orig.shape[-2] // 2
    offsets = []
    for p in (0, 1):
        num = valid[..., p::2, :].sum(-2)
        k = wirth_k(num).clamp(0, h2 - 1)
        med = nv[..., p::2, :].sort(-2).values.gather(-2, k.unsqueeze(-2)).squeeze(-2)
        offsets.append(torch.where(num < 10, 0, -med))
    off = torch.stack(offsets, -2)  # (..., 2, W): per (row parity, lane)
    lead = [1] * (off.dim() - 2)
    applied = (orig + off.repeat(*lead, h2, 1)).clamp(-32767, 32767)
    # per-channel median of the channel's column offsets (the global-cast
    # removal, patternnoise.c:268-279), tiled over the RGGB cells
    mc = torch.stack([_wirth_pick(off[..., :, xp::2]) for xp in (0, 1)], -1)  # (..., 2, 2)
    return (applied - mc.repeat(*lead, h2, orig.shape[-1] // 2)).clamp(0, 32760)


def fix_pattern_noise_direction(raw: torch.Tensor, white: int) -> torch.Tensor:
    """One direction over the interleaved Bayer frames (..., H, W) int32, even
    H and W: the counterpart of the reference's split
    ``patternnoise._fix_column_noise_rggb``."""
    return fix_column_noise_interleaved(raw, blur_interleaved(raw), white)
