"""AMaZE's in-place raster passes: kernel #10 and its plain twins.

Counterpart of ``mlvfs_tpu/ops/amaze_scans_pallas.py`` (``refine_tiles``,
``dilate_tiles``, ``chroma_one_tiles``, the split AMaZE path's Pallas
kernels) with the semantics of ``mlvfs_tpu/ops/amaze_core.py``'s XLA scans,
which the plain twins in ``ops/amaze_core.py`` follow: each pass restarts on
the 160-row tile grid, reads the rows below a tile from the frame (with
wrap-around), and each padded row of the (B, hp, wp) frame comes from the
one tile that keeps it (rows [16, 144) of a tile, plus the first tile's top
and the last tile's tail).

  * :func:`refine`: the hvwt/pmwt neighbour refinement, float32;
  * :func:`dilate`: the Nyquist majority dilation, int32 0/1 cells;
  * :func:`chroma`: the directional chrominance interpolation of one plane.

Each runs its twin on a CPU tensor and launches ``csrc/amaze_scans.cu`` on a
CUDA tensor, or raises. It never falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import _build
from .amaze_core import chroma_plain, dilate_plain, n_tiles, refine_plain

# Launches of the CUDA kernels by refine, dilate and chroma together, for
# showing that a run went through them: five per AMaZE demosaic (dilate,
# refine twice, chroma on two planes). Only the wrappers add to it.
KERNEL_LAUNCHES = 0


def _check(x, dtype, out):
    if x.dim() != 3 or x.dtype != dtype:
        raise TypeError(f"AMaZE raster pass takes a (B, hp, wp) {dtype} plane, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if x.shape[-1] % 2 or x.shape[-2] < 4:
        raise ValueError(f"AMaZE raster pass takes an even width and at least 4 rows, got "
                         f"{tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != dtype or out.device != x.device):
        raise ValueError("AMaZE raster pass: out must match the input's shape, type and device")


def _launch(fn_name, x, out, *args):
    global KERNEL_LAUNCHES
    b, hp, wp = x.shape
    if not x.is_contiguous() or (out is not None and not out.is_contiguous()):
        raise ValueError("AMaZE raster pass kernels take contiguous planes")
    if b > 65535:
        raise ValueError(f"AMaZE raster pass takes at most 65535 frames per batch, got {b}")
    if out is None:
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library("amaze_scans")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn_name)(x.data_ptr(), out.data_ptr(), b, hp, wp, n_tiles(hp), *args, stream)
    if rc != 0:
        raise RuntimeError(f"AMaZE raster pass {fn_name} launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return out


def _dispatch(plain, fn_name, x, dtype, out, *args):
    _check(x, dtype, out)
    if x.device.type == "cpu":
        res = plain(x, *args)
        return res if out is None else out.copy_(res)
    if x.device.type == "cuda":
        return _launch(fn_name, x, out, *args)
    raise ValueError(f"AMaZE raster pass: unsupported device {x.device}")


def refine(wt: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """The neighbour refinement of a (B, hp, wp) float32 cell plane."""
    return _dispatch(refine_plain, "mlvfs_amaze_refine", wt, torch.float32, out)


def dilate(nyq: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """The Nyquist dilation of a (B, hp, wp) int32 plane of 0/1 cells."""
    return _dispatch(dilate_plain, "mlvfs_amaze_dilate", nyq, torch.int32, out)


def chroma(D: torch.Tensor, update_parity: int, out: torch.Tensor = None) -> torch.Tensor:
    """The chrominance interpolation of a (B, hp, wp) float32 plane on the
    rows of padded parity ``update_parity`` (1 for G-R, 0 for G-B)."""
    if update_parity not in (0, 1):
        raise ValueError(f"update_parity is 0 or 1, got {update_parity}")
    return _dispatch(chroma_plain, "mlvfs_amaze_chroma", D, torch.float32, out, update_parity)
