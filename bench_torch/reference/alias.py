"""Reference copy of ``mlvfs_tpu_torch/ops/alias.py`` at commit 1c20a80: its
plain path only, on any device; every CUDA kernel route, launch counter
and build hook is removed. The original text follows.

The dual-ISO alias-map filter chain: kernel #7 and its plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/alias_pallas.py`` (the Pallas kernel) and of
``mlvfs_tpu/ops/dualiso_full.py:_alias_filter_xla`` (its XLA form):
build_alias_map's filter stages (hdr.c:1421-1486) on (B, H, W) int32 alias
maps and bool skip maps. "Inner" is 6 <= y < H-6 and 6 <= x < W-6; taps
outside the frame read 0.

  1. aux: the 6th largest of the 37-tap diamond where inner & ~skip, else
     the alias value;
  2. the integer gaussian, ``acc += group_sum * weight // 1024`` per group
     (floor division, int32), where inner & ~skip, else the alias value;
  3. per 2x2 cell of the grid from (2, 2), the cell's max capped at
     ALIAS_MAP_MAX on all four pixels; pixels outside the grid keep step 2.

:func:`alias_filter` runs :func:`alias_filter_plain` on a CPU tensor and
launches ``csrc/alias.cu`` on a CUDA tensor, or raises. It never falls back
from one to the other.
"""

from __future__ import annotations

import torch


ALIAS_MAP_MAX = 15000

# (dx, dy) of the 37-tap diamond (hdr.c:1421-1440)
FILTER_OFFS = [
    (-2, -6), (0, -6), (2, -6),
    (-4, -4), (-2, -4), (0, -4), (2, -4), (4, -4),
    (-6, -2), (-4, -2), (-2, -2), (0, -2), (2, -2), (4, -2), (6, -2),
    (-6, 0), (-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0), (6, 0),
    (-6, 2), (-4, 2), (-2, 2), (0, 2), (2, 2), (4, 2), (6, 2),
    (-4, 4), (-2, 4), (0, 4), (2, 4), (4, 4),
    (-2, 6), (0, 6), (2, 6),
]

# (weight, [(dx, dy), ...]) transcribed from hdr.c:1451-1460, the offset
# groups the reference lists twice included
BLUR_GROUPS = [
    (820, [(0, -2), (-2, 0), (2, 0), (0, 2)]),
    (657, [(-2, -2), (2, -2), (-2, 2), (2, 2)]),
    (421, [(0, -2), (-2, 0), (2, 0), (0, 2)]),
    (337, [(-2, -2), (2, -2), (-2, -2), (2, -2), (-2, 2), (2, 2), (-2, 2), (2, 2)]),
    (173, [(-2, -2), (2, -2), (-2, 2), (2, 2)]),
    (139, [(0, -6), (-6, 0), (6, 0), (0, 6)]),
    (111, [(-2, -6), (2, -6), (-6, -2), (6, -2), (-6, 2), (6, 2), (-2, 6), (2, 6)]),
    (57, [(-2, -6), (2, -6), (-6, -2), (6, -2), (-6, 2), (6, 2), (-2, 6), (2, 6)]),
]


def shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = a[..., y+dy, x+dx], 0 outside the frame."""
    h, w = a.shape[-2:]
    out = torch.zeros_like(a)
    if abs(dy) < h and abs(dx) < w:
        out[..., max(0, -dy) : h - max(0, dy), max(0, -dx) : w - max(0, dx)] = \
            a[..., max(0, dy) : h + min(0, dy), max(0, dx) : w + min(0, dx)]
    return out


def cell_grid(h: int, w: int):
    """(rows, columns) of 2x2 cells from (2, 2): len(range(2, h-2, 2)), ..."""
    return len(range(2, h - 2, 2)), len(range(2, w - 2, 2))


def inner_mask(h: int, w: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= 6) & (ys < h - 6) & (xs >= 6) & (xs < w - 6)


def _check(alias: torch.Tensor, skip: torch.Tensor):
    if alias.dim() != 3 or skip.shape != alias.shape:
        raise ValueError(f"alias filter takes (B, H, W) alias and skip maps of one shape, got "
                         f"{tuple(alias.shape)} and {tuple(skip.shape)}")
    if alias.dtype != torch.int32 or skip.dtype != torch.bool:
        raise TypeError(f"alias filter takes int32 alias and bool skip maps, got {alias.dtype} "
                        f"and {skip.dtype}")
    if skip.device != alias.device:
        raise ValueError("alias filter takes the alias and skip maps on one device")


def alias_filter_plain(alias: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: (B, H, W) int32 and bool → a new (B, H, W)
    int32. Runs on any device; :func:`alias_filter` uses it for CPU tensors,
    and the GPU smoke test holds the kernel against it on the card."""
    _check(alias, skip)
    b, h, w = alias.shape
    sel = inner_mask(h, w, alias.device) & ~skip

    # 6th largest of the diamond: running top-6 insertion over the taps
    top = [torch.full_like(alias, -(1 << 30)) for _ in range(6)]
    for dx, dy in FILTER_OFFS:
        v = shift(alias, dy, dx)
        for j in range(6):
            hi = torch.maximum(top[j], v)
            v = torch.minimum(top[j], v)
            top[j] = hi
    aux = torch.where(sel, top[5], alias)

    acc = aux
    for weight, offs in BLUR_GROUPS:
        g = torch.zeros_like(aux)
        for dx, dy in offs:
            g = g + shift(aux, dy, dx)
        acc = acc + torch.div(g * weight, 1024, rounding_mode="floor")
    out = torch.where(sel, acc, alias)

    ny, nx = cell_grid(h, w)
    if ny and nx:
        cells = out[:, 2 : 2 + 2 * ny, 2 : 2 + 2 * nx].reshape(b, ny, 2, nx, 2).amax(dim=(2, 4))
        cells = cells.clamp(max=ALIAS_MAP_MAX)
        out[:, 2 : 2 + 2 * ny, 2 : 2 + 2 * nx] = \
            cells.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return out


def alias_filter(alias: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The filter chain of a batch: (B, H, W) int32 alias maps and bool skip
    maps → a new (B, H, W) int32.

    Here the plain version on any device.
    """
    return alias_filter_plain(alias, skip)
