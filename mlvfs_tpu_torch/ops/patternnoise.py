"""Fixed-pattern (row/column) noise removal: the batch entry point, and the
split-plane blur (kernel #4) with its plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/patternnoise.py`` (fix_pattern_noise,
patternnoise.c:357-379). Per direction: split the Bayer mosaic into its four
half-res channels, run a horizontal edge-aware median blur (the window grows
left and right while the green average stays within 500 of the centre's, at
most channel offsets -25..+24), call the difference "noise", mask strong
edges and near-white pixels, subtract each column's median noise, remove the
median of the offsets to avoid a cast; transpose and repeat for rows. All
integer arithmetic matches C semantics; the JAX package's ``//`` floors, so
the halvings here are arithmetic shifts.

:func:`fix_pattern_noise_batch` is the pipeline's entry point. It runs the
interleaved-grid formulation of ``patternnoise_fused`` on both devices (its
blur is kernel #3 on CUDA, the plain twin on the CPU), so the card's output
equals the CPU's by construction. The split-plane blur below,
:func:`edge_aware_blur`, is kernel #4 (``csrc/patternnoise.cu``, the split
entry point) on a CUDA tensor and :func:`edge_aware_blur_plain` on a CPU
tensor; no conversion path calls it, as in the reference, where only tests
and tools reach the split Pallas blur. Its plain twin also computes the
interleaved plain twin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

# Launches of the split-plane CUDA kernel (#4) by edge_aware_blur, for showing
# that a run went through the kernel. Only the wrapper adds to it.
KERNEL_LAUNCHES = 0

STRENGTH = 25  # 50/2 (patternnoise.c:104, call site :332)
THR = 500
SLOTS = 2 * STRENGTH  # window slots: channel offsets -25..+24
_SENTINEL = 1 << 30  # above any reachable value: sorts past the valid entries
_BIG = 10**9  # average outside the row: breaks the window there
_CHUNK = 1 << 22  # rows x width x slots elements per plain-twin step


def wirth_k(num: torch.Tensor) -> torch.Tensor:
    """median_short/int_wirth index (wirth.h): n odd → n//2, even → n//2 - 1."""
    return torch.where((num & 1) == 1, num // 2, num // 2 - 1)


def window(avg: torch.Tensor):
    """Edge-aware window of every element of the rows ``avg`` (..., w2) int32.

    Returns (valid (..., w2, SLOTS) bool, k (..., w2) int64): slot j holds
    channel offset j - 25, valid on the prefix-AND of |avg[x+d] - avg[x]| <=
    500 moving away from the centre (patternnoise.c:123-144: the left scan
    is inclusive of x-25, the right one stops at x+24), and k is the Wirth
    index of the valid count."""
    nb = F.pad(avg, (STRENGTH, STRENGTH - 1), value=_BIG).unfold(-1, SLOTS, 1)
    ok = ((nb - avg.unsqueeze(-1)).abs() <= THR).to(torch.int32)
    right = ok[..., STRENGTH + 1 :].cumprod(-1)
    left = ok[..., :STRENGTH].flip(-1).cumprod(-1).flip(-1)
    centre = torch.ones_like(ok[..., :1])
    valid = torch.cat([left, centre, right], -1).bool()
    k = wirth_k(valid.sum(-1)).clamp(0, SLOTS - 1)
    return valid, k


def windowed_median(chan: torch.Tensor, valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k-th smallest of each element's valid window entries of ``chan``."""
    nb = F.pad(chan, (STRENGTH, STRENGTH - 1), value=_SENTINEL).unfold(-1, SLOTS, 1)
    entries = torch.where(valid, nb, _SENTINEL)
    return entries.sort(-1).values.gather(-1, k.unsqueeze(-1)).squeeze(-1)


def edge_aware_blur_plain(r, g1, g2, b):
    """Plain twin of kernel #4: smoothed (rs, g1s, g2s, bs) of the four
    channel planes (..., H/2, W/2) int32 (patternnoise.c:88-180).

    Adaptive-window row medians of g1, g2, r - avg and b - avg, with the
    cell's green median mean added back at R and B. Runs in row chunks, so a
    1080p batch on the card never holds a 50-deep stack of the whole batch.
    """
    shape = r.shape
    w2 = shape[-1]
    rows = [t.reshape(-1, w2).to(torch.int32) for t in (r, g1, g2, b)]
    outs = [torch.empty_like(rows[0]) for _ in range(4)]
    step = max(1, _CHUNK // max(1, w2 * SLOTS))
    for s in range(0, rows[0].shape[0], step):
        rc, g1c, g2c, bc = (t[s : s + step] for t in rows)
        avg = (g1c + g2c) >> 1  # the reference's floor // 2
        valid, k = window(avg)
        mg1 = windowed_median(g1c, valid, k)
        mg2 = windowed_median(g2c, valid, k)
        mg = (mg1 + mg2) >> 1
        outs[0][s : s + step] = windowed_median(rc - avg, valid, k) + mg
        outs[1][s : s + step] = mg1
        outs[2][s : s + step] = mg2
        outs[3][s : s + step] = windowed_median(bc - avg, valid, k) + mg
    return tuple(o.reshape(shape) for o in outs)


def _check_planes(planes):
    shape = planes[0].shape
    if len(shape) not in (2, 3):
        raise ValueError(f"blur takes (H/2, W/2) or (B, H/2, W/2) planes, got {tuple(shape)}")
    for t in planes:
        if t.shape != shape or t.dtype != torch.int32 or t.device != planes[0].device:
            raise ValueError("blur takes four int32 planes of one shape on one device")


def _edge_aware_blur_cuda(r, g1, g2, b):
    global KERNEL_LAUNCHES
    planes = [t.contiguous() for t in (r, g1, g2, b)]
    _check_planes(planes)
    *lead, h2, w2 = planes[0].shape
    batch = lead[0] if lead else 1
    outs = [torch.empty_like(planes[0]) for _ in range(4)]
    if outs[0].numel() == 0:
        return tuple(outs)
    if batch > 65535:
        raise ValueError(f"blur kernel takes at most 65535 frames per call, got {batch}")
    lib = _build.library("patternnoise")
    with torch.cuda.device(planes[0].device):
        stream = torch.cuda.current_stream(planes[0].device).cuda_stream
        rc = lib.mlvfs_pn_blur_split(
            *(t.data_ptr() for t in planes), *(t.data_ptr() for t in outs),
            batch, 2 * h2, 2 * w2, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pattern-noise blur kernel launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return tuple(outs)


def edge_aware_blur(r, g1, g2, b):
    """Smoothed (rs, g1s, g2s, bs) of the four channel planes (..., H/2, W/2)
    int32: the plain twin on a CPU tensor, kernel #4 on a CUDA tensor."""
    dev = r.device.type
    if dev == "cpu":
        return edge_aware_blur_plain(r, g1, g2, b)
    if dev == "cuda":
        return _edge_aware_blur_cuda(r, g1, g2, b)
    raise ValueError(f"edge_aware_blur: unsupported device {r.device}")


def fix_pattern_noise_image(img: torch.Tensor, white: int) -> torch.Tensor:
    """Full pattern-noise fix of one frame (H, W) int16 (u16 bits)."""
    return fix_pattern_noise_batch(img[None], white)[0]


def fix_pattern_noise_batch(imgs: torch.Tensor, white: int) -> torch.Tensor:
    """Full pattern-noise fix of a batch (B, H, W) int16 (u16 bits) → a new
    (B, H, W) int16: rows, then the transpose.

    Pixels are taken as int16 (the reference's ``astype(int16)``: values of
    32768 and above are negative). Odd frame dimensions (EOS M crop mode
    records 1808x727) process the even-cropped core and pass the last row or
    column through; the reference C has no defined behaviour there
    (extract_channel overruns its buffer, patternnoise.c:287-296 vs
    :315-328)."""
    from .patternnoise_fused import fix_pattern_noise_direction

    h, w = imgs.shape[-2:]
    he, we = h & ~1, w & ~1
    if he == 0 or we == 0:
        return imgs.clone()
    raw = imgs[:, :he, :we].to(torch.int32).contiguous()
    raw = fix_pattern_noise_direction(raw, white)
    raw = fix_pattern_noise_direction(raw.transpose(-1, -2).contiguous(), white)
    core = raw.transpose(-1, -2).to(torch.int16)  # in [0, 32760]
    if (he, we) == (h, w):
        return core.contiguous()
    out = imgs.clone()
    out[:, :he, :we] = core
    return out
