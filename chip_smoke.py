#!/usr/bin/env python3
"""GPU smoke test of mlvfs_tpu_torch, the PyTorch + CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

  1. the card's name and power limit; build of the CUDA kernels from csrc/,
     one nvcc per source, all started together;
  2. the unpack kernel against its plain PyTorch twin on the card, bit-equal
     (torch.equal), at 8/10/12/14 bpp: 1920x1080 with B=16, 1808x727, a pixel
     count that leaves a partial last block, and a truncated word stream;
     median CUDA-event times of both and the kernel's GB/s;
  2b. the chroma-smoothing kernel against its plain twin, bit-equal, for the
     2x2/3x3/5x5 methods at black 2047 and 2048: 1920x1080 with B=16,
     1808x727 with B=4, the windowless 8x8, 8x16 and 16x8, every frame with a
     10x30 block at exactly black; median CUDA-event times at 1080p/B=16,
     GB/s, and the share of the card's bound;
  2c. the pattern-noise blur kernels, interleaved (#3) and split-plane (#4),
     against their plain twin, bit-equal: 1920x1080 with B=2, 1078 rows (a
     multi-block height that is no multiple of the block's 4 rows), the
     124- and 128-px widths at and below the blur window, and a frame with
     pixels at and above 32768 and above white; median CUDA-event times at
     1080p/B=16 on phase 3c's 5D3 frames, and the share of the bound
     counted from the operations those frames' windows need;
  2d. the dual-ISO preview kernel (#5) against its plain twin, bit-equal:
     1080p with B=16 across the four dark-row phases, with over-white and
     below-shadow pixels, and heights 5, 6 and 7; times and share of bound;
  2e. the alias-map filter kernel (#7) against its plain twin, bit-equal:
     1080p and 1872x1060 with B=16, heights 5, 12, 13, 64 and 300 at odd and
     even widths, skip densities 0, 1/2 and 1; times at 1080p/B=16 and the
     share of the bound counted from the pixels those inputs select;
  2f. the edge scorer and pick kernel (#6) against its plain twin, bit-equal:
     1080p and 1872x1060 with B=16, heights 300, 64, 11 and 5 at odd and
     even widths, restricted densities 0, 1/2 and 1; times at 1080p/B=16
     and the share of the bound counted from the pixels those inputs score;
  2g. the AMaZE raster-pass kernels (#10) against their plain twins on the
     1080p and EOS M padded planes (B=16) and on short, two-tile and
     partial-tile planes (dilate bit-equal, refine and chroma within 0.01,
     their max error printed), then the AMaZE demosaic (#8's stencil
     stages with #10 between them) against its plain twin at 1080p and
     1872x1060 with B=16 and at three small sizes (rtol 1e-5, atol 0.01 on
     the 0..65535 scale, the max error printed); #8's and #10's device time
     in one demosaic at 1080p/B=16 (torch.profiler), the whole call and the
     twin by CUDA events, and the five passes of one demosaic against their
     twins;
  3. the default convert path, ``python -m mlvfs_tpu_torch convert CLIP -o
     OUT --device cuda`` through ``cli.main``: a 1920x1080 14-bit 5D Mark III
     clip (64 frames) whose DNG payloads must equal the synthesized frames,
     and a 1872x1060 EOS M clip (32 frames, bundled focus-pixel map) whose
     first DNGs must be byte-identical to the port's own CPU conversion; the
     unpack kernel's launch count must grow by the number of batches;
  3b. the flags-on path, ``convert CLIP --deflicker 3000 --cs3x3 --stripes
     --bad-pix --device cuda``: a 1920x1080 14-bit 5D Mark III clip (48
     frames) with a period-8 column gain and injected hot and cold pixels.
     The stripe and bad-pixel fixes must change pixels, each kernel must run
     once per batch, and the first 4 DNGs must be byte-identical to the
     port's own CPU conversion;
  3c. ``convert CLIP --fix-pattern-noise``: a 1080p 14-bit 5D Mark III clip
     (32 frames) with row and column noise. Kernel #3 must run twice per
     batch (rows, then columns), the fix must change pixels, and the first 2
     DNGs must be byte-identical to the port's CPU conversion of them;
  3d. ``convert CLIP --dual-iso-preview``: a 1080p dual-ISO 5D Mark III clip
     (32 frames), and a 1872x1060 EOS M clip (20 frames, bundled focus-pixel
     map) whose odd frames are not dual-ISO, with ``--bad-pix --cs2x2
     --stripes``. Kernel #5 must run once per batch that holds a detected
     frame, converted frames must carry x4 levels and the others their own,
     and every DNG must be byte-identical to the port's CPU conversion;
  3e. ``convert CLIP --dual-iso --mean23``: a 1080p dual-ISO 5D Mark III
     clip (32 frames), and a 1872x1060 EOS M clip (20 frames) whose odd
     frames are single-ISO, with ``--bad-pix --cs2x2 --stripes``. Kernel #7
     must run once per batch (each holds a converted frame) and not at all
     under ``--no-alias-map``; converted frames carry x4 levels, the others
     their own. The first 2 DNGs are held against the port's CPU conversion
     of them: headers and frames not converted byte-identical, converted
     frames within PSNR 90 dB and 3 % of pixels;
  3f. ``convert CLIP --dual-iso`` (amaze-edge, the default interpolation)
     on the same two clips and flags as 3e: per batch (each holds a
     converted frame) kernels #6, #8 and #7 launch once and #10 five times;
     levels, and the first 2 DNGs against the port's CPU conversion, as in
     3e;
  4. LZMA and LJ92 variants of a short 1080p clip through the card, whose
     DNGs must be byte-identical to the uncompressed clip's.

Each convert path runs with every kernel launch count set to 0 just before
it and read just after. Kernel #4 is on no convert path (the reference
reaches it only from tests and tools): its ``launches`` are 0, and its
``kernel_phase_launches`` are those of phase 2c, counted from 0.

``python3 chip_smoke.py --breakdown N`` instead measures where the time
goes (PERF.md section 5): each layer's device time per 1080p batch of 16 and
its host enqueue time (the pattern-noise, preview and full dual-ISO steps
too, the preview's host fit and the full path's analysis with their
readbacks included; the amaze-edge reconstruction with #8 + #10 and #6 on
its own inputs), the once-per-clip calibration, and for each of the
flags-on, ``--fix-pattern-noise``, ``--dual-iso-preview``, ``--dual-iso
--mean23`` and ``--dual-iso`` programs two N-frame converts and one under
torch.profiler (device busy share, device time by kernel). Without a CUDA card it exits non-zero and prints no
result. The line before the last is a JSON summary of the kernels; the last
line of stdout is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Scratch files go to build/smoke/ under the repository and
are removed at the end.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "unpack": ("mlvfs_tpu_torch/csrc/unpack.cu", "mlvfs_tpu/ops/unpack.py:96"),
    "chroma_smooth": ("mlvfs_tpu_torch/csrc/chroma.cu", "mlvfs_tpu/ops/chroma_pallas.py:156"),
    "pn_blur_interleaved": ("mlvfs_tpu_torch/csrc/patternnoise.cu",
                            "mlvfs_tpu/ops/patternnoise_fused.py:205"),
    "pn_blur_split": ("mlvfs_tpu_torch/csrc/patternnoise.cu",
                      "mlvfs_tpu/ops/patternnoise_pallas.py:129"),
    "dualiso_preview": ("mlvfs_tpu_torch/csrc/dualiso_preview.cu",
                        "mlvfs_tpu/ops/dualiso_preview_pallas.py:107"),
    "alias_filter": ("mlvfs_tpu_torch/csrc/alias.cu", "mlvfs_tpu/ops/alias_pallas.py:110"),
    "amaze_edge_pick": ("mlvfs_tpu_torch/csrc/amaze_edge.cu", "mlvfs_tpu/ops/amaze_edge_pallas.py:136"),
    "amaze_demosaic": ("mlvfs_tpu_torch/csrc/amaze.cu", "mlvfs_tpu/ops/amaze_pallas.py:688"),
    "amaze_raster_passes": ("mlvfs_tpu_torch/csrc/amaze_scans.cu",
                            "mlvfs_tpu/ops/amaze_scans_pallas.py:356"),
}
DNG_HEADER = 65536
# the card's published peaks (NVIDIA H100 SXM data sheet, at the 700 W limit):
# HBM3 bandwidth, and int32 ALU operations: 132 SMs x 64 int32 lanes x
# 1.98 GHz, a quarter of the 67 TFLOP/s float32 rate (half the lanes, and an
# FMA counts two there)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound(n_bytes: float, n_ops: float, ops_per_s: float = INT32_OPS_PER_S):
    """(least time in ms, "bytes" or "operations"): each input read once and
    each output written once at the HBM rate, against the operations at the
    rate of their type (int32 unless given); the larger bounds."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_vs_plain():
    """Phase 2. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/14 bpp/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import unpack

    gen = torch.Generator(device="cuda").manual_seed(2024)
    max_err = 0
    headline = None
    for bpp in (8, 10, 12, 14):
        # (H, W, B, words cut off the end of the stream)
        cases = [(1080, 1920, 16, 0), (727, 1808, 4, 0), (727, 1807, 2, 0), (1080, 1920, 2, 1001)]
        for h, w, b, cut in cases:
            n_words = unpack.words_for_pixels(h * w, bpp) - cut
            words = torch.randint(-32768, 32768, (b, n_words), dtype=torch.int16,
                                  device="cuda", generator=gen)
            got = unpack.unpack_batch(words, bpp, h, w)
            want = unpack.unpack_batch_plain(words, bpp, h, w)
            torch.cuda.synchronize()
            err = int(((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"unpack kernel == plain at bpp={bpp} {h}x{w} B={b} cut={cut} (max err {err})")
        h, w, b = 1080, 1920, 16
        words = torch.randint(-32768, 32768, (b, unpack.words_for_pixels(h * w, bpp)),
                              dtype=torch.int16, device="cuda", generator=gen)
        plain_a = _median_ms(lambda: unpack.unpack_batch_plain(words, bpp, h, w))
        kernel_a = _median_ms(lambda: unpack.unpack_batch(words, bpp, h, w))
        kernel_b = _median_ms(lambda: unpack.unpack_batch(words, bpp, h, w))
        plain_b = _median_ms(lambda: unpack.unpack_batch_plain(words, bpp, h, w))
        kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        moved = words.numel() * 2 + b * h * w * 2
        print(f"unpack bpp={bpp} {w}x{h} B={b}: kernel {kernel_ms:.4f} ms "
              f"({moved / kernel_ms / 1e6:.1f} GB/s, runs {kernel_a:.4f}/{kernel_b:.4f}), "
              f"plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f})")
        if bpp == 14:
            # 3 integer operations a pixel: its shift(s), or and mask
            headline = (kernel_ms, plain_ms, *bound(moved, 3 * b * h * w))
    print(f"unpack kernel vs plain: bit-equal in all cases, max_abs_err {max_err}; "
          f"bound at 14 bpp {headline[2]:.4f} ms ({headline[3]})")
    return (max_err, *headline)


def chroma_ops(method: int, n_cells: int) -> int:
    """Integer operations the smoothing needs: per cell its green mean (add,
    halve) and two chroma differences, once; two median networks of 2
    operations a compare-exchange; the skip rule, the two sums, clamps and
    black offsets (13)."""
    from mlvfs_tpu_torch.ops import medians

    k = {2: 5, 3: 9, 5: 25}[method]
    network = len(medians.prune(medians.NETWORKS[k], k // 2))
    return n_cells * (4 + 2 * 2 * network + 13)


def chroma_vs_plain(card: str):
    """Phase 2b. Returns {method: (max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by)} at 1080p/B=16, black 2047."""
    import torch

    from mlvfs_tpu_torch.ops import chroma_smooth as cs

    gen = torch.Generator(device="cuda").manual_seed(2025)
    max_err = 0
    for method in cs.METHODS:
        for black in (2047, 2048):
            for b, h, w in [(16, 1080, 1920), (4, 727, 1808), (1, 8, 8), (1, 8, 16), (1, 16, 8)]:
                imgs = torch.randint(black - 40, 16000, (b, h, w), dtype=torch.int32,
                                     device="cuda", generator=gen)
                imgs[:, 10:20, 5:35] = black
                imgs = imgs.to(torch.int16)
                got = cs.chroma_smooth_batch(imgs, method, black)
                want = cs.chroma_smooth_batch_plain(imgs, method, black)
                torch.cuda.synchronize()
                err = int(((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(got, want), f"chroma kernel == plain at method={method} "
                      f"black={black} {h}x{w} B={b} (max err {err})")
    print(f"chroma kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    out = {}
    b, h, w, black = 16, 1080, 1920, 2047
    imgs = torch.randint(black - 40, 16000, (b, h, w), dtype=torch.int32, device="cuda",
                         generator=gen).to(torch.int16)
    lut_bytes = (1 << 16) * 4 + 14 * 32768 * 4
    moved = 2 * imgs.numel() * 2 + lut_bytes
    for method in cs.METHODS:
        plain_a = _median_ms(lambda: cs.chroma_smooth_batch_plain(imgs, method, black), reps=7)
        kernel_a = _median_ms(lambda: cs.chroma_smooth_batch(imgs, method, black))
        kernel_b = _median_ms(lambda: cs.chroma_smooth_batch(imgs, method, black))
        plain_b = _median_ms(lambda: cs.chroma_smooth_batch_plain(imgs, method, black), reps=7)
        kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        ny, nx = cs.cell_window(h, w)
        bound_ms, bound_by = bound(moved, chroma_ops(method, b * ny * nx))
        print(f"chroma cs{method}x{method} {w}x{h} B={b}: kernel {kernel_ms:.4f} ms "
              f"({moved / kernel_ms / 1e6:.1f} GB/s, runs {kernel_a:.4f}/{kernel_b:.4f}), "
              f"plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound "
              f"{bound_ms:.4f} ms ({bound_by}; bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms), "
              f"kernel at {100 * bound_ms / kernel_ms:.1f} % of it [{card}]")
        out[method] = (max_err, kernel_ms, plain_ms, bound_ms, bound_by)
    return out


def blur_ops(img) -> int:
    """Integer operations the blur needs on these (B, H, W) int32 frames,
    whatever way it selects (#3 and #4 compute the same function): the
    window depends only on the cell's green mean, so per 2x2 cell the mean
    (2), 3 a step of the window walk (the steps up to and including the one
    that stops it), R - avg and B - avg (2), the green medians' mean and its
    two add-backs (3); per pixel an exact median of its n window entries,
    at least 2n - 3 compares (selection needs 2n - o(n))."""
    from mlvfs_tpu_torch.ops import patternnoise as pn

    s = pn.STRENGTH
    total = 0
    for frame in img:
        avg = (frame[0::2, 1::2] + frame[1::2, 0::2]) >> 1
        valid, _ = pn.window(avg)
        n = valid.sum(-1)
        steps = ((valid[..., s + 1 :].sum(-1) + 1).clamp(max=s - 1)
                 + (valid[..., :s].sum(-1) + 1).clamp(max=s))
        total += int((7 + 3 * steps + 4 * (2 * n - 3).clamp(min=0)).sum())
    return total


def pn_frames(gen, b, h, w, white=15000):
    """(B, H, W) int32 test frames for the blur: a flat noisy half (wide
    windows), full-range int16 pixels elsewhere (negative, i.e. u16 values
    at and above 32768), a band above white."""
    import torch

    x = torch.randint(-32768, 32768, (b, h, w), device="cuda", generator=gen, dtype=torch.int32)
    x[:, :, : w // 2] = 3000 + torch.randint(-40, 40, (b, h, w // 2), device="cuda", generator=gen,
                                             dtype=torch.int32)
    x[:, h // 3 : h // 3 + 4, w // 4 : w // 2] = white + 100
    return x


def pn_vs_plain(card: str):
    """Phase 2c. Returns {kernel: (max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by)} at 1080p/B=16 on the convert phase's 5D3 frames, and the
    launches of the split kernel in this phase."""
    import numpy as np
    import torch

    from mlvfs_tpu_torch.ops import patternnoise as pn
    from mlvfs_tpu_torch.ops import patternnoise_fused as pf

    gen = torch.Generator(device="cuda").manual_seed(2026)
    sites = ((0, 0), (0, 1), (1, 0), (1, 1))
    max_err = 0
    reset_launches()
    for b, h, w in [(2, 1080, 1920), (1, 1078, 1920), (2, 64, 124), (2, 64, 128), (1, 96, 1808)]:
        x = pn_frames(gen, b, h, w)
        got = pf.blur_interleaved(x)
        want = pf.blur_interleaved_plain(x)
        planes = [x[:, py::2, px::2].contiguous() for py, px in sites]
        got4 = pn.edge_aware_blur(*planes)
        want4 = pn.edge_aware_blur_plain(*planes)
        torch.cuda.synchronize()
        err = max(int((g - t).abs().max()) for g, t in zip((got, *got4), (want, *want4)))
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"blur kernel #3 == plain at {h}x{w} B={b} (max err {err})")
        check(all(torch.equal(g, t) for g, t in zip(got4, want4)),
              f"blur kernel #4 == plain at {h}x{w} B={b} (max err {err})")
    split_launches = pn.KERNEL_LAUNCHES
    print(f"pattern-noise blur kernels #3, #4 vs plain: bit-equal in all cases, max_abs_err {max_err}")

    b, h, w = 16, 1080, 1920
    x = torch.from_numpy(pattern_noise_frames(b, w, h).astype(np.int32)).cuda()
    planes = [x[:, py::2, px::2].contiguous() for py, px in sites]
    n_ops = blur_ops(x)
    moved = 2 * x.numel() * 4
    out = {}
    for name, kernel, plain in [
        ("pn_blur_interleaved", lambda: pf.blur_interleaved(x), lambda: pf.blur_interleaved_plain(x)),
        ("pn_blur_split", lambda: pn.edge_aware_blur(*planes),
         lambda: pn.edge_aware_blur_plain(*planes)),
    ]:
        plain_a = _median_ms(plain, reps=3, warmup=1)
        kernel_a = _median_ms(kernel)
        kernel_b = _median_ms(kernel)
        plain_b = _median_ms(plain, reps=3, warmup=1)
        kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        bound_ms, bound_by = bound(moved, n_ops)
        print(f"{name} {w}x{h} B={b}: kernel {kernel_ms:.4f} ms (runs {kernel_a:.4f}/{kernel_b:.4f}), "
              f"plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms "
              f"({bound_by}: {n_ops / (b * h * w):.1f} int32 operations a pixel; bytes alone "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms), kernel at "
              f"{100 * bound_ms / kernel_ms:.1f} % of it [{card}]")
        out[name] = (max_err, kernel_ms, plain_ms, bound_ms, bound_by)
    return out, split_launches


def preview_inputs(gen, b, h, w, black=2048, white=15000):
    """Frames with an over-white band and a below-shadow block, and one fit
    per frame, the dark-row phase cycling over 0..3."""
    import torch

    imgs = torch.randint(0, 1 << 14, (b, h, w), device="cuda", generator=gen, dtype=torch.int32)
    imgs[:, h // 4 : h // 2, : w // 3] = white + 7
    imgs[:, h // 2 :, w // 2 :] = 5
    a = torch.rand(b, device="cuda", generator=gen) * 0.4 + 0.06
    bb = torch.rand(b, device="cuda", generator=gen) * 40 - 20
    shadow = torch.full((b,), float(black + 900), device="cuda")
    drs = torch.arange(b, device="cuda", dtype=torch.int32) % 4
    return imgs.to(torch.int16), a, bb, shadow, drs


def preview_vs_plain(card: str):
    """Phase 2d. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import dualiso as di

    gen = torch.Generator(device="cuda").manual_seed(2027)
    black, white = 2048, 15000
    max_err = 0
    for b, h, w in [(16, 1080, 1920), (4, 5, 1920), (4, 6, 640), (4, 7, 300)]:
        args = preview_inputs(gen, b, h, w, black, white)
        got = di.apply_preview(*args, black, white)
        want = di.apply_preview_plain(*args, black, white)
        torch.cuda.synchronize()
        err = int(((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"preview kernel == plain at {h}x{w} B={b} (max err {err})")
    print(f"preview kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    b, h, w = 16, 1080, 1920
    args = preview_inputs(gen, b, h, w, black, white)
    plain_a = _median_ms(lambda: di.apply_preview_plain(*args, black, white), reps=3, warmup=1)
    kernel_a = _median_ms(lambda: di.apply_preview(*args, black, white))
    kernel_b = _median_ms(lambda: di.apply_preview(*args, black, white))
    plain_b = _median_ms(lambda: di.apply_preview_plain(*args, black, white), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    moved = 2 * b * h * w * 2
    # float32 operations a pixel on its longest branch: scale (4) twice,
    # the mean (3), the selects and the clip (6)
    bound_ms, bound_by = bound(moved, 17 * b * h * w, FP32_OPS_PER_S)
    print(f"preview {w}x{h} B={b}: kernel {kernel_ms:.4f} ms ({moved / kernel_ms / 1e6:.1f} GB/s, "
          f"runs {kernel_a:.4f}/{kernel_b:.4f}), plain {plain_ms:.4f} ms (runs "
          f"{plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}), kernel at "
          f"{100 * bound_ms / kernel_ms:.1f} % of it [{card}]")
    return max_err, kernel_ms, plain_ms, bound_ms, bound_by


def alias_ops(n_selected: int, n_pixels: int) -> int:
    """Integer operations the filter chain needs: for each pixel it selects
    (inner and not skipped) the 6th largest of 37 values, at least 50
    comparisons (n - k + ceil(log2 C(n, k-1)), n = 37, k = 6), and the blur,
    44 tap additions, 8 multiplies and 8 shifts; for every pixel the select
    and its share of the 2x2 cell max (2)."""
    return n_selected * (50 + 60) + 2 * n_pixels


def alias_vs_plain(card: str):
    """Phase 2e. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import alias

    gen = torch.Generator(device="cuda").manual_seed(2028)
    max_err = 0
    cases = [(16, 1080, 1920), (16, 1060, 1872)] + [(3, h, w) for h in (5, 12, 13, 64, 300)
                                                    for w in (37, 40)]
    for b, h, w in cases:
        for density in (0.0, 0.5, 1.0):
            a = torch.randint(0, 65531, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
            skip = torch.rand((b, h, w), device="cuda", generator=gen) < density
            got = alias.alias_filter(a, skip)
            want = alias.alias_filter_plain(a, skip)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"alias kernel == plain at {h}x{w} B={b} skip {density} (max err {err})")
    print(f"alias kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    b, h, w = 16, 1080, 1920
    a = torch.randint(0, 15001, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
    skip = torch.rand((b, h, w), device="cuda", generator=gen) < 0.2
    plain_a = _median_ms(lambda: alias.alias_filter_plain(a, skip), reps=3, warmup=1)
    kernel_a = _median_ms(lambda: alias.alias_filter(a, skip))
    kernel_b = _median_ms(lambda: alias.alias_filter(a, skip))
    plain_b = _median_ms(lambda: alias.alias_filter_plain(a, skip), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    moved = b * h * w * (4 + 1 + 4)
    n_sel = int((alias.inner_mask(h, w, "cuda") & ~skip).sum())
    bound_ms, bound_by = bound(moved, alias_ops(n_sel, b * h * w))
    print(f"alias filter {w}x{h} B={b}, skip density 0.2: kernel {kernel_ms:.4f} ms "
          f"({moved / kernel_ms / 1e6:.1f} GB/s, runs {kernel_a:.4f}/{kernel_b:.4f}), plain "
          f"{plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}; "
          f"bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, {n_sel} pixels select), kernel at "
          f"{100 * bound_ms / kernel_ms:.1f} % of it [{card}]")
    return max_err, kernel_ms, plain_ms, bound_ms, bound_by


def edge_ops(n_scored: int, n_pixels: int) -> int:
    """Integer operations the edge pick needs, counted in the reference's
    form: per scored pixel (in the window, not restricted) 12 directions of
    three tap differences and their absolute values and sums (8), the 11-tap
    box sum by doubled partial sums (5), the direction's penalty (1) and the
    running least (2); per pixel the window and restricted tests (3), the
    three candidates (a doubled tap, a sum, a division: 3 each) and their
    weighted mean (4), and the neighbours' clamps (2)."""
    return n_scored * 12 * 16 + n_pixels * 18


def edge_inputs(gen, b, h, w, density):
    """EV planes of the gray image and the two tap classes (flat areas where
    directions tie), per-row signs of the four dark-row phases, a restricted
    map of the given density."""
    import torch

    from mlvfs_tpu_torch.ops.luts import EV_RESOLUTION as evr

    ev = [torch.randint(-2 * evr, 14 * evr, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
          for _ in range(3)]
    ev[0][:, h // 3 :, : w // 2] //= 64
    ys = torch.arange(h, device="cuda")[None, :] - torch.arange(b, device="cuda")[:, None]
    s = torch.where(((ys % 4) >= 2) == (((ys + 1) % 4) >= 2), -1, 1).to(torch.int32)
    restricted = torch.rand((b, h, w), device="cuda", generator=gen) < density
    return (*ev, s, restricted)


def edge_vs_plain(card: str):
    """Phase 2f. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/B=16, restricted density 1/2."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_edge

    gen = torch.Generator(device="cuda").manual_seed(2029)
    max_err = 0
    cases = [(16, 1080, 1920), (16, 1060, 1872), (3, 300, 41), (3, 64, 40), (3, 11, 12), (2, 5, 7)]
    for b, h, w in cases:
        for density in (0.0, 0.5, 1.0):
            args = edge_inputs(gen, b, h, w, density)
            got = amaze_edge.edge_pick(*args)
            want = amaze_edge.edge_pick_plain(*args)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"edge kernel #6 == plain at {h}x{w} B={b} restricted {density} (max err {err})")
    print(f"edge kernel #6 vs plain: bit-equal in all cases, max_abs_err {max_err}")
    b, h, w = 16, 1080, 1920
    args = edge_inputs(gen, b, h, w, 0.5)
    plain_a = _median_ms(lambda: amaze_edge.edge_pick_plain(*args), reps=3, warmup=1)
    kernel_a = _median_ms(lambda: amaze_edge.edge_pick(*args))
    kernel_b = _median_ms(lambda: amaze_edge.edge_pick(*args))
    plain_b = _median_ms(lambda: amaze_edge.edge_pick_plain(*args), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    moved = b * h * w * (3 * 4 + 1 + 4) + b * h * 4
    ys = torch.arange(h, device="cuda")[:, None]
    xs = torch.arange(w, device="cuda")[None, :]
    window = (ys >= 5) & (ys < h - 5) & (xs >= 5) & (xs < w - 5)
    n_scored = int((window & ~args[4]).sum())
    bound_ms, bound_by = bound(moved, edge_ops(n_scored, b * h * w))
    print(f"edge pick {w}x{h} B={b}, restricted density 0.5: kernel {kernel_ms:.4f} ms "
          f"({moved / kernel_ms / 1e6:.1f} GB/s, runs {kernel_a:.4f}/{kernel_b:.4f}), plain "
          f"{plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}; "
          f"bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, {n_scored} pixels scored), kernel at "
          f"{100 * bound_ms / kernel_ms:.1f} % of it [{card}]")
    return max_err, kernel_ms, plain_ms, bound_ms, bound_by


def amaze_mosaics(gen, b, h, w):
    """(B, H, W) float32 RGGB mosaics on the 20-bit scale the reconstruction
    hands AMaZE: a smooth scene with diagonal stripes (Nyquist areas), noise,
    and a clipped block."""
    import torch

    y = torch.arange(h, device="cuda", dtype=torch.float64)[:, None]
    x = torch.arange(w, device="cuda", dtype=torch.float64)[None, :]
    gains = torch.tensor([[0.85, 1.0], [1.0, 0.55]], device="cuda", dtype=torch.float64)
    gain = gains[(y.long() % 2), (x.long() % 2)]
    frames = []
    for i in range(b):
        base = (9000 + 6000 * torch.sin(x / (7.0 + i)) * torch.cos(y / 11.0)
                + 20000 * (((x + 2 * y) % 97) < 18))
        img = base * gain + 60 * torch.randn((h, w), device="cuda", generator=gen, dtype=torch.float64)
        img[h // 3 : h // 2, w // 4 : w // 2] = 900000
        frames.append(img.clamp(0, (1 << 20) - 1))
    return torch.stack(frames).float()


# float32 operations AMaZE's stencil stages need per padded pixel, counted
# from csrc/amaze.cu (a fused multiply-add as 2, per-cell work halved over
# the cell's two pixels): gradients 28, cardinal interpolation 107,
# selection and bounding 78, hvwt and the Nyquist test 89, populate and
# the Nyquist refinement's fixed part 3, diagonal interpolation 64, rbint 3,
# G correction and the chroma planes 49, output 25; and per Nyquist cell
# the area sums (49 taps of 28 operations and their totals, 1,420), the
# curvature (13) and the refinement (45)
AMAZE_OPS_PER_PADDED_PX = 446
AMAZE_OPS_PER_NYQ_CELL = 1478
# float32 / int32 operations a pixel of the five raster passes of one
# demosaic, per pass over its (B, hp, wp) plane: refine 5 (twice), chroma 20
# (each of the two planes: 79 a cell on a quarter of the pixels), dilate 8
RASTER_FP32_OPS_PER_PX = 2 * 5 + 2 * 20
RASTER_INT32_OPS_PER_PX = 8


def _profiled_ms(fn, match, reps=3):
    """Median over ``reps`` calls of the device time of the kernels whose
    names contain one of ``match`` (torch.profiler), in ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per_call.append(sum(e.time_range.elapsed_us() for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and any(m in e.name for m in match)) / 1e3)
    per_call.sort()
    return per_call[len(per_call) // 2]


STAGE_KERNELS = ("k_gradients", "k_cardinal", "k_select", "k_hvwt", "k_area", "k_populate",
                 "k_curvature", "k_nyq_refine", "k_diag", "k_rbint", "k_gcorr", "k_output")
PASS_KERNELS = ("refine_kernel", "dilate_kernel", "chroma_kernel")


def amaze_vs_plain(card: str):
    """Phase 2g. Returns ({"amaze_demosaic": row, "amaze_raster_passes": row},
    launches of the raster passes in the phase), rows (max_abs_err,
    kernel_ms, plain_ms, bound_ms, bound_by) at 1080p/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core, amaze_scans

    gen = torch.Generator(device="cuda").manual_seed(2030)
    pass_err = 0.0
    for b, hp, wp in [(16, 1112, 1952), (16, 1092, 1904), (2, 224, 192), (1, 40, 34), (1, 290, 50)]:
        wt = torch.rand((b, hp, wp), device="cuda", generator=gen)
        nyq = (torch.rand((b, hp, wp), device="cuda", generator=gen) > 0.6).to(torch.int32)
        D = 0.1 * torch.randn((b, hp, wp), device="cuda", generator=gen)
        got = [amaze_scans.dilate(nyq), amaze_scans.refine(wt), amaze_scans.chroma(D, 0),
               amaze_scans.chroma(D, 1)]
        want = [amaze_core.dilate_plain(nyq), amaze_core.refine_plain(wt), amaze_core.chroma_plain(D, 0),
                amaze_core.chroma_plain(D, 1)]
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"raster pass #10 dilate == plain at {hp}x{wp} B={b}")
        for name, g, v in zip(("refine", "chroma 0", "chroma 1"), got[1:], want[1:]):
            err = float((g.double() - v.double()).abs().max())
            pass_err = max(pass_err, err)
            check(err <= 0.01, f"raster pass #10 {name} within 0.01 of plain at {hp}x{wp} B={b} "
                               f"(max err {err})")
    print(f"raster pass kernels #10 vs plain: dilate bit-equal, refine and chroma max_abs_err "
          f"{pass_err} ({'bit-equal' if pass_err == 0 else 'not bit-equal'})")

    demosaic_err = 0.0
    for b, h, w in [(16, 1080, 1920), (16, 1060, 1872), (1, 160, 224), (2, 17, 18), (1, 320, 352)]:
        raw = amaze_mosaics(gen, b, h, w)
        got = amaze_core.amaze_demosaic(raw)
        want = amaze_core.amaze_demosaic_plain(raw)
        torch.cuda.synchronize()
        for name, g, v in zip("RGB", got, want):
            check(bool(torch.isfinite(g).all()) and g.shape == (b, h, w),
                  f"AMaZE #8 {name}: finite {b}x{h}x{w}")
            err = float((g.double() - v.double()).abs().max())
            demosaic_err = max(demosaic_err, err)
            check(bool(torch.allclose(g, v, rtol=1e-5, atol=0.01)),
                  f"AMaZE #8 {name} within rtol 1e-5 / atol 0.01 of plain at {h}x{w} B={b} (max err {err})")
        del got, want
    print(f"AMaZE kernel #8 (with #10) vs plain: max_abs_err {demosaic_err} on the 0..65535 scale "
          f"({'bit-equal' if demosaic_err == 0 else 'not bit-equal'})")

    b, h, w = 16, 1080, 1920
    hp, wp = h + 2 * amaze_core.PAD, w + 2 * amaze_core.PAD
    raw = amaze_mosaics(gen, b, h, w)
    captured = {}
    dilate = amaze_scans.dilate

    def capture(nyq0, out=None):
        captured["nyq"] = dilate(nyq0, out=out)
        return captured["nyq"]

    amaze_scans.dilate = capture
    try:
        amaze_core.amaze_demosaic(raw)
    finally:
        amaze_scans.dilate = dilate
    rbmask = ((torch.arange(hp, device="cuda")[:, None] + torch.arange(wp, device="cuda")[None, :]) % 2) == 0
    n_nyq = int(((captured["nyq"] > 0) & rbmask).sum())

    def run():
        return amaze_core.amaze_demosaic(raw)

    # #8's plain twin alone: the twin's stencil stages with #10's kernels as
    # the raster passes between them
    pass_kernels = {"refine": amaze_scans.refine, "dilate": amaze_scans.dilate,
                    "chroma": amaze_scans.chroma}

    def plain_stages():
        return amaze_core._stencil_stages_plain(amaze_core.pad_mosaic(raw), pass_kernels)

    stage_ms = _profiled_ms(run, STAGE_KERNELS)
    passes_ms = _profiled_ms(run, PASS_KERNELS)
    per_pass = {name: _profiled_ms(run, (name,)) for name in PASS_KERNELS}
    whole_a = _median_ms(run, reps=5)
    plain_a = _median_ms(plain_stages, reps=3, warmup=1)
    twin_a = _median_ms(lambda: amaze_core.amaze_demosaic_plain(raw), reps=3, warmup=1)
    whole_b = _median_ms(run, reps=5)
    plain_b = _median_ms(plain_stages, reps=3, warmup=1)
    twin_b = _median_ms(lambda: amaze_core.amaze_demosaic_plain(raw), reps=3, warmup=1)
    whole_ms, plain_ms, twin_ms = min(whole_a, whole_b), min(plain_a, plain_b), min(twin_a, twin_b)
    n_padded = b * hp * wp
    moved = b * h * w * 4 * 4  # one plane in, three out
    t_ops = (n_padded * AMAZE_OPS_PER_PADDED_PX + n_nyq * AMAZE_OPS_PER_NYQ_CELL) / FP32_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S
    amaze_bound = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    print(f"AMaZE demosaic {w}x{h} B={b}: stencil stages #8 {stage_ms:.4f} ms, raster passes #10 "
          f"{passes_ms:.4f} ms (device time of their kernels, torch.profiler), the whole call "
          f"{whole_ms:.4f} ms (runs {whole_a:.4f}/{whole_b:.4f}); plain twin of the stages (with the "
          f"#10 kernels) {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}), the whole plain twin "
          f"{twin_ms:.4f} ms (runs {twin_a:.4f}/{twin_b:.4f}); #8 bound {amaze_bound[0]:.4f} ms ({amaze_bound[1]}; {n_nyq} "
          f"Nyquist cells; bytes alone {t_bytes * 1e3:.4f} ms), #8 at "
          f"{100 * amaze_bound[0] / stage_ms:.1f} % of it [{card}]")
    print("raster passes #10 inside that demosaic (torch.profiler): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in per_pass.items())
          + f" (refine and chroma launch twice, dilate once) [{card}]")

    # the five passes of one demosaic on planes of its shape, each against its twin
    wt = torch.rand((b, hp, wp), device="cuda", generator=gen)
    nyq = (torch.rand((b, hp, wp), device="cuda", generator=gen) > 0.6).to(torch.int32)
    D = 0.1 * torch.randn((b, hp, wp), device="cuda", generator=gen)

    def passes(refine, dilate_, chroma):
        return (dilate_(nyq), refine(wt), refine(wt), chroma(D, 1), chroma(D, 0))

    def kernel_passes():
        return passes(amaze_scans.refine, amaze_scans.dilate, amaze_scans.chroma)

    def plain_passes():
        return passes(amaze_core.refine_plain, amaze_core.dilate_plain, amaze_core.chroma_plain)

    plain_a = _median_ms(plain_passes, reps=3, warmup=1)
    kernel_a = _median_ms(kernel_passes)
    kernel_b = _median_ms(kernel_passes)
    plain_b = _median_ms(plain_passes, reps=3, warmup=1)
    kernel_ms, pplain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    p_bytes = 5 * 2 * n_padded * 4 / HBM_BYTES_PER_S
    p_ops = (n_padded * RASTER_FP32_OPS_PER_PX / FP32_OPS_PER_S
             + n_padded * RASTER_INT32_OPS_PER_PX / INT32_OPS_PER_S)
    pass_bound = (max(p_bytes, p_ops) * 1e3, "operations" if p_ops > p_bytes else "bytes")
    print(f"raster passes #10, the five of one demosaic at {wp}x{hp} B={b}: kernels {kernel_ms:.4f} ms "
          f"(runs {kernel_a:.4f}/{kernel_b:.4f}), plain {pplain_ms:.4f} ms (runs {plain_a:.4f}/"
          f"{plain_b:.4f}); bound {pass_bound[0]:.4f} ms ({pass_bound[1]}), kernels at "
          f"{100 * pass_bound[0] / kernel_ms:.1f} % of it [{card}]")
    return {"amaze_demosaic": (demosaic_err, stage_ms, plain_ms, *amaze_bound),
            "amaze_raster_passes": (pass_err, kernel_ms, pplain_ms, *pass_bound)}


def synth_clip(path, frames, width, height, camera_model, camera_name, frame_data=None, **kw):
    import numpy as np

    from mlvfs_tpu_torch.format import synth

    os.makedirs(os.path.dirname(path), exist_ok=True)
    spec = synth.SynthSpec(width=width, height=height, frames=frames, bpp=14,
                           camera_model=camera_model, camera_name=camera_name, **kw)
    if frame_data is None:
        rng = np.random.default_rng(spec.seed)
        frame_data = np.stack([synth.make_frame_data(spec, rng) for _ in range(frames)])
    synth.write_mlv(path, spec, frame_data=frame_data)
    return frame_data


def dng_files(outdir):
    return sorted(os.path.join(outdir, n) for n in os.listdir(outdir) if n.endswith(".dng"))


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _counters():
    from mlvfs_tpu_torch.ops import (alias, amaze_core, amaze_edge, amaze_scans, chroma_smooth,
                                     dualiso, patternnoise, patternnoise_fused, unpack)

    return {"unpack": unpack, "chroma_smooth": chroma_smooth,
            "pn_blur_interleaved": patternnoise_fused, "pn_blur_split": patternnoise,
            "dualiso_preview": dualiso, "alias_filter": alias, "amaze_edge_pick": amaze_edge,
            "amaze_demosaic": amaze_core, "amaze_raster_passes": amaze_scans}


def reset_launches():
    for module in _counters().values():
        module.KERNEL_LAUNCHES = 0


def read_launches() -> dict:
    return {name: module.KERNEL_LAUNCHES for name, module in _counters().items()}


def dng_levels(raw: bytes):
    """(BlackLevel, WhiteLevel) of a DNG, from its IFD0."""
    import struct

    ifd = struct.unpack_from("<I", raw, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", raw, ifd)[0]):
        tag, _, _, value = struct.unpack_from("<HHII", raw, ifd + 2 + 12 * i)
        tags[tag] = value
    return tags[50714], tags[50717]


def convert_cli(clip, outdir, device, *flags):
    """One conversion through the CLI. Returns (seconds, unpack launches)."""
    from mlvfs_tpu_torch import cli
    from mlvfs_tpu_torch.ops import unpack

    before = unpack.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    rc = cli.main(["convert", clip, "-o", outdir, "--device", device, *flags])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"convert {clip} exit code 0 (got {rc})")
    return seconds, unpack.KERNEL_LAUNCHES - before


def main_path(work, device="cuda", frames_5d3=64, frames_eosm=32, size_5d3=(1920, 1080),
              size_eosm=(1872, 1060), card="", batch_size=16):
    """Phase 3: the default convert of the 5D3 and EOS M clips. Returns the
    kernel launches of the phase."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    cuda = device.startswith("cuda")
    w, h = size_5d3
    clip = os.path.join(work, "5d3", "M5D3.MLV")
    data = synth_clip(clip, frames_5d3, w, h, 0x80000285, "Canon EOS 5D Mark III")
    out = os.path.join(work, "5d3_out")
    secs, launches = convert_cli(clip, out, device)
    files = dng_files(out)
    check(len(files) == frames_5d3, f"5D3: {frames_5d3} DNGs (got {len(files)})")
    for i, p in enumerate(files):
        raw = read(p)
        check(len(raw) == DNG_HEADER + w * h * 2, f"5D3 DNG size of {p}")
        payload = np.frombuffer(raw, "<u2", offset=DNG_HEADER).reshape(h, w)
        check(np.array_equal(payload, data[i]), f"5D3 DNG payload {i} == synthesized frame")
    want = math.ceil(frames_5d3 / batch_size) if cuda else 0
    check(launches == want, f"5D3: unpack kernel launches {launches} == batches {want}")
    mb = frames_5d3 * (DNG_HEADER + w * h * 2) / 1e6
    print(f"convert 5D3 {w}x{h} 14-bit, {frames_5d3} frames, --device {device}: "
          f"{secs:.3f} s, {frames_5d3 / secs:.1f} f/s, {mb / secs:.1f} MB/s written [{card}]")
    total = launches

    w, h = size_eosm
    clip = os.path.join(work, "eosm", "MEOSM.MLV")
    data = synth_clip(clip, frames_eosm, w, h, 0x80000331, "Canon EOS M")
    out = os.path.join(work, "eosm_out")
    secs, launches = convert_cli(clip, out, device)
    files = dng_files(out)
    check(len(files) == frames_eosm, f"EOS M: {frames_eosm} DNGs (got {len(files)})")
    for p in files:
        check(os.path.getsize(p) == DNG_HEADER + w * h * 2, f"EOS M DNG size of {p}")
    want = math.ceil(frames_eosm / batch_size) if cuda else 0
    check(launches == want, f"EOS M: unpack kernel launches {launches} == batches {want}")
    payload0 = np.frombuffer(read(files[0]), "<u2", offset=DNG_HEADER).reshape(h, w)
    fixed = int((payload0 != data[0]).sum())
    check(fixed > 0, "EOS M: the focus-pixel fix changed frame 0")
    ref_out = os.path.join(work, "eosm_cpu")
    n_ref = min(4, frames_eosm)
    convert_clip(clip, ref_out, ProcessingConfig(device="cpu"), frames=range(n_ref))
    for p, q in zip(files[:n_ref], dng_files(ref_out)):
        check(read(p) == read(q), f"EOS M {os.path.basename(p)}: {device} == cpu, byte for byte")
    print(f"convert EOS M {w}x{h} 14-bit, {frames_eosm} frames, --device {device}: "
          f"{secs:.3f} s, {frames_eosm / secs:.1f} f/s; focus fix changed {fixed} px of "
          f"frame 0; first {n_ref} DNGs == cpu conversion [{card}]")
    return total + launches


FLAGS_ON = ["--deflicker", "3000", "--cs3x3", "--stripes", "--bad-pix"]


def flagged_frames(frames, width, height, seed=77):
    """5D3 test frames with a period-8 column gain and hot/cold pixels at
    green sites (which chroma smoothing leaves alone)."""
    import numpy as np

    from mlvfs_tpu_torch.format import synth

    spec = synth.SynthSpec(width=width, height=height, frames=frames)
    rng = np.random.default_rng(seed)
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(frames)]).astype(np.float64)
    gain = np.array([1.0, 1.0, 1.04, 0.985, 1.0, 1.01, 0.97, 1.0])[np.arange(width) % 8]
    data = spec.black + (data - spec.black) * gain
    cold = [(20, 31), (101, 400), (500, 1201)]  # (y, x): even y, odd x = green
    hot = [(9, 14), (13, 10), (41, 62)]  # odd y, even x = green, in the dark corner
    for y, x in cold:
        data[:, y, x] = 0
    for y, x in hot:
        data[:, y, x] = 16383
    return np.clip(data, 0, 16383).astype(np.uint16), cold + hot


def flags_on_path(work, card, device="cuda", frames=48, size=(1920, 1080), batch_size=16):
    """Phase 3b: the flags-on convert of a 1080p 5D3 clip. Returns the
    launches per kernel."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip
    from mlvfs_tpu_torch.utils import metrics

    w, h = size
    data, bad = flagged_frames(frames, w, h)
    clip = os.path.join(work, "flags", "MFLAGS.MLV")
    synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III", frame_data=data)
    out = os.path.join(work, "flags_out")
    metrics.reset()
    reset_launches()
    secs, _ = convert_cli(clip, out, device, *FLAGS_ON)
    launches = read_launches()
    stages = metrics.snapshot()["stage_seconds"]
    files = dng_files(out)
    check(len(files) == frames, f"flags-on: {frames} DNGs (got {len(files)})")
    want = math.ceil(frames / batch_size) if device.startswith("cuda") else 0
    for name, n in launches.items():
        expect = want if name in ("unpack", "chroma_smooth") else 0
        check(n == expect, f"flags-on: {name} kernel launches {n} == {expect}")

    payload0 = np.frombuffer(read(files[0]), "<u2", offset=DNG_HEADER).reshape(h, w)
    for y, x in bad:
        check(payload0[y, x] != data[0, y, x], f"flags-on: bad pixel ({x}, {y}) fixed")
    green = (np.arange(h)[:, None] + np.arange(w)[None, :]) % 2 == 1
    striped = np.isin(np.arange(w) % 8, (2, 3, 5, 6))[None, :] & green
    restriped = int((payload0 != data[0])[striped].sum())
    check(restriped > 10000, f"flags-on: stripe correction changed green pixels ({restriped})")
    # columns 0 and 1 are the reference columns, whose gain is exactly one
    reference = np.isin(np.arange(w) % 8, (0, 1))[None, :] & green
    untouched = int((payload0 != data[0])[reference].sum())
    check(untouched <= len(bad), f"flags-on: reference green columns untouched ({untouched})")

    n_ref = 4
    ref_out = os.path.join(work, "flags_cpu")
    convert_clip(clip, ref_out, ProcessingConfig(
        device="cpu", use_sidecar_idx=False, deflicker=3000, chroma_smooth=3, fix_stripes=True,
        fix_bad_pixels=1), frames=range(n_ref))
    for p, q in zip(files[:n_ref], dng_files(ref_out)):
        check(read(p) == read(q), f"flags-on {os.path.basename(p)}: {device} == cpu, byte for byte")
    mb = frames * (DNG_HEADER + w * h * 2) / 1e6
    print(f"convert 5D3 {w}x{h} 14-bit {' '.join(FLAGS_ON)}, {frames} frames, --device {device}: "
          f"{secs:.3f} s, {frames / secs:.1f} f/s, {mb / secs:.1f} MB/s written; stages (s, "
          f"overlapping) " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
          + f"; launches {launches}; {len(bad)} bad pixels fixed, stripes changed {restriped} "
          f"green px of frame 0; first {n_ref} DNGs == cpu conversion [{card}]")
    return launches


def pattern_noise_frames(frames, width, height, seed=78):
    """5D3 test frames with per-column and per-row fixed-pattern noise."""
    import numpy as np

    from mlvfs_tpu_torch.format import synth

    spec = synth.SynthSpec(width=width, height=height, frames=frames)
    rng = np.random.default_rng(seed)
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(frames)]).astype(np.float64)
    data += rng.normal(0, 6, width)[None, None, :] + rng.normal(0, 5, height)[None, :, None]
    return np.clip(data, 0, 16383).astype(np.uint16)


def pattern_noise_path(work, card, device="cuda", frames=32, size=(1920, 1080), batch_size=16):
    """Phase 3c: ``--fix-pattern-noise`` on a 1080p 5D3 clip. Returns the
    launches per kernel."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import ClipConverter
    from mlvfs_tpu_torch.format.reader import MLVClip

    w, h = size
    data = pattern_noise_frames(frames, w, h)
    clip = os.path.join(work, "pn", "MPN.MLV")
    synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III", frame_data=data)
    out = os.path.join(work, "pn_out")
    reset_launches()
    secs, _ = convert_cli(clip, out, device, "--fix-pattern-noise")
    launches = read_launches()
    files = dng_files(out)
    check(len(files) == frames, f"pattern noise: {frames} DNGs (got {len(files)})")
    batches = math.ceil(frames / batch_size) if device.startswith("cuda") else 0
    check(launches["pn_blur_interleaved"] == 2 * batches,
          f"pattern noise: blur kernel launches {launches['pn_blur_interleaved']} == 2 x {batches}")
    payload0 = np.frombuffer(read(files[0]), "<u2", offset=DNG_HEADER).reshape(h, w)
    changed = int((payload0 != data[0]).sum())
    check(changed > w * h // 4, f"pattern noise changed frame 0 ({changed} px)")
    n_ref = 2
    ref_out = os.path.join(work, "pn_cpu")
    t0 = time.perf_counter()
    with MLVClip(clip) as mlv:
        conv = ClipConverter(mlv, ProcessingConfig(device="cpu", fix_pattern_noise=True))
        try:
            conv.convert(ref_out, frames=range(n_ref))
        finally:
            conv.close()
    cpu_secs = time.perf_counter() - t0
    for p, q in zip(files[:n_ref], dng_files(ref_out)):
        check(read(p) == read(q), f"pattern noise {os.path.basename(p)}: {device} == cpu, byte for byte")
    print(f"convert 5D3 {w}x{h} 14-bit --fix-pattern-noise, {frames} frames, --device {device}: "
          f"{secs:.3f} s, {frames / secs:.1f} f/s; launches {launches}; changed {changed} px of "
          f"frame 0; first {n_ref} DNGs == cpu conversion ({cpu_secs:.1f} s on the cpu) [{card}]")
    return launches


def dual_iso_frames(frames, width, height, odd_plain=False, seed=79):
    """Dual-ISO test frames (3 EV, dark rows from 0); with ``odd_plain`` the
    odd frames are ordinary single-ISO frames, and hot and cold pixels sit
    in the first of them."""
    import dataclasses

    import numpy as np

    from mlvfs_tpu_torch.format import synth

    spec = synth.SynthSpec(width=width, height=height, frames=frames, dual_iso=3)
    plain = dataclasses.replace(spec, dual_iso=0)
    rng = np.random.default_rng(seed)
    data = np.stack([synth.make_frame_data(plain if odd_plain and i % 2 else spec, rng)
                     for i in range(frames)])
    if odd_plain:
        data[1, 101, 200], data[1, 301, 400] = 16383, 0
    return data


def dual_iso_path(work, card, device="cuda", frames=32, size=(1920, 1080),
                  eosm_frames=20, eosm_size=(1872, 1060), batch_size=16):
    """Phase 3d: ``--dual-iso-preview`` on a 1080p dual-ISO 5D3 clip, and on
    an EOS M clip with single-ISO odd frames plus ``--bad-pix --cs2x2
    --stripes``. Returns the launches per kernel of both converts."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    total = {}
    cases = [
        ("5D3", size, frames, 0x80000285, "Canon EOS 5D Mark III", False, []),
        ("EOS M", eosm_size, eosm_frames, 0x80000331, "Canon EOS M", True,
         ["--bad-pix", "--cs2x2", "--stripes"]),
    ]
    for tag, (w, h), n, model, name, odd_plain, extra in cases:
        data = dual_iso_frames(n, w, h, odd_plain)
        clip = os.path.join(work, f"di_{model:x}", "MDI.MLV")
        synth_clip(clip, n, w, h, model, name, frame_data=data, dual_iso=3)
        out = os.path.join(work, f"di_{model:x}_out")
        reset_launches()
        secs, _ = convert_cli(clip, out, device, "--dual-iso-preview", "--no-idx", *extra)
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        files = dng_files(out)
        check(len(files) == n, f"dual-ISO {tag}: {n} DNGs (got {len(files)})")
        batches = math.ceil(n / batch_size) if device.startswith("cuda") else 0
        check(launches["dualiso_preview"] == batches,
              f"dual-ISO {tag}: preview kernel launches {launches['dualiso_preview']} == {batches}")
        if extra:
            check(launches["chroma_smooth"] == 2 * batches,
                  f"dual-ISO {tag}: mixed batches smooth under both levels")
        ref_out = os.path.join(work, f"di_{model:x}_cpu")
        flags = dict(dual_iso=1, use_sidecar_idx=False)
        if extra:
            flags.update(fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True)
        t0 = time.perf_counter()
        convert_clip(clip, ref_out, ProcessingConfig(device="cpu", **flags))
        cpu_secs = time.perf_counter() - t0
        ri_black, ri_white = 2048, 15000
        converted = 0
        for i, (p, q) in enumerate(zip(files, dng_files(ref_out))):
            raw = read(p)
            check(raw == read(q), f"dual-ISO {tag} {os.path.basename(p)}: {device} == cpu, byte for byte")
            dual = not (odd_plain and i % 2)
            want = (4 * ri_black, 4 * ri_white) if dual else (ri_black, ri_white)
            check(dng_levels(raw) == want, f"dual-ISO {tag} frame {i}: levels {dng_levels(raw)} == {want}")
            if not extra:  # the preview's <<2 output, untouched by later steps
                payload = np.frombuffer(raw, "<u2", offset=DNG_HEADER)
                check(bool((payload % 4 == 0).all()), f"dual-ISO {tag} frame {i}: converted")
            converted += dual
        print(f"convert {tag} {w}x{h} 14-bit dual-ISO {' '.join(['--dual-iso-preview', *extra])}, {n} frames, "
              f"--device {device}: {secs:.3f} s, {n / secs:.1f} f/s; launches {launches}; {converted} "
              f"frames converted at x4 levels, the rest at their own; all {n} DNGs == cpu "
              f"conversion ({cpu_secs:.1f} s on the cpu) [{card}]")
    return total


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10 * math.log10(65535.0 ** 2 / mse)


DUAL_ISO_FULL = ["--dual-iso", "--mean23"]
DUAL_ISO_AMAZE = ["--dual-iso"]  # amaze-edge, the default interpolation


def dual_iso_full_path(work, card, device="cuda", frames=32, size=(1920, 1080),
                       eosm_frames=20, eosm_size=(1872, 1060), batch_size=16, n_ref=4,
                       interp="mean23"):
    """Phase 3e (``interp="mean23"``): ``--dual-iso --mean23`` on a 1080p
    dual-ISO 5D3 clip, and on an EOS M clip with single-ISO odd frames plus
    ``--bad-pix --cs2x2 --stripes``; then the 5D3 clip under
    ``--no-alias-map``. Phase 3f (``interp="amaze"``): the same two clips
    with ``--dual-iso`` (amaze-edge), where per batch #6 and #8 launch once
    and #10 five times. Returns the launches per kernel of the first two
    converts."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    program = DUAL_ISO_FULL if interp == "mean23" else DUAL_ISO_AMAZE
    method = 1 if interp == "mean23" else 0
    amaze_per_batch = {"amaze_edge_pick": 0, "amaze_demosaic": 0, "amaze_raster_passes": 0} \
        if interp == "mean23" else {"amaze_edge_pick": 1, "amaze_demosaic": 1, "amaze_raster_passes": 5}
    total = {}
    cases = [
        ("5D3", size, frames, 0x80000285, "Canon EOS 5D Mark III", False, [], {}),
        ("EOS M", eosm_size, eosm_frames, 0x80000331, "Canon EOS M", True,
         ["--bad-pix", "--cs2x2", "--stripes"], dict(fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True)),
    ]
    ri_black, ri_white = 2048, 15000
    clips = {}
    for tag, (w, h), n, model, name, odd_plain, extra, flags in cases:
        data = dual_iso_frames(n, w, h, odd_plain, seed=80)
        clip = os.path.join(work, f"dif_{interp}_{model:x}", "MDIF.MLV")
        clips[tag] = clip
        synth_clip(clip, n, w, h, model, name, frame_data=data, dual_iso=3)
        out = os.path.join(work, f"dif_{interp}_{model:x}_out")
        reset_launches()
        secs, _ = convert_cli(clip, out, device, *program, "--no-idx", *extra)
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        files = dng_files(out)
        check(len(files) == n, f"dual-ISO full {tag}: {n} DNGs (got {len(files)})")
        batches = math.ceil(n / batch_size) if device.startswith("cuda") else 0
        check(launches["alias_filter"] == batches,
              f"dual-ISO full {tag}: alias kernel launches {launches['alias_filter']} == {batches}")
        check(launches["chroma_smooth"] == 0 and launches["dualiso_preview"] == 0,
              f"dual-ISO full {tag}: no 16-bit chroma or preview kernel ({launches})")
        for name, per_batch in amaze_per_batch.items():
            check(launches[name] == per_batch * batches,
                  f"dual-ISO full {tag} {interp}: {name} launches {launches[name]} == "
                  f"{per_batch} x {batches}")
        converted = 0
        for i, p in enumerate(files):
            dual = not (odd_plain and i % 2)
            want = (4 * ri_black, 4 * ri_white) if dual else (ri_black, ri_white)
            got = dng_levels(read(p))
            check(got == want, f"dual-ISO full {tag} frame {i}: levels {got} == {want}")
            converted += dual
        ref_out = os.path.join(work, f"dif_{interp}_{model:x}_cpu")
        t0 = time.perf_counter()
        convert_clip(clip, ref_out, ProcessingConfig(
            device="cpu", dual_iso=2, hdr_interpolation_method=method, use_sidecar_idx=False, **flags),
            frames=range(n_ref))
        cpu_secs = time.perf_counter() - t0
        worst_psnr, worst_share = math.inf, 0.0
        for i, (p, q) in enumerate(zip(files[:n_ref], dng_files(ref_out))):
            raw, ref = read(p), read(q)
            check(raw[:DNG_HEADER] == ref[:DNG_HEADER],
                  f"dual-ISO full {tag} {os.path.basename(p)}: header == cpu, byte for byte")
            if odd_plain and i % 2:
                check(raw == ref, f"dual-ISO full {tag} {os.path.basename(p)} (not converted): "
                                  f"{device} == cpu, byte for byte")
                continue
            a = np.frombuffer(raw, "<u2", offset=DNG_HEADER)
            b = np.frombuffer(ref, "<u2", offset=DNG_HEADER)
            pv, share = psnr(a, b), float((a != b).mean())
            check(pv >= 90 and share <= 0.03, f"dual-ISO full {tag} {os.path.basename(p)}: {device} "
                  f"vs cpu PSNR {pv:.1f} dB >= 90, {100 * share:.4f} % of pixels differ <= 3 %")
            worst_psnr, worst_share = min(worst_psnr, pv), max(worst_share, share)
        print(f"convert {tag} {w}x{h} 14-bit dual-ISO {' '.join([*program, *extra])}, {n} frames, "
              f"--device {device}: {secs:.3f} s, {n / secs:.1f} f/s; launches {launches}; {converted} "
              f"frames converted at x4 levels, the rest at their own; first {n_ref} DNGs vs cpu "
              f"({cpu_secs:.1f} s on the cpu): headers and unconverted frames equal, converted "
              f"frames PSNR >= {worst_psnr:.1f} dB, at most {100 * worst_share:.4f} % of pixels "
              f"differ [{card}]")
    if interp != "mean23":
        return total
    out = os.path.join(work, "dif_noalias_out")
    reset_launches()
    secs, _ = convert_cli(clips["5D3"], out, device, *DUAL_ISO_FULL, "--no-alias-map", "--no-idx")
    launches = read_launches()
    check(launches["alias_filter"] == 0, f"--no-alias-map: alias kernel launches {launches['alias_filter']} == 0")
    files = dng_files(out)
    check(len(files) == frames and all(dng_levels(read(p)) == (4 * ri_black, 4 * ri_white) for p in files),
          "--no-alias-map: every frame converted at x4 levels")
    print(f"convert 5D3 {size[0]}x{size[1]} {' '.join(DUAL_ISO_FULL)} --no-alias-map, {frames} frames: "
          f"{secs:.3f} s; launches {launches} [{card}]")
    return total


def compressed_variants(work, device="cuda", frames=8, size=(1920, 1080)):
    """Phase 4: LZMA and LJ92 clips convert to the uncompressed clip's DNGs."""
    w, h = size
    outs = {}
    data = None
    for comp in ("none", "lzma", "lj92"):
        clip = os.path.join(work, f"short_{comp}", "SHORT.MLV")
        data = synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III",
                          frame_data=data, compression=comp)
        outs[comp] = os.path.join(work, f"short_{comp}_out")
        convert_cli(clip, outs[comp], device)
    plain = dng_files(outs["none"])
    check(len(plain) == frames, f"short clip: {frames} DNGs")
    for comp in ("lzma", "lj92"):
        files = dng_files(outs[comp])
        check([os.path.basename(p) for p in files] == [os.path.basename(p) for p in plain],
              f"{comp}: same DNG names as uncompressed")
        for p, q in zip(files, plain):
            check(read(p) == read(q), f"{comp} {os.path.basename(p)} == uncompressed, byte for byte")
    print(f"compressed variants {w}x{h}, {frames} frames: LZMA and LJ92 DNGs == uncompressed")


def breakdown(work, card, frames):
    """``--breakdown N``: the per-layer times of the flags-on, pattern-noise,
    preview and full dual-ISO steps (mean23 and amaze-edge), then each of
    the five programs as an N-frame 1080p convert: twice, and once under
    torch.profiler."""
    import numpy as np
    import torch

    import types

    from mlvfs_tpu_torch.ops import (alias, amaze, amaze_core, amaze_edge, chroma_smooth, dualiso,
                                     dualiso_analysis_dev, dualiso_full, histogram, patternnoise,
                                     patternnoise_fused, pixels, stripes, unpack)
    from mlvfs_tpu_torch.utils import metrics

    w, h, b, black, white = 1920, 1080, 16, 2048, 15000
    data, _ = flagged_frames(b, w, h)
    t0 = time.perf_counter()
    bad = pixels.detect_bad_pixels(data[0], w, h, black, False, 0, 0)
    t1 = time.perf_counter()
    gains, _ = stripes.compute_correction(data[0], black, white, w, frame_size_bytes=w * h * 14 // 8)
    t2 = time.perf_counter()
    print(f"once per clip, host: bad-pixel detection {1e3 * (t1 - t0):.1f} ms ({len(bad)} px), "
          f"stripe calibration {1e3 * (t2 - t1):.1f} ms [{card}]")
    imgs = torch.from_numpy(data.view(np.int16)).cuda()
    words = torch.randint(-32768, 32768, (b, unpack.words_for_pixels(h * w, 14)),
                          dtype=torch.int16, device="cuda")
    pn_imgs = torch.from_numpy(pattern_noise_frames(b, w, h).view(np.int16)).cuda()
    raw = pn_imgs.to(torch.int32)
    den = patternnoise_fused.blur_interleaved(raw)
    di_imgs = torch.from_numpy(dual_iso_frames(b, w, h).view(np.int16)).cuda()
    fh = types.SimpleNamespace(raw_info=types.SimpleNamespace(black_level=black, white_level=white))
    hists, counts = dualiso.green_phase_histograms(di_imgs, white)
    fits = dualiso.fit_preview(hists, counts, black, white)
    fit_args = [torch.tensor([getattr(f, k) for f in fits], dtype=dt, device="cuda") for k, dt in (
        ("a", torch.float32), ("b", torch.float32), ("shadow", torch.float32),
        ("dark_row_start", torch.int32))]

    def preview_fit():
        hs, cs = dualiso.green_phase_histograms(di_imgs, white)
        return dualiso.fit_preview(hs, cs, black, white)

    # the full dual-ISO path's stages on the same frames (RGGB: no row offset)
    is_hdr = dualiso_full.hdr_check_batch(di_imgs, black, white)

    def full_analysis():
        res = dualiso_analysis_dev.analyze_batch(di_imgs, is_hdr, 0, h, black)
        torch.stack([res[0].to(torch.int32), res[-1]]).cpu()  # the batch's one readback
        return res

    ok, *scalars, white20s = full_analysis()
    check(bool(ok.all()), "breakdown: every dual-ISO frame converts")
    recon_kw = dict(black20=black * 64, white20=int(white20s[0]), interp_method=1, use_fullres=True,
                    use_alias=True, cs_method=0, exact_luts=False)
    captured = {}

    def capture(a_map, skip):
        captured["args"] = (a_map, skip)
        return alias_filter(a_map, skip)

    alias_filter = dualiso_full.alias_ops.alias_filter
    dualiso_full.alias_ops.alias_filter = capture
    try:
        dualiso_full.reconstruct_batch(di_imgs, *scalars, **recon_kw)
    finally:
        dualiso_full.alias_ops.alias_filter = alias_filter
    alias_map, alias_skip = captured["args"]
    # the amaze-edge reconstruction's own AMaZE mosaics and edge-pick inputs
    amaze_kw = dict(recon_kw, interp_method=0)
    demosaic, edge_pick = amaze.amaze_demosaic, amaze.edge_pick

    def capture_demosaic(sq):
        captured["squeezed"] = sq
        return demosaic(sq)

    def capture_edge(*args):
        captured["edge"] = args
        return edge_pick(*args)

    amaze.amaze_demosaic, amaze.edge_pick = capture_demosaic, capture_edge
    try:
        dualiso_full.reconstruct_batch(di_imgs, *scalars, **amaze_kw)
    finally:
        amaze.amaze_demosaic, amaze.edge_pick = demosaic, edge_pick
    squeezed, edge_args = captured["squeezed"], captured["edge"]

    layers = [
        ("unpack kernel", lambda: unpack.unpack_batch(words, 14, h, w)),
        ("deflicker median", lambda: histogram.deflicker_median(imgs, (1 << 14) + 1)),
        ("pattern noise, whole step (2 directions)",
         lambda: patternnoise.fix_pattern_noise_batch(pn_imgs, white)),
        ("  pattern-noise blur kernel #3, rows", lambda: patternnoise_fused.blur_interleaved(raw)),
        ("  pattern-noise column stage, rows",
         lambda: patternnoise_fused.fix_column_noise_interleaved(raw, den, white)),
        ("dual-ISO preview, whole step", lambda: dualiso.hdr_preview_batch(di_imgs, fh, None)),
        ("  preview samples + readback + host fit (syncs)", preview_fit),
        ("  preview kernel #5", lambda: dualiso.apply_preview(di_imgs, *fit_args, black, white)),
        ("dual-ISO full: hdr_check", lambda: dualiso_full.hdr_check_batch(di_imgs, black, white)),
        ("dual-ISO full: analysis + its readback (syncs)", full_analysis),
        ("dual-ISO full: reconstruction (mean23, alias map)",
         lambda: dualiso_full.reconstruct_batch(di_imgs, *scalars, **recon_kw)),
        ("  alias kernel #7 on the reconstruction's map", lambda: alias.alias_filter(alias_map, alias_skip)),
        ("dual-ISO full: reconstruction (amaze-edge, alias map)",
         lambda: dualiso_full.reconstruct_batch(di_imgs, *scalars, **amaze_kw)),
        ("  AMaZE demosaic, kernels #8 + #10, on its squeezed frames",
         lambda: amaze_core.amaze_demosaic(squeezed)),
        ("  edge kernel #6 on its EV planes", lambda: amaze_edge.edge_pick(*edge_args)),
        ("bad-pixel fix", lambda: pixels.fix_pixel_list_batch(imgs, bad, black, 0, 0, False)),
        ("chroma kernel cs3x3", lambda: chroma_smooth.chroma_smooth_batch(imgs, 3, black)),
        ("stripe apply", lambda: stripes.apply_correction_batch(imgs, gains, black, white)),
    ]
    window = torch.zeros_like(edge_args[4])
    window[:, 5:-5, 5:-5] = True
    n_scored = int((window & ~edge_args[4]).sum())
    print(f"the amaze-edge reconstruction's edge pick scores {n_scored} of {edge_args[4].numel()} "
          f"pixels ({100 * n_scored / edge_args[4].numel():.1f} %) on these frames [{card}]")
    for name, fn in layers:
        device_ms = _median_ms(fn)
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(1e3 * (time.perf_counter() - t0))
        print(f"per batch of {b} at {w}x{h}: {name}: device {device_ms:.4f} ms, host enqueue "
              f"{sorted(host)[10]:.4f} ms [{card}]")

    programs = [
        ("flags-on", FLAGS_ON, flagged_frames(frames, w, h)[0], {}),
        ("pattern-noise", ["--fix-pattern-noise"], pattern_noise_frames(frames, w, h), {}),
        ("dual-ISO preview", ["--dual-iso-preview"], dual_iso_frames(frames, w, h),
         {"dual_iso": 3}),
        ("dual-ISO full", DUAL_ISO_FULL, dual_iso_frames(frames, w, h), {"dual_iso": 3}),
        ("dual-ISO amaze-edge", DUAL_ISO_AMAZE, dual_iso_frames(frames, w, h), {"dual_iso": 3}),
    ]
    for label, flags, data, spec in programs:
        clip = os.path.join(work, "bd", "MBD.MLV")
        synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III", frame_data=data, **spec)
        cal = os.path.splitext(clip)[0] + ".CAL"
        for run in ("run 1", "run 2", "profiled"):
            if os.path.exists(cal):
                os.unlink(cal)  # every run calibrates, as a first conversion does
            out = os.path.join(work, "bd_out")
            shutil.rmtree(out, ignore_errors=True)
            metrics.reset()
            if run != "profiled":
                secs, _ = convert_cli(clip, out, "cuda", *flags)
                stages = metrics.snapshot()["stage_seconds"]
                print(f"{label} convert {w}x{h}, {frames} frames, {run}: {secs:.3f} s, "
                      f"{frames / secs:.1f} f/s; stages (s, overlapping) "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
                      + f" [{card}]")
                continue
            profiled_convert(label, clip, out, flags, card)
        shutil.rmtree(os.path.dirname(clip), ignore_errors=True)


def profiled_convert(label, clip, out, flags, card):
    """One convert under torch.profiler: wall time, the device's busy share
    (the union of its kernel and copy spans), device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        convert_cli(clip, out, "cuda", *flags)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name = {}
    for e in dev:
        total, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), n + 1)
    print(f"profiled {label} convert: wall {wall_ms:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e3 / wall_ms:.1f} % of wall) [{card}]")
    for name, (total, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  device {total / 1e3:8.3f} ms  x{n:<5d} {name[:90]}")


def check_no_reference(what: str) -> None:
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "mlvfs_tpu"))
    check(not loaded, f"{what} without jax and without mlvfs_tpu (loaded: {loaded[:5]})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mlvfs_tpu_torch import _build

    check_no_reference("the port loads")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {', '.join(sorted({src for src, _ in KERNELS.values()}))} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if len(sys.argv) == 3 and sys.argv[1] == "--breakdown":
        try:
            breakdown(work, card, int(sys.argv[2]))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        check_no_reference("the port ran")
        return 0

    unpack_row = kernel_vs_plain()
    chroma_rows = chroma_vs_plain(card)
    pn_rows, split_launches = pn_vs_plain(card)
    preview_row = preview_vs_plain(card)
    alias_row = alias_vs_plain(card)
    edge_row = edge_vs_plain(card)
    amaze_rows = amaze_vs_plain(card)
    try:
        reset_launches()
        default_launches = main_path(work, card=card)
        check(default_launches > 0, "the default path launched the unpack kernel")
        check(sum(read_launches().values()) == read_launches()["unpack"],
              "the default path runs no kernel but unpack")
        flags_launches = flags_on_path(work, card)
        pn_launches = pattern_noise_path(work, card)
        di_launches = dual_iso_path(work, card)
        full_launches = dual_iso_full_path(work, card, n_ref=2)
        amaze_launches = dual_iso_full_path(work, card, n_ref=2, interp="amaze")
        compressed_variants(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check_no_reference("the port ran")

    rows = {"unpack": unpack_row, "chroma_smooth": chroma_rows[3],  # the path's --cs3x3
            **pn_rows, "dualiso_preview": preview_row, "alias_filter": alias_row,
            "amaze_edge_pick": edge_row, **amaze_rows}
    launches = {name: flags_launches[name] + pn_launches[name] + di_launches[name] + full_launches[name]
                + amaze_launches[name] for name in rows}
    launches["unpack"] += default_launches
    for name in ("pn_blur_interleaved", "dualiso_preview", "alias_filter", "amaze_edge_pick",
                 "amaze_demosaic", "amaze_raster_passes"):
        check(launches[name] > 0, f"the main paths launched {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes any of these functions
        # kernel #4 is on no convert path: its launches there are 0, and
        # those of its kernel phase are listed apart
        **({"kernel_phase_launches": split_launches} if name == "pn_blur_split" else {}),
    } for name, (err, ms, plain_ms, bound_ms, bound_by) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
