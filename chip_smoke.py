#!/usr/bin/env python3
"""GPU smoke test of mlvfs_tpu_torch, the PyTorch + CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

  1. the card's name and power limit; build of the CUDA kernels from csrc/,
     one nvcc per source, all started together;
  2. the unpack kernel against its plain PyTorch twin on the card, bit-equal
     (torch.equal), at 8/10/12/14/16 bpp (its own forms) and 11 (the form
     for every other bpp): 1920x1080 with B=16, 1808x727, a pixel count that
     leaves a partial last block, streams cut short by 1001 words and by 3
     (inside the last group of 8 blocks), and batches whose frames start
     off 16-byte boundaries in words and pixels; the call's time by CUDA
     events (the kernels line's ms) with the kernel's device time
     (torch.profiler) beside it, the plain twin's, GB/s and the share of the
     byte bound;
  2b. the chroma-smoothing kernel against its plain twin, bit-equal, for the
     2x2/3x3/5x5 methods at black 2047 and 2048: 1920x1080 with B=16,
     1808x727 with B=4, the windowless 8x8, 8x16 and 16x8, every frame with a
     10x30 block at exactly black; frames over the whole u16 range at black
     x 4 (8188, 8192: the dual-ISO preview's), a frame at or above 16,384
     everywhere (past the raw->EV table's staged part), and the widest and
     shortest windowed shapes (5760x10, 10x1080, 10x10); at 1080p/B=16 the
     call's time by CUDA events and its device time (torch.profiler), the
     share of the bound counted from the fewest operations an exact selection
     needs (csrc/chroma.cu's shared sorted rows) and the operations the
     design's own steps do;
  2c. the pattern-noise blur kernels, interleaved (#3) and split-plane (#4),
     against their plain twin, bit-equal: 1920x1080 with B=2, 1078 rows, the
     2-, 124- and 128-px widths at and below the blur window, frames with
     pixels at and above 32768 and above white, an all-flat frame (every
     window 50 entries), one whose cell averages jump every cell (every
     window one entry) and one with window edges every 5 to 40 cells;
     median CUDA-event times at 1080p/B=16 on phase 3c's 5D3 frames, the
     share of the bound counted from the operations those frames' windows
     need, and the operations a pixel #3's own steps do there (its counting
     entry point);
  2d. the dual-ISO preview kernel (#5) against its plain twin, bit-equal:
     1080p with B=16 across the four dark-row phases, with over-white and
     below-shadow pixels, heights 5, 6, 7 (below one 32-row chunk), 33 and
     70, and widths 300, 306, 97 and 1872 (not a multiple of its 128-column
     block; rows copied 8 or 4 bytes at a time, or plainly); the call's
     time by CUDA events (the kernels line's ms, as for every kernel) with
     the kernel's device time (torch.profiler) beside it, the difference
     being the wrapper's host work, and share of bound;
  2e. the alias-map filter kernel (#7) against its plain twin, bit-equal:
     1080p and 1872x1060 with B=16, heights 5, 12, 13, 64 and 300 at odd and
     even widths and 129x130 (not a multiple of its 64 x 64 tile), skip
     densities 0, 1/2, 0.9 and 1, single working pixels at tile corners, a
     block of work among tiles without any, a flat map and runs of equal
     values; times at 1080p/B=16 at skip 0.2 and 0.9, each with the share
     of the bound counted from the pixels those inputs select and the
     operations the design's own steps do there;
  2f. the edge scorer and pick kernel (#6) against its plain twin, bit-equal,
     in each of its forms (per tile as picked, every tile row by row, every
     tile pixel by pixel): 1080p and 1872x1060 with B=16, heights 300, 64,
     11 and 5 at odd and even widths, 61x250 and 1077x1930 (not a multiple
     of its 8 x 128 tile), restricted densities 0, 1/2, 0.96 and 1, single
     scored pixels at tile corners and a block of work among tiles without
     any; times of each form at 1080p/B=16 at density 0.5 and 0.96, each
     with the share of the bound counted from the pixels those inputs
     score and the operations the design's own steps do there;
  2g. the AMaZE raster-pass kernels (#10) against their plain twins,
     bit-equal, on the 1080p and EOS M padded planes (B=16) and on short,
     two-tile and partial-tile planes, planes of 4 and 6 rows (fewer than
     the ring holds), rows not 16-B aligned, the widest planes each ring
     takes (2048 columns for dilate, 7264 for refine) and the next, and a
     plane too wide for both (7800 columns), then the AMaZE demosaic (#8's five stage
     group launches with #10 between them) against its plain twin,
     bit-equal, at 1080p and 1872x1060 with B=16, at 160x224, 320x352,
     300x50 and at 17x18 and 33x46 (narrower than a tile and its aprons),
     and on Nyquist stripes across a tile edge; #8's and #10's time in one
     demosaic at 1080p/B=16 (each stage group and each pass apart, by CUDA
     events over launches of its own on the workspace a demosaic filled,
     each pass with its bound), #8's workspace in planes and GB, the whole
     call and the twin by CUDA events, and the five passes of one demosaic
     against their twins;
  2h. the fused AMaZE kernel (#9, ``MLVFS_AMAZE_PALLAS_MODE=mega``) against
     the plain twin and against split mode (#8 + #10), bit-equal, at 1080p
     with B=16, at two-tile, three-tile, odd and smallest sizes, past the
     dilate ring's width (160x2100) and the refine ring's (96x7300), and on
     a batch of small frames whose tiles are more than the grid's blocks and
     no multiple of them; its time at 1080p/B=16 beside split mode's, the
     twin's and its bound; each of its ten steps' time from its
     %globaltimer stamps beside split mode's kernels and pad (CUDA events)
     on the same frames; its block size, blocks an SM, shared memory,
     workspace, and the registers and spills (ptxas -v) of #9 and of #8's
     group kernels;
  2i. the frame-level raster-pass entry points (#11: refine_frame,
     dilate_frame on float32 and int32 cells, chroma_frame's two planes in
     one launch) against their twins, bit-equal, on batched 1080p padded
     planes (B=16) and on 2-D, 1920-wide two-tile and short planes; their
     launches in this phase stand apart as ``kernel_phase_launches``;
  2j. the dual-ISO preview's fit kernel (``csrc/dualiso_preview_fit.cu``,
     which replaces no Pallas kernel: the reference fits in plain XLA)
     against its plain twin on the card, bit-equal (ok, a, b, shadow,
     dark-row start): 1080p dual-ISO frames with B=16 across the four
     dark-row phases, 640x192 dual, flat and single-ISO frames, EOS M
     1872x1060 frames, a width whose stored counts fall short of the
     slices, 1080p frames whose greens sit below black where several of
     detect_phase's cases hold (c1 or c2 with c3); the call's time by CUDA events with the twin's and the whole
     device fit's (sorts + kernel), and two bounds: bytes, and the walk's
     chain of dependent loads (its steps on these frames times two loads
     at the card's L2 latency, measured by ``csrc/l2_chase_probe.cu``);
  2k. the EV transforms' kernel (``csrc/evmath.cu``, which replaces no
     Pallas kernel: the reference computes them in plain XLA), each entry on
     its own at 1080p with B=16 against its plain twin on the card,
     bit-equal (NaNs as NaN), one launch a call: raw2ev20, ev2raw20 and the
     fullres curve over 20-bit inputs, log, log2, log2 + a per-frame c,
     exp2, fma over three full planes and with per-frame x and y; each
     call's time by CUDA events beside its byte bound and the twin's time;
  2l. the reconstruction's fused float stages (``csrc/dualiso_recon.cu``,
     which replaces no Pallas kernel), each entry at 1080p with B=16 against
     its plain twin on the card, bit-equal, one launch a call: match on a
     row slice of a batch, blend with the alias planes (the main path) and
     without (``--cs*``), the alias planes of smoothed planes, the final
     blend; each call's time by CUDA events beside its byte bound and the
     twin's time; the exposure fit's scoring kernel
     (``csrc/dualiso_scores.cu``, no Pallas original) against its twin on a
     1080p batch's highlight pairs, bit-equal and timed; then the dual-ISO
     analysis of a 1080p batch of 16 replayed from its CUDA graph against
     the eager analysis, bit-equal over three batches of other data, with
     both forms' host and device ms;
  3. the default convert path, ``python -m mlvfs_tpu_torch convert CLIP -o
     OUT --device cuda`` through ``cli.main``: a 1920x1080 14-bit 5D Mark III
     clip (64 frames) whose DNG payloads must equal the synthesized frames,
     and a 1872x1060 EOS M clip (32 frames, bundled focus-pixel map) whose
     first DNGs must be byte-identical to the port's own CPU conversion; the
     unpack kernel's launch count must grow by the number of batches;
  3b. the flags-on path, ``convert CLIP --deflicker 3000 --cs3x3 --stripes
     --stripes-batch-cal --bad-pix --device cuda``: a 1920x1080 14-bit 5D
     Mark III clip (48 frames) with a period-8 column gain and injected hot
     and cold pixels. The stripe and bad-pixel fixes must change pixels,
     each kernel must run once per batch (the EV kernel for the batch
     calibration, on the card only), the stripe gains (calibrated from
     the whole first batch on the card) must equal the port's CPU
     calibration of that batch, and the first 4 DNGs must be byte-identical
     to the port's own CPU conversion;
  3c. ``convert CLIP --fix-pattern-noise``: a 1080p 14-bit 5D Mark III clip
     (32 frames) with row and column noise. Kernel #3 must run twice per
     batch (rows, then columns), the fix must change pixels, and the first 2
     DNGs must be byte-identical to the port's CPU conversion of them;
  3d. ``convert CLIP --dual-iso-preview``: a 1080p dual-ISO 5D Mark III clip
     (32 frames), and a 1872x1060 EOS M clip (20 frames, bundled focus-pixel
     map) whose odd frames are not dual-ISO, with ``--bad-pix --cs2x2
     --stripes --stripes-batch-cal`` (a mixed first batch: the frame-0
     calibration). The card's default fit is the device fit: the fit kernel
     and kernel #5 must each run once per batch, converted frames must
     carry x4 levels and the others their own, and every DNG must be
     byte-identical to the port's CPU conversion under
     ``MLVFS_TPU_PREVIEW_DEV=1``; then both clips again under
     ``MLVFS_TPU_PREVIEW_DEV=0`` (the host fit, no fit kernel), every DNG
     byte-identical to the CPU's conversion in that mode;
  3e. ``convert CLIP --dual-iso --mean23``: a 1080p dual-ISO 5D Mark III
     clip (32 frames), and a 1872x1060 EOS M clip (20 frames) whose odd
     frames are single-ISO, with ``--bad-pix --cs2x2 --stripes``; hdr_check
     on the first 8 frames of each decides on the card as on the CPU, with
     the same sums to the bit. Kernel #7
     must run once per batch (each holds a converted frame) and not at all
     under ``--no-alias-map``, the EV kernel (2k) on the card only;
     converted frames carry x4 levels, the others their own. The first 2
     DNGs must be byte-identical to the port's CPU conversion of them (the
     PSNR and share of pixels that differ are printed beside);
  3f. ``convert CLIP --dual-iso`` (amaze-edge, the default interpolation)
     on the same two clips and flags as 3e: per batch (each holds a
     converted frame) kernels #6, #8 and #7 launch once and #10 five times;
     levels, and the first 2 DNGs against the port's CPU conversion, as in
     3e; then both clips once more with ``MLVFS_AMAZE_PALLAS_MODE=mega``:
     per batch #9 launches once and #8 and #10 not at all, and every DNG is
     byte-identical to the split mode's card DNGs, the first 2 also to the
     port's CPU DNGs;
  4. LZMA and LJ92 variants of a short 1080p clip through the card, whose
     DNGs must be byte-identical to the uncompressed clip's.

Each convert path runs with every kernel launch count set to 0 just before
it and read just after. Kernels #4 and #11 are on no convert path (the
reference reaches them only from tests, tools and stage-level swaps): their
``launches`` are 0, and their ``kernel_phase_launches`` are those of phases
2c and 2i, counted from 0.

``python3 chip_smoke.py --breakdown N`` instead measures where the time
goes (PERF.md section 5): each layer's device time per 1080p batch of 16 and
its host enqueue time (the pattern-noise, preview and full dual-ISO steps
too, the preview with its device fit and with its host fit, the host fit and
the full path's analysis with their readbacks included, the fit kernel
apart; the amaze-edge reconstruction with #8 + #10 and #6 on
its own inputs; #5's, #7's, #6's and #10's bounds on those inputs, beside
their times; #2 on the frames the flags-on program hands it, captured from
a convert), the once-per-clip calibration (the stripes' frame-0 host
calibration beside the whole-batch one on the card), and for each of the
flags-on, ``--fix-pattern-noise``, ``--dual-iso-preview`` (device fit, then
host fit), ``--dual-iso --mean23`` and ``--dual-iso`` programs two N-frame
converts and one under torch.profiler (device busy share, device time by
kernel). The full dual-ISO rows give the EV kernel's launches a call (0 in a
package without it). With ``--package-root DIR`` it measures another
checkout of the port (a parent unpacked by ``git archive``), so that both
are run in one call.
``python3 chip_smoke.py --kernel-times [--package-root DIR]`` times only
the unpack and chroma calls (phase 2's and 2b's inputs and the flags-on
frames), by CUDA events and by device time, and the AMaZE demosaic in mega
and split mode (phase 2h's 1080p mosaics, CUDA events; split mode's
kernels as phases 2g and 2h time them; #9's steps where the port stamps
them), for the port in DIR (default: this checkout), so
that another commit's kernels (a parent unpacked by ``git archive``) are
measured by the same code in the same call. ``python3 chip_smoke.py
--mega`` builds the kernels and runs phase 2h alone, ``--recon`` phase 2l.

Without a CUDA card it exits non-zero and prints no result. The line before the last is a JSON summary of the kernels; the last
line of stdout is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Scratch files go to build/smoke/ under the repository and
are removed at the end.
"""

from __future__ import annotations

import contextlib
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
    "amaze_mega": ("mlvfs_tpu_torch/csrc/amaze_mega.cu", "mlvfs_tpu/ops/amaze_pallas.py:673"),
    "amaze_raster_passes": ("mlvfs_tpu_torch/csrc/amaze_scans.cu",
                            "mlvfs_tpu/ops/amaze_scans_pallas.py:356"),
    "amaze_raster_frame": ("mlvfs_tpu_torch/csrc/amaze_scans.cu",
                           "mlvfs_tpu/ops/amaze_scans_pallas.py:155"),
    # no Pallas original: the reference fits in plain XLA (listed as such)
    "preview_fit": ("mlvfs_tpu_torch/csrc/dualiso_preview_fit.cu",
                    "mlvfs_tpu/ops/dualiso_preview_dev.py:67"),
    "evmath": ("mlvfs_tpu_torch/csrc/evmath.cu", "mlvfs_tpu/ops/evmath.py:20"),
    "dualiso_recon": ("mlvfs_tpu_torch/csrc/dualiso_recon.cu", "mlvfs_tpu/ops/dualiso_full.py:445"),
    "fit_scores": ("mlvfs_tpu_torch/csrc/dualiso_scores.cu", "mlvfs_tpu/ops/dualiso_analysis_dev.py:161"),
}
NO_PALLAS_ORIGINAL = {"preview_fit", "evmath", "dualiso_recon", "fit_scores"}
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


UNPACK_BPPS = (8, 10, 12, 14, 16, 11)  # csrc/unpack.cu's own forms, and one bpp without


def unpack_times(words, bpp, h, w, reps=20):
    """The unpack call at these words: (CUDA-event ms of two runs, the
    device time by torch.profiler and both its readings)."""
    from mlvfs_tpu_torch.ops import unpack

    def kernel():
        return unpack.unpack_batch(words, bpp, h, w)

    runs = (_median_ms(kernel, reps), _median_ms(kernel, reps))
    return runs, *_profiled_seen_ms(kernel, ("unpack_kernel",), "the unpack kernel")


def kernel_vs_plain():
    """Phase 2. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/14 bpp/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import unpack

    gen = torch.Generator(device="cuda").manual_seed(2024)
    max_err = 0
    headline = None
    for bpp in UNPACK_BPPS:
        # (H, W, B, words cut off the end of the stream, words the batch
        # starts after a 16-B boundary): partial last blocks, streams cut
        # short (1001 words; 3, inside the last group of 8 blocks), frames
        # whose words and pixels start off 16-B boundaries
        cases = [(1080, 1920, 16, 0, 0), (727, 1808, 4, 0, 0), (727, 1807, 2, 0, 0),
                 (1080, 1920, 2, 1001, 0), (727, 1807, 3, 0, 1), (1060, 1872, 2, 3, 3),
                 (1080, 1920, 2, 0, 4)]
        for h, w, b, cut, off in cases:
            n_words = unpack.words_for_pixels(h * w, bpp) - cut
            buf = torch.randint(-32768, 32768, (b * n_words + off,), dtype=torch.int16,
                                device="cuda", generator=gen)
            words = buf[off:].view(b, n_words)
            got = unpack.unpack_batch(words, bpp, h, w)
            want = unpack.unpack_batch_plain(words, bpp, h, w)
            torch.cuda.synchronize()
            err = int(((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"unpack kernel == plain at bpp={bpp} {h}x{w} B={b} cut={cut} offset={off} "
                  f"(max err {err})")
        h, w, b = 1080, 1920, 16
        words = torch.randint(-32768, 32768, (b, unpack.words_for_pixels(h * w, bpp)),
                              dtype=torch.int16, device="cuda", generator=gen)
        plain_a = _median_ms(lambda: unpack.unpack_batch_plain(words, bpp, h, w))
        (kernel_a, kernel_b), device_ms, device_runs = unpack_times(words, bpp, h, w)
        plain_b = _median_ms(lambda: unpack.unpack_batch_plain(words, bpp, h, w))
        kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        moved = words.numel() * 2 + b * h * w * 2
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        print(f"unpack bpp={bpp} {w}x{h} B={b}: kernel {kernel_ms:.4f} ms by CUDA events around "
              f"the call (runs {kernel_a:.4f}/{kernel_b:.4f}), of which {device_ms:.4f} ms device "
              f"time (torch.profiler; runs {device_runs}; {moved / device_ms / 1e6:.1f} GB/s), "
              f"plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bytes bound "
              f"{t_bytes:.4f} ms, the device time at {100 * t_bytes / device_ms:.1f} % of it")
        if bpp == 14:
            # 3 integer operations a pixel: its shift(s), or and mask
            headline = (kernel_ms, plain_ms, *bound(moved, 3 * b * h * w))
    print(f"unpack kernel vs plain: bit-equal in all cases, max_abs_err {max_err}; "
          f"bound at 14 bpp {headline[2]:.4f} ms ({headline[3]}), the call at "
          f"{100 * headline[2] / headline[0]:.1f} % of it")
    return (max_err, *headline)


# min/max operations of csrc/chroma.cu's selections (held to its source by
# tests/test_torch_kernel_models.py): 2x2's median of 5, and per sorted row
# and per selection from the sorted rows for 3x3 and 5x5
CHROMA_MEDIAN5_OPS = 10
CHROMA_ROW_SORT_OPS = {3: 6, 5: 18}
CHROMA_SELECT_OPS = {3: 12, 5: 98}
CHROMA_RUN = 8  # cells a thread walks down a column
CHROMA_CELL_OPS = 4 + 13  # the green mean and two differences; the rule, sums, clamps, offsets
CHROMA_EV2RAW_OPS = 12  # the packed octave's decode, per smoothed site


def chroma_ops(method: int, n_cells: int) -> int:
    """Integer operations the smoothing needs, with the fewest-operation
    exact selection known (csrc/chroma.cu's): per cell its green mean (add,
    halve) and two chroma differences, once; per median a row of 2R + 1
    neighbours sorted once a cell (each sorted row serves the 2R + 1 cells
    of its column) and the selection from the sorted rows, or 2x2's median
    of 5; the skip rule, the two sums, clamps and black offsets (13)."""
    per_median = (CHROMA_MEDIAN5_OPS if method == 2
                  else CHROMA_ROW_SORT_OPS[method] + CHROMA_SELECT_OPS[method])
    return n_cells * (CHROMA_CELL_OPS + 2 * per_median)


def chroma_design_ops(method: int, n_cells: int) -> float:
    """The operations csrc/chroma.cu's own steps do: as chroma_ops, but a
    thread sorts RUN + 2R rows for its RUN cells, and each of the two sites
    decodes its EV->raw value from the packed octave."""
    r = 2 if method == 5 else 1
    per_median = (CHROMA_MEDIAN5_OPS if method == 2 else
                  CHROMA_ROW_SORT_OPS[method] * (CHROMA_RUN + 2 * r) / CHROMA_RUN
                  + CHROMA_SELECT_OPS[method])
    return n_cells * (CHROMA_CELL_OPS + 2 * per_median + 2 * CHROMA_EV2RAW_OPS)


def chroma_bytes(imgs) -> int:
    """Bytes the smoothing moves: the frames in and out, the raw->EV table
    (int32, every u16 value) and the packed EV->raw octave (u16[8192])."""
    return 2 * imgs.numel() * 2 + (1 << 16) * 4 + 8192 * 2


def chroma_times(imgs, method, black, reps=20):
    """The chroma call on these frames: (CUDA-event ms of two runs, the
    device time by torch.profiler and both its readings)."""
    from mlvfs_tpu_torch.ops import chroma_smooth as cs

    def kernel():
        return cs.chroma_smooth_batch(imgs, method, black)

    runs = (_median_ms(kernel, reps), _median_ms(kernel, reps))
    return runs, *_profiled_seen_ms(kernel, ("chroma",), "the chroma kernel")


def chroma_vs_plain(card: str):
    """Phase 2b. Returns {method: (max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by)} at 1080p/B=16, black 2047."""
    import torch

    from mlvfs_tpu_torch.ops import chroma_smooth as cs

    gen = torch.Generator(device="cuda").manual_seed(2025)
    max_err = 0
    # (B, H, W, black, lowest value, past the highest): 14-bit frames; frames
    # over the whole u16 range at black * 4 (the dual-ISO preview's); one at
    # or above 16,384 everywhere (past the table's staged part); the widest
    # and shortest windowed shapes (one cell row or column of window at
    # 5x5); the windowless 8x8, 8x16 and 16x8
    cases = [(b, h, w, black, black - 40, 16000) for black in (2047, 2048)
             for b, h, w in [(16, 1080, 1920), (4, 727, 1808), (1, 8, 8), (1, 8, 16), (1, 16, 8)]]
    cases += [(4, 1080, 1920, 8188, 0, 65536), (2, 727, 1808, 8192, 0, 65536),
              (2, 1080, 1920, 2047, 16384, 65536), (1, 10, 5760, 2048, 2008, 16000),
              (2, 1080, 10, 2047, 2007, 16000), (3, 10, 10, 2047, 2007, 16000)]
    for method in cs.METHODS:
        for b, h, w, black, lo, hi in cases:
            imgs = torch.randint(lo, hi, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
            if lo < 16384:
                imgs[:, 10:20, 5:35] = black
            imgs = imgs.to(torch.int16)
            got = cs.chroma_smooth_batch(imgs, method, black)
            want = cs.chroma_smooth_batch_plain(imgs, method, black)
            torch.cuda.synchronize()
            err = int(((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want), f"chroma kernel == plain at method={method} "
                  f"black={black} values {lo}..{hi - 1} {h}x{w} B={b} (max err {err})")
    print(f"chroma kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    out = {}
    b, h, w, black = 16, 1080, 1920, 2047
    imgs = torch.randint(black - 40, 16000, (b, h, w), dtype=torch.int32, device="cuda",
                         generator=gen).to(torch.int16)
    moved = chroma_bytes(imgs)
    ny, nx = cs.cell_window(h, w)
    for method in cs.METHODS:
        plain_a = _median_ms(lambda: cs.chroma_smooth_batch_plain(imgs, method, black), reps=7)
        (kernel_a, kernel_b), device_ms, device_runs = chroma_times(imgs, method, black)
        plain_b = _median_ms(lambda: cs.chroma_smooth_batch_plain(imgs, method, black), reps=7)
        kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        bound_ms, bound_by = bound(moved, chroma_ops(method, b * ny * nx))
        design = chroma_design_ops(method, b * ny * nx)
        print(f"chroma cs{method}x{method} {w}x{h} B={b}: kernel {kernel_ms:.4f} ms by CUDA events "
              f"around the call (runs {kernel_a:.4f}/{kernel_b:.4f}), of which {device_ms:.4f} ms "
              f"device time (torch.profiler; runs {device_runs}; {moved / device_ms / 1e6:.1f} GB/s), "
              f"plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms "
              f"({bound_by}: {chroma_ops(method, 1)} int32 operations a cell; bytes alone "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms), the design's own steps "
              f"{design / (b * ny * nx):.1f} a cell ({design / INT32_OPS_PER_S * 1e3:.4f} ms); "
              f"the call at {100 * bound_ms / kernel_ms:.1f} % of the bound, the device time at "
              f"{100 * bound_ms / device_ms:.1f} % [{card}]")
        out[method] = (max_err, kernel_ms, plain_ms, bound_ms, bound_by)
    return out


def kernel_times(card: str):
    """``--kernel-times``: the unpack and chroma calls at 1080p/B=16 (phase
    2's and 2b's timing inputs, and the flags-on frames for cs3x3), each by
    CUDA events around the call and by its device time, and the AMaZE
    demosaic in mega mode (#9) and split mode (#8 + #10) on phase 2h's
    1080p/B=16 mosaics by CUDA events, for the package found first on
    sys.path (``--package-root DIR`` times another checkout of the port,
    such as a parent commit, with this script's code)."""
    import numpy as np
    import torch

    from mlvfs_tpu_torch.ops import chroma_smooth as cs
    from mlvfs_tpu_torch.ops import unpack

    gen = torch.Generator(device="cuda").manual_seed(2026)
    b, h, w = 16, 1080, 1920
    ny, nx = cs.cell_window(h, w)
    for bpp in UNPACK_BPPS:
        words = torch.randint(-32768, 32768, (b, unpack.words_for_pixels(h * w, bpp)),
                              dtype=torch.int16, device="cuda", generator=gen)
        runs, device_ms, device_runs = unpack_times(words, bpp, h, w)
        moved = words.numel() * 2 + b * h * w * 2
        print(f"kernel times: unpack bpp={bpp}: call {min(runs):.4f} ms (runs "
              f"{runs[0]:.4f}/{runs[1]:.4f}), device {device_ms:.4f} ms (runs {device_runs}); bytes "
              f"bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, the device time at "
              f"{100 * moved / HBM_BYTES_PER_S * 1e3 / device_ms:.1f} % of it [{card}]")
    black = 2047
    frames = {"random": torch.randint(black - 40, 16000, (b, h, w), dtype=torch.int32, device="cuda",
                                      generator=gen).to(torch.int16),
              "flags-on": torch.from_numpy(flagged_frames(b, w, h)[0].view(np.int16)).cuda()}
    for label, imgs in frames.items():
        for method in (2, 3, 5) if label == "random" else (3,):
            runs, device_ms, device_runs = chroma_times(imgs, method, black)
            bound_ms, bound_by = bound(chroma_bytes(imgs), chroma_ops(method, b * ny * nx))
            print(f"kernel times: chroma cs{method}x{method} on {label} frames: call {min(runs):.4f} ms "
                  f"(runs {runs[0]:.4f}/{runs[1]:.4f}), device {device_ms:.4f} ms (runs {device_runs}); "
                  f"bound {bound_ms:.4f} ms ({bound_by}), the device time at "
                  f"{100 * bound_ms / device_ms:.1f} % of it [{card}]")
    amaze_times(card)


def amaze_times(card: str):
    """The AMaZE demosaic at 1080p/B=16 on phase 2h's mosaics: mega mode
    (#9) and split mode (#8 + #10) by CUDA events, in turns, and #9's steps
    where the package stamps them."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core

    raw = amaze_mosaics(torch.Generator(device="cuda").manual_seed(2031), 16, 1080, 1920)

    def run(mode):
        with amaze_mode(mode):
            return amaze_core.amaze_demosaic(raw)

    mega_a, split_a = _median_ms(lambda: run("mega"), reps=5), _median_ms(lambda: run("split"), reps=5)
    split_b, mega_b = _median_ms(lambda: run("split"), reps=5), _median_ms(lambda: run("mega"), reps=5)
    print(f"kernel times: AMaZE 1920x1080 B=16, mega mode #9 {min(mega_a, mega_b):.4f} ms (runs "
          f"{mega_a:.4f}/{mega_b:.4f}), split mode #8 + #10 {min(split_a, split_b):.4f} ms (runs "
          f"{split_a:.4f}/{split_b:.4f}) [{card}]")
    # split mode's kernels by the yardstick of phases 2g and 2h, so that
    # --package-root times a parent's by the same one
    k = split_kernel_ms(raw)
    groups = sum(k[name] for name in STAGE_KERNELS)
    print(f"kernel times: split mode's kernels by CUDA events over launches on a filled workspace: #8's "
          f"groups {groups:.4f} ms (" + ", ".join(f"{name} {k[name]:.4f}" for name in STAGE_KERNELS)
          + f"), #10's passes {k['refine_kernel'] + k['dilate_kernel'] + k['chroma_kernel']:.4f} ms (refine "
          f"{k['refine_kernel']:.4f}, dilate {k['dilate_kernel']:.4f}, chroma {k['chroma_kernel']:.4f}) [{card}]")
    if hasattr(amaze_core, "amaze_demosaic_mega_steps"):
        steps = mega_steps_ms(raw)
        print("kernel times: #9's steps (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
              + f" [{card}]")


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


def pn_frames(gen, b, h, w, kind="mixed", white=15000):
    """(B, H, W) int32 test frames for the blur. ``mixed``: a flat noisy half
    (wide windows), full-range int16 pixels elsewhere (negative, i.e. u16
    values at and above 32768), a band above white; ``flat``: noise of +-40
    everywhere (every window 50 entries, every run of windows sliding by
    one); ``jump``: green averages 4000 apart from cell to cell (every window
    one entry); ``edges``: steps of 3000 every 5 to 40 cells along a row
    (window edges inside every run of pixels)."""
    import torch

    def noise(lo, hi, shape):
        return torch.randint(lo, hi, shape, device="cuda", generator=gen, dtype=torch.int32)

    if kind == "flat":
        return 3000 + noise(-40, 40, (b, h, w))
    if kind == "jump":
        cells = (torch.arange(w, device="cuda") // 2 % 2 * 4000).to(torch.int32)
        return cells + noise(-40, 40, (b, h, w))
    if kind == "edges":
        steps = torch.cumsum(noise(10, 80, (w,)), 0)
        level = (torch.searchsorted(steps, torch.arange(w, device="cuda", dtype=steps.dtype), right=True) % 2
                 * 3000).to(torch.int32)
        return 2000 + level + noise(-300, 300, (b, h, w))
    x = noise(-32768, 32768, (b, h, w))
    x[:, :, : w // 2] = 3000 + noise(-40, 40, (b, h, w // 2))
    x[:, h // 3 : h // 3 + 4, w // 4 : w // 2] = white + 100
    return x


def blur_design_ops(x) -> float:
    """Integer operations a pixel that kernel #3's steps do on these (B, H,
    W) int32 frames, counted by the kernel itself (mlvfs_pn_blur_ops: its
    own launch, not one of the main path's)."""
    import torch

    from mlvfs_tpu_torch import _build

    ops = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.empty_like(x)
    rc = _build.library("patternnoise").mlvfs_pn_blur_ops(
        x.data_ptr(), out.data_ptr(), ops.data_ptr(), *x.shape, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"counting blur launch (cudaError {rc})")
    torch.cuda.synchronize()
    return int(ops) / x.numel()


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
    for kind, b, h, w in [("mixed", 2, 1080, 1920), ("mixed", 1, 1078, 1920), ("mixed", 2, 64, 124),
                          ("mixed", 2, 64, 128), ("mixed", 1, 96, 1808), ("mixed", 2, 8, 2),
                          ("flat", 2, 1080, 1920), ("jump", 1, 1080, 1920), ("edges", 2, 270, 1920),
                          ("flat", 1, 64, 124), ("edges", 1, 64, 128)]:
        x = pn_frames(gen, b, h, w, kind)
        got = pf.blur_interleaved(x)
        want = pf.blur_interleaved_plain(x)
        planes = [x[:, py::2, px::2].contiguous() for py, px in sites]
        got4 = pn.edge_aware_blur(*planes)
        want4 = pn.edge_aware_blur_plain(*planes)
        torch.cuda.synchronize()
        err = max(int((g - t).abs().max()) for g, t in zip((got, *got4), (want, *want4)))
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"blur kernel #3 == plain on {kind} {h}x{w} B={b} (max err {err})")
        check(all(torch.equal(g, t) for g, t in zip(got4, want4)),
              f"blur kernel #4 == plain on {kind} {h}x{w} B={b} (max err {err})")
    split_launches = pn.KERNEL_LAUNCHES
    print(f"pattern-noise blur kernels #3, #4 vs plain: bit-equal in all cases, max_abs_err {max_err}")

    b, h, w = 16, 1080, 1920
    x = torch.from_numpy(pattern_noise_frames(b, w, h).astype(np.int32)).cuda()
    planes = [x[:, py::2, px::2].contiguous() for py, px in sites]
    n_ops = blur_ops(x)
    design_ops = blur_design_ops(x)
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
              f"{100 * bound_ms / kernel_ms:.1f} % of it; the design's own steps "
              f"{design_ops:.1f} operations a pixel [{card}]")
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
    # heights below one 32-row chunk (5, 6, 7) and not a multiple of it (70,
    # 1080); widths not a multiple of the 128-column block, rows copied 16,
    # 8 or 4 bytes at a time (1872, 300, 306) and an odd width (97: plain
    # copies)
    for b, h, w in [(16, 1080, 1920), (4, 5, 1920), (4, 6, 640), (4, 7, 300), (2, 70, 306),
                    (2, 100, 97), (4, 33, 1872)]:
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

    def kernel():
        return di.apply_preview(*args, black, white)

    plain_a = _median_ms(lambda: di.apply_preview_plain(*args, black, white), reps=3, warmup=1)
    kernel_a, kernel_b = _median_ms(kernel), _median_ms(kernel)
    device_ms, device_runs = _profiled_seen_ms(kernel, ("preview_kernel",), "the preview kernel")
    plain_b = _median_ms(lambda: di.apply_preview_plain(*args, black, white), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    moved = 2 * b * h * w * 2
    # float32 operations a pixel on its longest branch: scale (4) twice,
    # the mean (3), the selects and the clip (6)
    bound_ms, bound_by = bound(moved, 17 * b * h * w, FP32_OPS_PER_S)
    print(f"preview {w}x{h} B={b}: kernel {kernel_ms:.4f} ms by CUDA events around the call (runs "
          f"{kernel_a:.4f}/{kernel_b:.4f}; {moved / kernel_ms / 1e6:.1f} GB/s), of which {device_ms:.4f} ms "
          f"device time (torch.profiler; runs {device_runs}; the rest the wrapper's host work), plain "
          f"{plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}), "
          f"the call at {100 * bound_ms / kernel_ms:.1f} % of it, the device time at "
          f"{100 * bound_ms / device_ms:.1f} % [{card}]")
    return max_err, kernel_ms, plain_ms, bound_ms, bound_by


# the fit walk's chain a step: cdf_at[rank] (hi[rank] loads beside it), then
# lo[acc - 1], whose value the next step's rank waits for
FIT_LOADS_A_STEP = 2
# float32 operations of an accepted step, counted from
# csrc/dualiso_preview_fit.cu: two two_prods (17 each), two ds_muls (24, a
# fused multiply-add as 2) and five ds_adds (20)
FIT_FLOPS_A_STEP = 2 * 17 + 2 * 24 + 5 * 20


@contextlib.contextmanager
def preview_dev_mode(mode):
    """``MLVFS_TPU_PREVIEW_DEV`` set to ``mode`` (None: unset) inside."""
    old = os.environ.pop("MLVFS_TPU_PREVIEW_DEV", None)
    if mode is not None:
        os.environ["MLVFS_TPU_PREVIEW_DEV"] = mode
    try:
        yield
    finally:
        os.environ.pop("MLVFS_TPU_PREVIEW_DEV", None)
        if old is not None:
            os.environ["MLVFS_TPU_PREVIEW_DEV"] = old


def l2_latency_ns(hops=200_000):
    """The latency of one dependent load from L2 on this card: the
    pointer chase of ``csrc/l2_chase_probe.cu`` (one thread) over a random
    ring of 2^21 int32 (8 MiB: past L1, inside the 50 MB L2), by CUDA
    events, the time of a 1000-hop chase (the launch) taken off."""
    import torch

    from mlvfs_tpu_torch import _build

    n = 1 << 21
    gen = torch.Generator(device="cuda").manual_seed(7)
    order = torch.randperm(n, device="cuda", generator=gen)
    ring = torch.empty(n, dtype=torch.int32, device="cuda")
    ring[order] = torch.roll(order, -1).to(torch.int32)  # one cycle through every entry
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    fn = _build.entry("l2_chase_probe", "mlvfs_l2_chase")

    def chase(k):
        rc = fn(ring.data_ptr(), k, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"pointer chase launch (cudaError {rc})")

    chase(n)  # the ring into L2
    long_ms = _median_ms(lambda: chase(hops + 1000), reps=5, warmup=1)
    short_ms = _median_ms(lambda: chase(1000), reps=5, warmup=1)
    return (long_ms - short_ms) / hops * 1e6


def preview_frames(w, h, kinds, seed):
    """(frames (B, H, W) int16 on the card, black, white) by kind: an int is
    a dual-ISO frame with that dark-row phase, "plain" a single-ISO frame,
    "flat" a frame at black + 7, a tuple m a frame whose rows of phase
    y % 4 sit at black + m[y % 4] with uniform noise of +-6."""
    import dataclasses

    import numpy as np
    import torch

    from mlvfs_tpu_torch.format import synth

    spec = synth.SynthSpec(width=w, height=h, frames=len(kinds), dual_iso=3, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for k in kinds:
        if k == "flat":
            out.append(np.full((h, w), spec.black + 7, np.uint16))
        elif isinstance(k, tuple):
            base = spec.black + np.asarray(k)[np.arange(h) % 4][:, None]
            out.append((base + rng.integers(-6, 7, (h, w))).astype(np.uint16))
        else:
            out.append(synth.make_frame_data(dataclasses.replace(
                spec, dual_iso=0 if k == "plain" else 3, dual_iso_phase=0 if k == "plain" else k), rng))
    return torch.from_numpy(np.stack(out).view(np.int16)).cuda(), spec.black, spec.white


def preview_fit_vs_plain(card: str):
    """Phase 2j. Returns ((max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by) of the fit kernel at 1080p/B=16, its chain bound in ms)."""
    import torch

    from mlvfs_tpu_torch.ops import dualiso_preview_dev as pdev

    max_err = 0.0
    kept = None
    for label, w, h, kinds, seed in [("1080p", 1920, 1080, [0, 1, 2, 3] * 4, 1),
                                     ("640x192 mixed", 640, 192, [0, "flat", "plain"], 5),
                                     ("EOS M", 1872, 1060, [0, "plain", 1, 3], 3),
                                     ("1030 wide", 1030, 500, [1, 2], 7),
                                     # greens below black: c1 (c2) and c3 hold, c0 not
                                     ("1080p below black", 1920, 1080,
                                      [(-15, -10, -20, -15), (-12, -5, -10, -20)] * 2, 9)]:
        imgs, black, white = preview_frames(w, h, kinds, seed)
        padded, real, stored = pdev.sorted_phases(imgs, white)
        args = (padded, real, pdev.median_ranks(real, stored), black, white, stored[0])
        got = pdev.fit_sorted(*args)
        want = pdev.fit_sorted_plain(*args)
        torch.cuda.synchronize()
        for name, g, r in zip(("ok", "a", "b", "shadow", "dark_row_start"), got, want):
            if g.dtype == torch.float32:
                max_err = max(max_err, float((g - r).abs().max()))
                g, r = g.view(torch.int32), r.view(torch.int32)
            check(g.dtype == r.dtype and torch.equal(g, r), f"preview fit kernel == plain: {name} at {label}")
        if kept is None:
            kept = imgs, args
    print(f"preview fit kernel vs plain: bit-equal in all cases (ok, a, b, shadow, dark-row start), "
          f"max_abs_err {max_err}")
    imgs, args = kept
    b = imgs.shape[0]
    black, white = args[3], args[4]
    kernel_a = _median_ms(lambda: pdev.fit_sorted(*args))
    plain_a = _median_ms(lambda: pdev.fit_sorted_plain(*args), reps=3, warmup=1)
    whole_ms = _median_ms(lambda: pdev.preview_fit_device(imgs, black, white))
    kernel_b = _median_ms(lambda: pdev.fit_sorted(*args))
    plain_b = _median_ms(lambda: pdev.fit_sorted_plain(*args), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    points = pdev.fit_sorted_plain(*args, points=True)[-1]
    steps = int(points.max()) + 1  # the slowest frame's walk: its points and the rejecting step
    latency_ns = l2_latency_ns()
    chain_ms = steps * FIT_LOADS_A_STEP * latency_ns * 1e-6
    moved = args[0].numel() * 4 + b * (1 + 4 + 4 + 4 + 4)
    bound_ms, bound_by = bound(moved, int((points + 1).sum()) * FIT_FLOPS_A_STEP, FP32_OPS_PER_S)
    print(f"preview fit 1920x1080 B={b} ({tuple(args[0].shape)} sorted samples): kernel {kernel_ms:.4f} ms "
          f"by CUDA events (runs {kernel_a:.4f}/{kernel_b:.4f}), the whole device fit (sorts + kernel) "
          f"{whole_ms:.4f} ms, plain twin on the card {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); "
          f"bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.2f} MB), the walk's chain bound "
          f"{chain_ms:.4f} ms ({steps} steps of the slowest frame x {FIT_LOADS_A_STEP} dependent loads x "
          f"{latency_ns:.1f} ns L2 latency by the pointer chase); kernel at {100 * chain_ms / kernel_ms:.1f} % "
          f"of the chain bound [{card}]")
    return (max_err, kernel_ms, plain_ms, bound_ms, bound_by), chain_ms


EV_SHAPE = (16, 1080, 1920)  # a 1080p batch of 16


def same_values(a, b) -> bool:
    """Equal dtype and bits, float NaNs compared as NaN (payloads aside)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def ev_calls():
    """The EV entries' calls at 1080p/B=16 on the card: [(label, entry name,
    args, bytes each call must move)]: every 20-bit value's range for the
    raw transforms, EVs of the tables' range, positive floats for the logs,
    [-20, 20] for the exps, a per-frame (B, 1, 1) vector, full planes."""
    import torch

    from mlvfs_tpu_torch.ops import dualiso_recon

    gen = torch.Generator(device="cuda").manual_seed(15)

    def floats(scale, shift=0.0, shape=EV_SHAPE):
        return torch.rand(shape, generator=gen, device="cuda") * scale + shift

    def ints(lo, hi):
        return torch.randint(lo, hi, EV_SHAPE, generator=gen, device="cuda", dtype=torch.int32)

    n = math.prod(EV_SHAPE)
    black20, white20 = 2048 * 64, 15000 * 64
    raw, ev = ints(0, 1 << 20), ints(-10 * 32768, 14 * 32768)
    pos, mid, frame = floats(65536.0), floats(40.0, -20.0), floats(1.0, shape=(EV_SHAPE[0], 1, 1))
    planes = [floats(2.0, -1.0) for _ in range(3)]
    return [
        ("raw2ev20", "raw2ev20", (raw, black20), 8 * n),
        ("ev2raw20", "ev2raw20", (ev, black20, white20, dualiso_recon.white_ev_of(black20, white20)), 8 * n),
        ("fullres_weight", "fullres_weight", (raw, black20), 8 * n),
        ("log_f32", "log_f32", (pos,), 8 * n),
        ("log2_f32", "log2_f32", (pos,), 8 * n),
        ("log2_add, per-frame c", "log2_add", (pos, frame), 8 * n),
        ("exp2_f32", "exp2_f32", (mid,), 8 * n),
        ("fma, three full planes", "fma", tuple(planes), 16 * n),
        ("fma, per-frame x and y", "fma", (frame, frame, planes[0]), 8 * n),
    ]


def ev_vs_plain(card: str):
    """Phase 2k: each EV entry (csrc/evmath.cu, no Pallas original) on its
    own at 1080p/B=16: bit-equal to its twin on the card (NaNs as NaN), one
    launch a call; the call's time by CUDA events beside its byte bound and
    the twin's time. Returns (max_abs_err over the calls, and ms, plain_ms,
    bound_ms summed over them, "bytes")."""
    import torch

    from mlvfs_tpu_torch.ops import evmath

    max_err = 0.0
    totals = [0.0, 0.0, 0.0]
    for label, name, args, moved in ev_calls():
        fn, plain = getattr(evmath, name), getattr(evmath, name + "_plain")
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        before = evmath.KERNEL_LAUNCHES
        got = fn(*args)
        check(evmath.KERNEL_LAUNCHES == before + 1, f"EV {label}: one launch a call")
        want = plain(*args)
        diff = (got.double() - want.double()).abs()
        diff = diff[~torch.isnan(diff)]  # NaN against NaN, or an infinity against itself
        err = float(diff.max()) if diff.numel() else 0.0
        max_err = max(max_err, err)
        check(same_values(got, want), f"EV {label}: kernel == plain twin on the card, bit for bit "
              f"(max err {err})")
        ms = _median_ms(lambda: fn(*args))
        plain_ms = _median_ms(lambda: plain(*args), reps=3, warmup=1)
        print(f"EV {label} {'x'.join(map(str, EV_SHAPE))}: kernel {ms:.4f} ms by CUDA events, bound "
              f"{bound_ms:.4f} ms (bytes: {moved / 1e6:.1f} MB), {100 * bound_ms / ms:.1f} % of it; the "
              f"twin on the card {plain_ms:.4f} ms; bit-equal, max_abs_err {err} [{card}]")
        for k, v in enumerate((ms, plain_ms, bound_ms)):
            totals[k] += v
    return (max_err, *totals, "bytes")


def recon_inputs(shape=EV_SHAPE, seed=20):
    """The fused stages' inputs on the card: 20-bit bright and dark planes
    over every range (below black, past the darkened white and white), the
    row masks, per-frame scalars in the analysis' ranges, and int16 frames
    one row taller, whose row slice match takes."""
    import torch

    from mlvfs_tpu_torch.ops import evmath

    b, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device="cuda", dtype=torch.int32)

    def floats(lo, hi, size):
        return torch.rand(size, generator=gen, device="cuda") * (hi - lo) + lo

    black20, white20 = 2048 * 64, 15000 * 64
    dark = ints(0, 1 << 20, shape)
    bright = torch.where(ints(0, 8, shape) == 0, ints(0, 1 << 20, shape),
                         torch.clamp(dark * 8 - 7 * black20, 0, (1 << 20) - 1))
    a, b20 = floats(0.1, 0.9, (b,)), floats(-2000.0, 2000.0, (b,))
    wd = evmath.fma((white20 - black20) + b20, a, float(black20)).to(torch.int32)
    frames = ints(-(1 << 15), 1 << 15, (b, h + 1, w)).to(torch.int16)
    return dict(bright=bright, dark=dark, rb=ints(0, 2, (b, h)).bool(), a=a, b20=b20, wd=wd,
                ce=floats(0.5, 4.0, (b,)), ov=floats(0.5, 6.0, (b,)), sub=frames[:, 1:])


def _same_outputs(got, want) -> bool:
    if isinstance(got, tuple):
        return len(got) == len(want) and all(_same_outputs(g, x) for g, x in zip(got, want))
    if got is None or want is None:
        return got is None and want is None
    return same_values(got, want)


def recon_vs_plain(card: str):
    """Phase 2l: each fused stage (csrc/dualiso_recon.cu, no Pallas
    original) at 1080p/B=16: bit-equal to its twin on the card, one launch
    a call; the call's time by CUDA events beside its byte bound and the
    twin's. Returns (0.0, and ms, plain_ms, bound_ms summed over the main
    path's three stages, "bytes")."""
    import torch

    from mlvfs_tpu_torch.ops import alias, dualiso_recon

    x = recon_inputs()
    n = math.prod(EV_SHAPE)
    levels = dict(black20=2048 * 64, white20=15000 * 64)
    maps = dualiso_recon.computed_maps(**levels)
    fullres, halfres, *_ = dualiso_recon.blend(x["bright"], x["dark"], x["rb"], x["wd"], x["ce"], x["ov"],
                                               use_fullres=True, planes=False, use_alias=True, **levels)
    _, _, over, (f, hs_ev, fs_ev, _, pre, skip) = dualiso_recon.blend(
        x["bright"], x["dark"], x["rb"], x["wd"], x["ce"], x["ov"], use_fullres=True, planes=True,
        use_alias=True, **levels)
    filtered = alias.alias_filter(pre, skip)
    smooth_f, smooth_h = fullres ^ 5, torch.clamp(halfres + 77, max=(1 << 20) - 1)
    calls = [  # (label, call given the maps (None: the kernel), bytes it must move, on the main path)
        ("match", lambda m: dualiso_recon.match(x["sub"], x["rb"], x["a"], x["b20"], black20=levels["black20"],
                                                maps=m), 6 * n, True),
        ("blend with the alias planes", lambda m: dualiso_recon.blend(
            x["bright"], x["dark"], x["rb"], x["wd"], x["ce"], x["ov"], use_fullres=True, planes=True,
            use_alias=True, maps=m, **levels), 26 * n, True),
        ("blend (--cs*)", lambda m: dualiso_recon.blend(
            x["bright"], x["dark"], x["rb"], x["wd"], x["ce"], x["ov"], use_fullres=True, planes=False,
            use_alias=True, maps=m, **levels), 17 * n, False),
        ("alias planes (--cs*)", lambda m: dualiso_recon.alias_planes(
            x["bright"], smooth_f, smooth_h, fullres, use_alias=True, maps=m, **levels), 37 * n, False),
        ("final", lambda m: dualiso_recon.final(hs_ev, fs_ev, fs_ev, f, filtered, over, x["dark"], x["bright"],
                                                maps=m, **levels), 27 * n, True),
    ]
    totals = [0.0, 0.0, 0.0]
    for label, fn, moved, main in calls:
        before = dualiso_recon.KERNEL_LAUNCHES
        got = fn(None)
        check(dualiso_recon.KERNEL_LAUNCHES == before + 1, f"recon {label}: one launch a call")
        want = fn(maps)
        torch.cuda.synchronize()
        check(_same_outputs(got, want), f"recon {label}: kernel == plain twin on the card, bit for bit")
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        ms = _median_ms(lambda: fn(None))
        plain_ms = _median_ms(lambda: fn(maps), reps=5, warmup=1)
        print(f"recon {label} {'x'.join(map(str, EV_SHAPE))}: kernel {ms:.4f} ms by CUDA events, bound "
              f"{bound_ms:.4f} ms (bytes: {moved / n:.0f} B a pixel), {100 * bound_ms / ms:.1f} % of it; the "
              f"twin on the card {plain_ms:.4f} ms; bit-equal{' (main path)' if main else ''} [{card}]")
        if main:
            for k, v in enumerate((ms, plain_ms, bound_ms)):
                totals[k] += v
    return (0.0, *totals, "bytes")


def analysis_replay_vs_eager(card: str):
    """The dual-ISO analysis of a 1080p batch of 16 through a graph cache:
    eager, then captured, then replayed, each output bit-equal to the eager
    analysis of its own batch; host ms (the call, no wait) and device ms
    (CUDA events) of the eager and the replayed forms. Before that, the
    exposure fit's scoring kernel (csrc/dualiso_scores.cu, no Pallas
    original) against its twin on those frames' highlight pairs, timed.
    Returns the scoring kernel's row (0, ms, plain_ms, bound_ms,
    "operations")."""
    import functools

    import torch

    from mlvfs_tpu_torch.ops import dualiso_analysis_dev as dev

    b, h, w = EV_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    y = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    scene = 0.45 * xs / w + 0.35 * y / h + 0.2 * (0.5 + 0.5 * torch.sin(xs / 7.3) * torch.cos(y / 5.1))
    rows = (torch.arange(h, device="cuda") % 4 >= 2)[None, :, None]

    def frames():
        data = 2048 + scene * (15000 - 2048) / 8 + 8 * torch.randn((b, h, w), generator=gen, device="cuda")
        data = torch.where(rows, 2048 + (data - 2048) * 8, data)
        return torch.clamp(data, 0, 16383).to(torch.int32).to(torch.int16)

    fn = functools.partial(dev._analyze, y_off=0, hh=h, black=2048)
    is_hdr = torch.ones(b, dtype=torch.bool, device="cuda")
    a_cand = dev.candidate_gains(torch.device("cuda"))
    cache = dev.GraphCache("smoke.analysis", 2)

    def timed(call):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        out = call()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        return out, host_ms, start.elapsed_time(end)

    batches = [frames() for _ in range(4)]
    scores_row = fit_scores_vs_plain(batches[0], card)
    _, eager_host, eager_dev = timed(lambda: cache("smoke", fn, batches[0], is_hdr, a_cand))
    t0 = time.perf_counter()
    outs = [cache("smoke", fn, batches[1], is_hdr, a_cand)]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replays = []
    for f in batches[2:]:
        out, host_ms, dev_ms = timed(lambda: cache("smoke", fn, f, is_hdr, a_cand))
        outs.append(out)
        replays.append((host_ms, dev_ms))
    for f, got in zip(batches[1:], outs):
        want = fn(f, is_hdr, a_cand)
        check(bool(want[0].all()), "analysis: every frame of the batch converts")
        check(_same_outputs(tuple(got), tuple(want)), "analysis: the replay == the eager analysis, bit for bit")
    print(f"analysis {'x'.join(map(str, EV_SHAPE))}: eager host {eager_host:.2f} ms, device {eager_dev:.2f} ms; "
          f"capture (with its replay) {capture_s:.3f} s; replays host "
          f"{', '.join(f'{r[0]:.3f}' for r in replays)} ms, device {', '.join(f'{r[1]:.3f}' for r in replays)} ms; "
          f"bit-equal over 3 batches [{card}]")
    return scores_row


def fit_scores_vs_plain(frames, card: str):
    """The scoring kernel on the highlight pairs of these (B, H, W) frames:
    bit-equal to its twin, one launch; its time by CUDA events beside its
    operation bound (7 float32 operations an evaluation) and the twin's."""
    import torch

    from mlvfs_tpu_torch.ops import dualiso_analysis_dev as dev

    captured = {}
    real = dev.fit_scores

    def grab(*args):
        captured["args"] = args
        return real(*args)

    dev.fit_scores = grab
    try:
        b, h, w = frames.shape
        ibf = dev.fields_stat_batch(frames, 2048)[1]
        wd_w, wb_w = dev.white_detect_batch(frames, ibf, (0, 0, h, w), w * h // 2 // 9)
        dev.match_exposures_batch(frames, ibf, torch.full((b,), 2048 * 64, dtype=torch.int32, device="cuda"),
                                  torch.minimum(wd_w, wb_w) * 64, (h, w))
    finally:
        dev.fit_scores = real
    args = captured["args"]
    before = dev.KERNEL_LAUNCHES
    got = real(*args)
    check(dev.KERNEL_LAUNCHES == before + 1, "fit scores: one launch a call")
    want = dev.fit_scores_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "fit scores: kernel == plain twin on the card")
    (b, n), c = args[0].shape, args[3].shape[0]
    evaluations = b * c * n
    # the pairs (hb, hd, valid) and candidates (a, b) read once, the int64 scores written
    bound_ms, bound_by = bound(b * n * 9 + c * 4 + b * c * (4 + 8), 7 * evaluations, FP32_OPS_PER_S)
    ms = _median_ms(lambda: real(*args))
    plain_ms = _median_ms(lambda: dev.fit_scores_plain(*args), reps=5, warmup=1)
    print(f"fit scores {args[0].shape[0]} frames x {args[3].shape[0]} candidates x {args[0].shape[1]} pairs: "
          f"kernel {ms:.4f} ms by CUDA events, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f} % of it; the twin on the card {plain_ms:.4f} ms; bit-equal [{card}]")
    return (0, ms, plain_ms, bound_ms, bound_by)


def alias_ops(n_selected: int, n_pixels: int) -> int:
    """Integer operations the filter chain needs: for each pixel it selects
    (inner and not skipped) the 6th largest of 37 values, at least 50
    comparisons (n - k + ceil(log2 C(n, k-1)), n = 37, k = 6), and the blur,
    44 tap additions, 8 multiplies and 8 shifts; for every pixel the select
    and its share of the 2x2 cell max (2)."""
    return n_selected * (50 + 60) + 2 * n_pixels


# operations of csrc/alias.cu's own steps, counted from the source: the
# selection of a pair of aux pixels (sorting networks of its six common row
# runs, 110; five bitonic merges, 112; each pixel's own 7 taps sorted and its
# 6th largest taken, 2 x 42), the blur of a selected tile pixel (17 adds of
# its 20 distinct taps, 8 products, 8 shifts, 8 sums) and every pixel's cell
# max and cap
ALIAS_PAIR_OPS = 306
ALIAS_BLUR_OPS = 41
ALIAS_CELL_OPS = 4


def alias_work(skip):
    """(selected pixels, pairs selected for, tiles with work, tiles) of
    csrc/alias.cu's 64 x 64 tiles on these (B, H, W) skip maps: a tile works
    where one of its pixels selects, and lists the pairs (r, r + 2) of its
    76 x 76 aux area of which a pixel selects."""
    import torch

    from mlvfs_tpu_torch.ops import alias

    b, h, w = skip.shape
    sel = alias.inner_mask(h, w, skip.device) & ~skip
    nty, ntx = -(-h // 64), -(-w // 64)
    pad = torch.zeros((b, 64 * nty + 12, 64 * ntx + 12), dtype=torch.bool, device=skip.device)
    pad[:, 6 : 6 + h, 6 : 6 + w] = sel
    tiles = pad.unfold(1, 76, 64).unfold(2, 76, 64)  # (B, tiles down, tiles across, 76, 76)
    work = tiles[..., 6:70, 6:70].flatten(-2).any(-1)
    upper = [r for r in range(76) if r % 4 < 2]
    need = tiles[..., upper, :] | tiles[..., [r + 2 for r in upper], :]
    pairs = int((need.flatten(-2).sum(-1) * work).sum())
    return int(sel.sum()), pairs, int(work.sum()), work.numel()


def alias_row_of(a, skip, label, card):
    """Time kernel #7 (two runs) and its twin on these inputs; print them
    beside the bound and the design's own operation count. Returns
    (kernel_ms, plain_ms, bound_ms, bound_by)."""
    from mlvfs_tpu_torch.ops import alias

    b, h, w = a.shape
    plain_a = _median_ms(lambda: alias.alias_filter_plain(a, skip), reps=3, warmup=1)
    kernel_a = _median_ms(lambda: alias.alias_filter(a, skip))
    kernel_b = _median_ms(lambda: alias.alias_filter(a, skip))
    plain_b = _median_ms(lambda: alias.alias_filter_plain(a, skip), reps=3, warmup=1)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    moved = b * h * w * (4 + 1 + 4)
    n_sel, pairs, work, tiles = alias_work(skip)
    bound_ms, bound_by = bound(moved, alias_ops(n_sel, b * h * w))
    design = pairs * ALIAS_PAIR_OPS + n_sel * ALIAS_BLUR_OPS + b * h * w * ALIAS_CELL_OPS
    print(f"alias filter {w}x{h} B={b}, {label}: kernel {kernel_ms:.4f} ms "
          f"({moved / kernel_ms / 1e6:.1f} GB/s, runs {kernel_a:.4f}/{kernel_b:.4f}), plain "
          f"{plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}; "
          f"bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, {n_sel} pixels select, "
          f"{100 * n_sel / (b * h * w):.1f} %), kernel at {100 * bound_ms / kernel_ms:.1f} % of it; "
          f"the design's own steps: {work} of {tiles} tiles work, {pairs} pairs, "
          f"{design / max(n_sel, 1):.1f} operations a selected pixel (alias_ops counts 110) [{card}]")
    return kernel_ms, plain_ms, bound_ms, bound_by


def alias_vs_plain(card: str):
    """Phase 2e. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/B=16, skip density 0.2."""
    import torch

    from mlvfs_tpu_torch.ops import alias

    gen = torch.Generator(device="cuda").manual_seed(2028)
    max_err = 0

    def holds(a, skip, what):
        nonlocal max_err
        got = alias.alias_filter(a, skip)
        want = alias.alias_filter_plain(a, skip)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"alias kernel == plain at {what} (max err {err})")

    cases = [(16, 1080, 1920), (16, 1060, 1872)] + [(3, h, w) for h in (5, 12, 13, 64, 300)
                                                    for w in (37, 40)] + [(2, 129, 130)]
    for b, h, w in cases:
        for density in (0.0, 0.5, 0.9, 1.0):
            a = torch.randint(0, 65531, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
            skip = torch.rand((b, h, w), device="cuda", generator=gen) < density
            holds(a, skip, f"{h}x{w} B={b} skip {density}")
    # low-work layouts: one working pixel at a tile's corner, a block of work
    # with whole tiles without any, a flat map and runs of equal values
    a = torch.randint(0, 65531, (4, 1080, 1920), dtype=torch.int32, device="cuda", generator=gen)
    skip = torch.ones_like(a, dtype=torch.bool)
    skip[0, 64, 64] = skip[1, 127, 191] = skip[2, 6, 6] = False
    skip[3, 300:420, 500:900] = False
    holds(a, skip, "1080p, single working pixels at tile corners and a block of work")
    flat = torch.full_like(a, 777)
    holds(flat, torch.rand(a.shape, device="cuda", generator=gen) < 0.3, "a flat map")
    runs = (torch.arange(1920, device="cuda") // 3 % 4 * 5000).to(torch.int32).expand(4, 1080, 1920)
    holds(runs.contiguous(), torch.rand(a.shape, device="cuda", generator=gen) < 0.3, "runs of equal values")
    print(f"alias kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    b, h, w = 16, 1080, 1920
    a = torch.randint(0, 15001, (b, h, w), dtype=torch.int32, device="cuda", generator=gen)
    row = alias_row_of(a, torch.rand((b, h, w), device="cuda", generator=gen) < 0.2, "skip density 0.2",
                       card)
    alias_row_of(a, torch.rand((b, h, w), device="cuda", generator=gen) < 0.9,
                 "skip density 0.9 (low work, as the main path's)", card)
    return (max_err, *row)


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


# operations of csrc/amaze_edge.cu's own steps, counted from the source: a
# row that holds a scored pixel, in the rows form (12 tap differences of 8
# operations on 138 columns; per run of 4 columns and direction 17 adds of
# the running box; 3 for each later direction's pick of each column), and a
# scored pixel in the direct form (12 x 11 tap differences and their sums,
# 11 picks); per pixel, its three candidates and their mean (18)
EDGE_ROW_OPS = 12 * 138 * 8 + 32 * 12 * 17 + 128 * 11 * 3
EDGE_DIRECT_OPS = 12 * 11 * 8 + 12 * 11 + 11 * 3
EDGE_PIXEL_OPS = 18


def edge_work(restricted, direct_per_row):
    """(scored pixels, operations of the kernel's own steps, {form: tiles})
    of csrc/amaze_edge.cu's 8 x 128 tiles on these restricted maps."""
    import torch

    b, h, w = restricted.shape
    ys = torch.arange(h, device=restricted.device)[:, None]
    xs = torch.arange(w, device=restricted.device)[None, :]
    scored = (ys >= 5) & (ys < h - 5) & (xs >= 5) & (xs < w - 5) & ~restricted
    nty, ntx = -(-h // 8), -(-w // 128)
    pad = torch.zeros((b, 8 * nty, 128 * ntx), dtype=torch.bool, device=restricted.device)
    pad[:, :h, :w] = scored
    tiles = pad.view(b, nty, 8, ntx, 128)
    n = tiles.sum((2, 4))
    act = tiles.any(4).sum(2)
    direct = (n > 0) & (n <= min(direct_per_row, 128) * act)
    rows = n > min(direct_per_row, 128) * act
    ops = (int(n[direct].sum()) * EDGE_DIRECT_OPS + int(act[rows].sum()) * EDGE_ROW_OPS
           + b * h * w * EDGE_PIXEL_OPS)
    forms = {"none": int((n == 0).sum()), "direct": int(direct.sum()), "rows": int(rows.sum())}
    return int(n.sum()), ops, forms


def edge_row_of(args, label, card, forms=(("auto", None), ("rows", 0), ("direct", 128))):
    """Time kernel #6 in each form (two runs each) and its twin on these
    inputs; print them beside the bound and the design's own operation
    count. Returns (kernel_ms of the default form, plain_ms, bound_ms,
    bound_by)."""
    from mlvfs_tpu_torch.ops import amaze_edge

    b, h, w = args[0].shape
    plain_a = _median_ms(lambda: amaze_edge.edge_pick_plain(*args), reps=3, warmup=1)
    times = {}
    for name, dpr in forms:
        dpr = amaze_edge.DIRECT_PER_ROW if dpr is None else dpr
        runs = [_median_ms(lambda: amaze_edge._edge_pick_cuda(*args, direct_per_row=dpr)) for _ in range(2)]
        times[name] = (min(runs), runs, dpr)
    plain_b = _median_ms(lambda: amaze_edge.edge_pick_plain(*args), reps=3, warmup=1)
    plain_ms = min(plain_a, plain_b)
    moved = b * h * w * (3 * 4 + 1 + 4) + b * h * 4
    n_scored, _, _ = edge_work(args[4], 0)
    bound_ms, bound_by = bound(moved, edge_ops(n_scored, b * h * w))
    print(f"edge pick {w}x{h} B={b}, {label}: plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); "
          f"bound {bound_ms:.4f} ms ({bound_by}; bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{n_scored} pixels scored, {100 * n_scored / (b * h * w):.1f} %) [{card}]")
    for name, (ms, runs, dpr) in times.items():
        _, ops, tiles = edge_work(args[4], dpr)
        print(f"  kernel #6, {name} form (direct_per_row {dpr}): {ms:.4f} ms (runs {runs[0]:.4f}/{runs[1]:.4f}), "
              f"{moved / ms / 1e6:.1f} GB/s, at {100 * bound_ms / ms:.1f} % of the bound; tiles {tiles}; "
              f"the design's own steps: {ops / max(n_scored, 1):.1f} operations a scored pixel "
              f"(edge_ops counts {edge_ops(n_scored, b * h * w) / max(n_scored, 1):.1f}) [{card}]")
    return times[forms[0][0]][0], plain_ms, bound_ms, bound_by


def edge_vs_plain(card: str):
    """Phase 2f. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)
    at 1080p/B=16, restricted density 1/2."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_edge

    gen = torch.Generator(device="cuda").manual_seed(2029)
    max_err = 0

    def holds(args, what):
        nonlocal max_err
        want = amaze_edge.edge_pick_plain(*args)
        for dpr in (amaze_edge.DIRECT_PER_ROW, 0, 128):
            got = amaze_edge._edge_pick_cuda(*args, direct_per_row=dpr)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"edge kernel #6 == plain at {what}, direct_per_row {dpr} (max err {err})")

    cases = [(16, 1080, 1920), (16, 1060, 1872), (3, 300, 41), (3, 64, 40), (3, 11, 12), (2, 5, 7),
             (2, 61, 250), (1, 1077, 1930)]
    for b, h, w in cases:
        for density in (0.0, 0.5, 0.96, 1.0):
            holds(edge_inputs(gen, b, h, w, density), f"{h}x{w} B={b} restricted {density}")
    # low-work layouts: one scored pixel at a tile's corner, a block of scored
    # pixels with whole tiles and rows without any
    args = edge_inputs(gen, 3, 1080, 1920, 1.0)
    args[4][0, 8, 128] = args[4][1, 15, 1919] = False
    args[4][2, 300:340, 500:700] = False
    holds(args, "1080p, single scored pixels at tile corners and a block of work")
    print(f"edge kernel #6 vs plain: bit-equal in all cases and forms, max_abs_err {max_err}")
    b, h, w = 16, 1080, 1920
    row = edge_row_of(edge_inputs(gen, b, h, w, 0.5), "restricted density 0.5", card)
    edge_row_of(edge_inputs(gen, b, h, w, 0.96), "restricted density 0.96 (low work, as the main path's)",
                card)
    return (max_err, *row)


def amaze_mosaics(gen, b, h, w, straddle=False):
    """(B, H, W) float32 RGGB mosaics on the 20-bit scale the reconstruction
    hands AMaZE: a smooth scene with diagonal stripes (Nyquist areas), noise,
    and a clipped block; ``straddle`` adds a one-pixel checkerboard (Nyquist
    cells) over padded columns 24..39 and rows 24..39, across the edges of
    #8's 32 x 32 tiles."""
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
        if straddle:
            img[8:24, :] += 300000 * ((x + y) % 2)[8:24, :]
            img[:, 8:24] += 300000 * ((x + y) % 2)[:, 8:24]
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


def raster_pass_bounds(n_padded):
    """{kernel name: (bound_ms, bound_by)} of each raster pass's launches in
    one demosaic over (B, hp, wp) planes of n_padded pixels: each launch
    reads and writes its plane once, against refine's 5 and chroma's 20
    float32 operations a pixel and dilate's 8 int32 ones; refine and chroma
    launch twice."""
    def one(launches, fp32_ops, int32_ops):
        t_bytes = launches * 2 * n_padded * 4 / HBM_BYTES_PER_S
        t_ops = launches * n_padded * (fp32_ops / FP32_OPS_PER_S + int32_ops / INT32_OPS_PER_S)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    return {"refine_kernel": one(2, 5, 0), "dilate_kernel": one(1, 0, 8), "chroma_kernel": one(2, 20, 0)}


def _profiled_ms(fn, match, reps=3, attempts=12):
    """Median over ``reps`` calls of the device time of the kernels whose
    names contain one of ``match`` (torch.profiler), in ms per call. Once
    phase 2c has run, the profiler drops records at the start of a session
    on the H100 (the first kernel, at times more), and it misses whole
    sessions at times: each session starts with a kernel of its own, and
    only sessions that saw as many of the kernels as the most any session
    saw are readings. Sessions are repeated, up to ``attempts``, until
    ``reps`` readings are in; 0 if the profiler saw none of the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    sessions = []  # (records seen, ms)
    readings = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.add_(1)  # the session's first kernel, which the profiler may drop
            fn()
            torch.cuda.synchronize()
        seen = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and any(m in e.name for m in match)]
        if seen:
            sessions.append((len(seen), sum(seen) / 1e3))
        most = max((n for n, _ in sessions), default=0)
        readings = sorted(ms for n, ms in sessions if n == most)
        if len(readings) >= reps:
            break
    return readings[len(readings) // 2] if readings else 0.0


def _profiled_seen_ms(fn, match, what):
    """_profiled_ms taken twice: the smaller reading above 0 (a run the
    profiler missed reads 0), and both readings as text. Fails the run if
    the profiler saw no launch in either."""
    runs = (_profiled_ms(fn, match), _profiled_ms(fn, match))
    seen = [ms for ms in runs if ms > 0]
    check(bool(seen), f"the profiler saw {what}")
    return min(seen), "/".join(f"{ms:.4f}" for ms in runs)


STAGE_KERNELS = ("k_group1", "k_group2", "k_group3", "k_group4", "k_output")  # #8, one launch each
PASS_KERNELS = ("refine_kernel", "dilate_kernel", "chroma_kernel")


@contextlib.contextmanager
def amaze_mode(mode: str):
    """MLVFS_AMAZE_PALLAS_MODE set to ``mode`` inside the block."""
    from mlvfs_tpu_torch.ops import amaze_core

    old = os.environ.get(amaze_core.MODE_ENV)
    os.environ[amaze_core.MODE_ENV] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ[amaze_core.MODE_ENV]
        else:
            os.environ[amaze_core.MODE_ENV] = old


def split_kernel_ms(raw, n=10):
    """Split mode's kernels in one demosaic of these (B, H, W) mosaics:
    {#8's k_group1 .. k_output, #10's refine_kernel (its two launches),
    dilate_kernel, chroma_kernel (its two)}, each timed by CUDA events over
    n back-to-back launches on the workspace a split demosaic filled, the
    median of three runs. A launch reads only planes an earlier step wrote,
    so it rewrites the same values; no profiler session is involved."""
    import torch

    from mlvfs_tpu_torch import _build
    from mlvfs_tpu_torch.ops import amaze_core, amaze_scans

    captured = {}
    make = amaze_core._outputs_and_workspace

    def capture(r, planes):
        captured["outs"], captured["ws"] = make(r, planes)
        return captured["outs"], captured["ws"]

    amaze_core._outputs_and_workspace = capture
    try:
        with amaze_mode("split"):
            amaze_core.amaze_demosaic(raw)
    finally:
        amaze_core._outputs_and_workspace = make
    outs, ws = captured["outs"], captured["ws"]
    b, hp, wp = ws.shape[1:]
    plane = {name: ws[i] for i, name in enumerate(amaze_core.SPLIT_PLANES)}
    for name in amaze_core.INT_PLANES:
        plane[name] = plane[name].view(torch.int32)
    lib = _build.library("amaze")
    stream = torch.cuda.current_stream().cuda_stream

    def stage(k):
        def launch():
            check(lib.mlvfs_amaze_stage(k, ws.data_ptr(), *(o.data_ptr() for o in outs), b, hp, wp, stream) == 0,
                  f"#8's stage group {k} launched")
        return launch

    launches = {
        **{name: [stage(k)] for k, name in enumerate(STAGE_KERNELS, 1)},
        "refine_kernel": [lambda: amaze_scans.refine(plane["hvwt1"], out=plane["hvwt"]),
                          lambda: amaze_scans.refine(plane["pmwt0"], out=plane["pmwt"])],
        "dilate_kernel": [lambda: amaze_scans.dilate(plane["nyq0"], out=plane["nyq"])],
        "chroma_kernel": [lambda: amaze_scans.chroma(plane["d0"], 1, out=plane["d0s"]),
                          lambda: amaze_scans.chroma(plane["d1"], 0, out=plane["d1s"])],
    }
    out = {}
    for name, fns in launches.items():
        out[name] = sum(_median_ms(lambda: [fn() for _ in range(n)], reps=3, warmup=1) / n for fn in fns)
    return out


def nyquist_cells(raw) -> int:
    """The Nyquist cells (R/B sites of the dilated Nyquist map) of the
    demosaic of these (B, H, W) mosaics on the card, read from the split
    path's dilation."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core, amaze_scans

    captured = {}
    dilate = amaze_scans.dilate

    def capture(nyq0, out=None):
        captured["nyq"] = dilate(nyq0, out=out)
        return captured["nyq"]

    amaze_scans.dilate = capture
    try:
        with amaze_mode("split"):
            amaze_core.amaze_demosaic(raw)
    finally:
        amaze_scans.dilate = dilate
    hp, wp = captured["nyq"].shape[-2:]
    rbmask = ((torch.arange(hp, device="cuda")[:, None] + torch.arange(wp, device="cuda")[None, :]) % 2) == 0
    return int(((captured["nyq"] > 0) & rbmask).sum())


def demosaic_bound(b, h, w, n_nyq, with_passes):
    """(bound_ms, bound_by) of the AMaZE demosaic of a (b, h, w) batch with
    n_nyq Nyquist cells: one plane in and three out at the HBM rate, against
    the stencil stages' float32 operations and, ``with_passes``, the five
    raster passes' float32 and int32 operations."""
    n_padded = b * (h + 32) * (w + 32)
    t_bytes = b * h * w * 4 * 4 / HBM_BYTES_PER_S
    t_ops = (n_padded * AMAZE_OPS_PER_PADDED_PX + n_nyq * AMAZE_OPS_PER_NYQ_CELL) / FP32_OPS_PER_S
    if with_passes:
        t_ops += (n_padded * RASTER_FP32_OPS_PER_PX / FP32_OPS_PER_S
                  + n_padded * RASTER_INT32_OPS_PER_PX / INT32_OPS_PER_S)
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def amaze_vs_plain(card: str):
    """Phase 2g. Returns ({"amaze_demosaic": row, "amaze_raster_passes": row},
    launches of the raster passes in the phase), rows (max_abs_err,
    kernel_ms, plain_ms, bound_ms, bound_by) at 1080p/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core, amaze_scans

    gen = torch.Generator(device="cuda").manual_seed(2030)
    # besides the 1080p and EOS M planes: a ring deeper than the tile's rows
    # (hp 4 and 6), rows not 16-B aligned (wp 34, 38, 50: 8-B copies), two
    # tiles, a last tile that reads rows below it, the widest plane dilate's
    # ring takes (wp 2048) and the next (2050: dilate's row walk beside
    # refine's ring), the widest refine's ring takes (7264), and a plane too
    # wide for both rings (wp 7800: #9's row walks)
    pass_err = 0.0
    for b, hp, wp in [(16, 1112, 1952), (16, 1092, 1904), (2, 224, 192), (1, 40, 34), (1, 290, 50),
                      (1, 4, 34), (2, 6, 38), (1, 40, 2048), (1, 40, 2050), (1, 40, 7264), (1, 40, 7800)]:
        wt = torch.rand((b, hp, wp), device="cuda", generator=gen)
        nyq = (torch.rand((b, hp, wp), device="cuda", generator=gen) > 0.6).to(torch.int32)
        D = 0.1 * torch.randn((b, hp, wp), device="cuda", generator=gen)
        got = [amaze_scans.dilate(nyq), amaze_scans.refine(wt), amaze_scans.chroma(D, 0),
               amaze_scans.chroma(D, 1)]
        want = [amaze_core.dilate_plain(nyq), amaze_core.refine_plain(wt), amaze_core.chroma_plain(D, 0),
                amaze_core.chroma_plain(D, 1)]
        torch.cuda.synchronize()
        for name, g, v in zip(("dilate", "refine", "chroma 0", "chroma 1"), got, want):
            err = float((g.double() - v.double()).abs().max())
            pass_err = max(pass_err, err)
            check(torch.equal(g, v), f"raster pass #10 {name} == plain at {hp}x{wp} B={b} (max err {err})")
    print(f"raster pass kernels #10 vs plain: bit-equal in all cases, max_abs_err {pass_err}")

    # #8's 32 x 32 tiles: widths no multiple of a tile (1872 = 58.5 tiles),
    # frames narrower than a tile and its aprons (17x18, 33x46), a 300x50
    # strip, and Nyquist stripes straddling a tile edge
    demosaic_err = 0.0
    for b, h, w, straddle in [(16, 1080, 1920, False), (16, 1060, 1872, False), (1, 160, 224, False),
                              (2, 17, 18, False), (2, 33, 46, False), (1, 300, 50, False),
                              (1, 320, 352, False), (2, 160, 224, True)]:
        raw = amaze_mosaics(gen, b, h, w, straddle)
        got = amaze_core.amaze_demosaic(raw)
        want = amaze_core.amaze_demosaic_plain(raw)
        torch.cuda.synchronize()
        for name, g, v in zip("RGB", got, want):
            check(bool(torch.isfinite(g).all()) and g.shape == (b, h, w),
                  f"AMaZE #8 {name}: finite {b}x{h}x{w}")
            err = float((g.double() - v.double()).abs().max())
            demosaic_err = max(demosaic_err, err)
            check(torch.equal(g, v), f"AMaZE #8 {name} == plain at {h}x{w} B={b} (max err {err})")
        del got, want
    print(f"AMaZE kernel #8 (with #10) vs plain: bit-equal in all cases, max_abs_err {demosaic_err}")

    b, h, w = 16, 1080, 1920
    hp, wp = h + 2 * amaze_core.PAD, w + 2 * amaze_core.PAD
    raw = amaze_mosaics(gen, b, h, w)
    n_nyq = nyquist_cells(raw)

    def run():
        return amaze_core.amaze_demosaic(raw)

    # #8's plain twin alone: the twin's stencil stages with #10's kernels as
    # the raster passes between them
    pass_kernels = {"refine": amaze_scans.refine, "dilate": amaze_scans.dilate,
                    "chroma": amaze_scans.chroma}

    def plain_stages():
        return amaze_core._stencil_stages_plain(amaze_core.pad_mosaic(raw), pass_kernels)

    # each kernel by CUDA events over launches of its own: torch.profiler's
    # readings of these have come out at half a kernel's time or without a
    # launch at times on the H100
    kernel_ms = split_kernel_ms(raw)
    per_group = {name: kernel_ms[name] for name in STAGE_KERNELS}
    per_pass = {name: kernel_ms[name] for name in PASS_KERNELS}
    stage_ms, passes_ms = sum(per_group.values()), sum(per_pass.values())
    whole_a = _median_ms(run, reps=5)
    plain_a = _median_ms(plain_stages, reps=3, warmup=1)
    twin_a = _median_ms(lambda: amaze_core.amaze_demosaic_plain(raw), reps=3, warmup=1)
    whole_b = _median_ms(run, reps=5)
    plain_b = _median_ms(plain_stages, reps=3, warmup=1)
    twin_b = _median_ms(lambda: amaze_core.amaze_demosaic_plain(raw), reps=3, warmup=1)
    whole_ms, plain_ms, twin_ms = min(whole_a, whole_b), min(plain_a, plain_b), min(twin_a, twin_b)
    n_padded = b * hp * wp
    amaze_bound = demosaic_bound(b, h, w, n_nyq, with_passes=False)
    t_bytes = b * h * w * 4 * 4 / HBM_BYTES_PER_S
    print(f"AMaZE demosaic {w}x{h} B={b}: stencil stages #8 {stage_ms:.4f} ms, raster passes #10 "
          f"{passes_ms:.4f} ms (their kernels by CUDA events, launched on their own), the whole call "
          f"{whole_ms:.4f} ms (runs {whole_a:.4f}/{whole_b:.4f}); plain twin of the stages (with the "
          f"#10 kernels) {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}), the whole plain twin "
          f"{twin_ms:.4f} ms (runs {twin_a:.4f}/{twin_b:.4f}); #8 bound {amaze_bound[0]:.4f} ms ({amaze_bound[1]}; {n_nyq} "
          f"Nyquist cells; bytes alone {t_bytes * 1e3:.4f} ms), #8 at "
          f"{100 * amaze_bound[0] / stage_ms:.1f} % of it [{card}]")
    print("#8's stage groups inside that demosaic (CUDA events): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in per_group.items())
          + f" (one launch each), {stage_ms:.4f} ms in all [{card}]")
    plane_bytes = b * hp * wp * 4
    print(f"#8's workspace: {len(amaze_core.SPLIT_PLANES)} float32 planes of {b}x{hp}x{wp}, "
          f"{len(amaze_core.SPLIT_PLANES) * plane_bytes / 1e9:.4f} GB (#9's: {len(amaze_core.PLANES)} planes, "
          f"{len(amaze_core.PLANES) * plane_bytes / 1e9:.4f} GB)")
    pass_bounds = raster_pass_bounds(n_padded)
    print("raster passes #10 inside that demosaic (CUDA events): "
          + ", ".join(f"{name} {ms:.4f} ms (bound {pass_bounds[name][0]:.4f} ms, {pass_bounds[name][1]})"
                      for name, ms in per_pass.items())
          + f" (refine and chroma launch twice, dilate once; each bound for its launches) [{card}]")

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


MEGA_SHAPES = [  # (B, H, W) of phase 2h and their reasons
    (16, 1080, 1920),  # 1080p at B=16: 34,160 tiles of each group, 144 raster tiles
    (1, 160, 224),     # two raster tiles
    (3, 300, 50),      # three raster tiles, a strip narrower than two group tiles
    (2, 33, 46),       # odd heights, narrower than a tile and its aprons
    (1, 17, 18),       # the smallest frame
    (1, 160, 2100),    # 2,132 padded columns: past dilate's ring, its row walk
    (1, 96, 7300),     # 7,332 padded columns: past refine's ring too, both row walks
    (270, 40, 64),     # 2,430 group tiles, 270 raster tiles: above the grid and no multiple of it
]


def mega_resources():
    """{kernel: ptxas's registers, stack and spills} of #9 and #8's group
    kernels, from their builds (-Xptxas -v)."""
    from mlvfs_tpu_torch import _build

    out = {}
    for lib in ("amaze_mega", "amaze"):
        for mangled, usage in _build.resource_usage(lib).items():
            for name in ("amaze_mega_kernel", *STAGE_KERNELS):
                if name in mangled:
                    out[name] = usage
    return out


def mega_steps_ms(raw, reps=3):
    """The median over ``reps`` stamped runs of each of #9's steps, in ms."""
    from mlvfs_tpu_torch.ops import amaze_core

    amaze_core.amaze_demosaic_mega_steps(raw)
    runs = [amaze_core.amaze_demosaic_mega_steps(raw)[1] for _ in range(reps)]
    return {k: sorted(r[k] for r in runs)[reps // 2] for k in amaze_core.MEGA_STEPS}


def amaze_mega_vs_plain(card: str):
    """Phase 2h. Returns (max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by) of kernel #9 at 1080p/B=16."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core

    gen = torch.Generator(device="cuda").manual_seed(2031)
    b, h, w = MEGA_SHAPES[-1]
    plan = amaze_core.mega_plan(h, w)
    grid, hp = plan["blocks_per_sm"] * plan["sms"], h + 2 * amaze_core.PAD
    items = (b * -(-hp // 32) * -(-(w + 2 * amaze_core.PAD) // 32), b * amaze_core.n_tiles(hp))
    check(all(n > grid and n % grid for n in items),
          f"AMaZE #9 at {h}x{w} B={b}: group and pass items {items} above the grid's {grid} blocks, no multiple")
    max_err = 0.0
    for b, h, w in MEGA_SHAPES:
        raw = amaze_mosaics(gen, b, h, w)
        with amaze_mode("mega"):
            got = amaze_core.amaze_demosaic(raw)
        with amaze_mode("split"):
            split = amaze_core.amaze_demosaic(raw)
        want = amaze_core.amaze_demosaic_plain(raw)
        torch.cuda.synchronize()
        for name, g, sp, v in zip("RGB", got, split, want):
            check(bool(torch.isfinite(g).all()) and g.shape == (b, h, w), f"AMaZE #9 {name}: finite {b}x{h}x{w}")
            err = max(float((g.double() - v.double()).abs().max()), float((g.double() - sp.double()).abs().max()))
            max_err = max(max_err, err)
            check(torch.equal(g, v) and torch.equal(g, sp),
                  f"AMaZE #9 {name} == plain and == split mode at {h}x{w} B={b} (max err {err})")
        del got, split, want
    walks = {(h, w): amaze_core.mega_plan(h, w) for _, h, w in MEGA_SHAPES[-3:-1]}
    print(f"AMaZE kernel #9 vs plain and vs split mode (#8 + #10): "
          f"bit-equal at {len(MEGA_SHAPES)} shapes, max_abs_err {max_err}; walks past the rings: "
          + ", ".join(f"{w} columns refine {'ring' if p['refine_ring'] else 'row walk'}, dilate "
                      f"{'ring' if p['dilate_ring'] else 'row walk'}" for (h, w), p in walks.items()))

    b, h, w = 16, 1080, 1920
    hp, wp = h + 2 * amaze_core.PAD, w + 2 * amaze_core.PAD
    raw = amaze_mosaics(gen, b, h, w)
    n_nyq = nyquist_cells(raw)

    def mega():
        return amaze_core._amaze_demosaic_mega_cuda(raw)

    def split():
        with amaze_mode("split"):
            return amaze_core.amaze_demosaic(raw)

    def plain():
        return amaze_core.amaze_demosaic_plain(raw)

    plain_a = _median_ms(plain, reps=1, warmup=0)
    mega_a, split_a = _median_ms(mega, reps=5), _median_ms(split, reps=5)
    split_b, mega_b = _median_ms(split, reps=5), _median_ms(mega, reps=5)
    plain_b = _median_ms(plain, reps=1, warmup=0)
    mega_ms, split_ms, plain_ms = min(mega_a, mega_b), min(split_a, split_b), min(plain_a, plain_b)
    bound_ms, bound_by = demosaic_bound(b, h, w, n_nyq, with_passes=True)
    plan = amaze_core.mega_plan(h, w)
    # the call is one launch and the allocation of its outputs and workspace
    # (torch's caching allocator), so the CUDA events time the kernel
    print(f"AMaZE demosaic #9 {w}x{h} B={b}: the whole call {mega_ms:.4f} ms (runs {mega_a:.4f}/"
          f"{mega_b:.4f}; blocks of {plan['threads']} threads), split mode #8 + #10 {split_ms:.4f} ms "
          f"(runs {split_a:.4f}/{split_b:.4f}), plain twin {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}: the stages' and the five passes' operations, {n_nyq} Nyquist "
          f"cells; bytes alone {b * h * w * 16 / HBM_BYTES_PER_S * 1e3:.4f} ms), #9 at "
          f"{100 * bound_ms / mega_ms:.1f} % of it [{card}]")

    # where the time goes inside the launch (its %globaltimer stamps), beside
    # split mode's kernels and its pad on the same frames (CUDA events)
    steps = mega_steps_ms(raw)
    split_kernels = split_kernel_ms(raw)
    pad_ms = _median_ms(lambda: amaze_core.pad_mosaic(raw), reps=5)
    k = split_kernels
    split_of = {"pad": ("pad_mosaic", pad_ms), "group 1": ("k_group1", k["k_group1"]),
                "dilate nyq0": ("dilate_kernel", k["dilate_kernel"]), "group 2": ("k_group2", k["k_group2"]),
                "refine hvwt1": ("refine_kernel, half its two launches", k["refine_kernel"] / 2),
                "group 3": ("k_group3", k["k_group3"]),
                "refine pmwt0": ("refine_kernel, half its two launches", k["refine_kernel"] / 2),
                "group 4": ("k_group4", k["k_group4"]),
                "chroma d0 d1": ("chroma_kernel, its two launches", k["chroma_kernel"]),
                "group 5": ("k_output", k["k_output"])}
    for step in amaze_core.MEGA_STEPS:
        what, ms = split_of[step]
        print(f"#9 step {step}: {steps[step]:.4f} ms; split mode {ms:.4f} ms ({what}) [{card}]")
    print(f"#9 steps summed: {sum(steps.values()):.4f} ms (each step up to the grid sync after it); split mode's "
          f"kernels summed {sum(split_kernels.values()):.4f} ms plus its pad [{card}]")
    plane_bytes = b * hp * wp * 4
    print(f"#9's launch: blocks of {plan['threads']} threads, {plan['blocks_per_sm']} an SM on "
          f"{plan['sms']} SMs, {plan['smem_bytes']} B of dynamic shared memory; workspace {len(amaze_core.SPLIT_PLANES)} float32 planes of "
          f"{b}x{hp}x{wp}, {len(amaze_core.SPLIT_PLANES) * plane_bytes / 1e9:.4f} GB (36 planes, "
          f"{36 * plane_bytes / 1e9:.4f} GB, before)")
    for name, usage in mega_resources().items():
        print(f"registers {name}: {usage.get('registers')} a thread, stack {usage.get('stack')} B, spill "
              f"stores {usage.get('spill_stores')} B, spill loads {usage.get('spill_loads')} B (ptxas -v)")
    return max_err, mega_ms, plain_ms, bound_ms, bound_by


def amaze_frame_vs_plain(card: str):
    """Phase 2i. Returns ((max_abs_err, kernel_ms, plain_ms, bound_ms,
    bound_by) of #11's three entry points on the 1080p padded planes of
    B=16, the launches of the phase's comparisons)."""
    import torch

    from mlvfs_tpu_torch.ops import amaze_core, amaze_scans

    gen = torch.Generator(device="cuda").manual_seed(2032)

    def planes(shape):
        wt = torch.rand(shape, device="cuda", generator=gen)
        nyq = (torch.rand(shape, device="cuda", generator=gen) > 0.6).to(torch.int32)
        D0, D1 = (0.1 * torch.randn(shape, device="cuda", generator=gen) for _ in range(2))
        return wt, nyq, D0, D1

    amaze_scans.FRAME_LAUNCHES = 0
    for shape in [(16, 1112, 1952), (224, 192), (1, 320, 1920), (290, 50)]:
        wt, nyq, D0, D1 = planes(shape)
        got = [amaze_scans.refine_frame(wt), amaze_scans.dilate_frame(nyq),
               amaze_scans.dilate_frame(nyq.float()), *amaze_scans.chroma_frame(D0, D1)]
        b3 = [t if t.dim() == 3 else t[None] for t in (wt, nyq, D0, D1)]
        want = [amaze_core.refine_plain(b3[0]), amaze_core.dilate_plain(b3[1]),
                amaze_core.dilate_plain(b3[1]).float(), amaze_core.chroma_plain(b3[2], 1),
                amaze_core.chroma_plain(b3[3], 0)]
        torch.cuda.synchronize()
        for name, g, v in zip(("refine", "dilate int32", "dilate float32", "chroma 0", "chroma 1"), got, want):
            check(g.shape == shape and g.dtype == v.dtype and torch.equal(g, v.reshape(shape)),
                  f"raster pass #11 {name} == plain at {shape}")
    launches = amaze_scans.FRAME_LAUNCHES
    print(f"frame-level raster passes #11 vs plain: bit-equal in all cases, max_abs_err 0; "
          f"{launches} launches in this phase")

    shape = (16, 1112, 1952)
    wt, nyq, D0, D1 = planes(shape)

    def kernels():
        return (amaze_scans.refine_frame(wt), amaze_scans.dilate_frame(nyq),
                amaze_scans.chroma_frame(D0, D1))

    def plain():
        return (amaze_core.refine_plain(wt), amaze_core.dilate_plain(nyq), amaze_core.chroma_plain(D0, 1),
                amaze_core.chroma_plain(D1, 0))

    plain_a = _median_ms(plain, reps=1, warmup=0)
    kernel_a, kernel_b = _median_ms(kernels), _median_ms(kernels)
    plain_b = _median_ms(plain, reps=1, warmup=0)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    n = wt.numel()
    # each plane read once and written once: refine 1, dilate 1, chroma 2;
    # refine 5 and chroma 20 float32 operations a pixel a plane, dilate 8 int32
    t_bytes = 4 * 2 * n * 4 / HBM_BYTES_PER_S
    t_ops = n * (5 + 2 * 20) / FP32_OPS_PER_S + n * 8 / INT32_OPS_PER_S
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    print(f"raster passes #11 (refine_frame, dilate_frame, chroma_frame: 3 launches) on "
          f"{shape[2]}x{shape[1]} B={shape[0]} padded planes: kernels {kernel_ms:.4f} ms (runs "
          f"{kernel_a:.4f}/{kernel_b:.4f}), plain {plain_ms:.4f} ms (runs {plain_a:.4f}/{plain_b:.4f}); "
          f"bound {bound_ms:.4f} ms ({bound_by}), kernels at {100 * bound_ms / kernel_ms:.1f} % of it "
          f"[{card}]")
    return (0.0, kernel_ms, plain_ms, bound_ms, bound_by), launches


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
    """kernel name -> (module, the name of its launch counter)."""
    from mlvfs_tpu_torch.ops import (alias, amaze_core, amaze_edge, amaze_scans, chroma_smooth,
                                     dualiso, dualiso_preview_dev, patternnoise, patternnoise_fused,
                                     unpack)

    from mlvfs_tpu_torch.ops import dualiso_analysis_dev, dualiso_recon, evmath

    modules = {"unpack": unpack, "chroma_smooth": chroma_smooth,
               "pn_blur_interleaved": patternnoise_fused, "pn_blur_split": patternnoise,
               "dualiso_preview": dualiso, "alias_filter": alias, "amaze_edge_pick": amaze_edge,
               "amaze_demosaic": amaze_core, "amaze_raster_passes": amaze_scans,
               "preview_fit": dualiso_preview_dev, "evmath": evmath, "dualiso_recon": dualiso_recon,
               "fit_scores": dualiso_analysis_dev}
    return {**{name: (module, "KERNEL_LAUNCHES") for name, module in modules.items()},
            "amaze_mega": (amaze_core, "MEGA_LAUNCHES"),
            "amaze_raster_frame": (amaze_scans, "FRAME_LAUNCHES")}


def reset_launches():
    for module, counter in _counters().values():
        setattr(module, counter, 0)


def read_launches() -> dict:
    return {name: getattr(module, counter) for name, (module, counter) in _counters().items()}


def analysis_graph_counts() -> tuple:
    """The dual-ISO analysis' graph captures and replays so far."""
    from mlvfs_tpu_torch.utils import metrics

    counted = metrics.counters()
    return counted.get("dualiso.analysis_captures", 0), counted.get("dualiso.analysis_replays", 0)


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
    """Phase 3b: the flags-on convert of a 1080p 5D3 clip, its stripes
    calibrated from the whole first batch. Returns the launches per
    kernel."""
    import numpy as np

    from mlvfs_tpu_torch.format.reader import MLVClip
    from mlvfs_tpu_torch.pipeline import calibration, kernels
    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import ClipConverter
    from mlvfs_tpu_torch.utils import metrics

    w, h = size
    data, bad = flagged_frames(frames, w, h)
    clip = os.path.join(work, "flags", "MFLAGS.MLV")
    synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III", frame_data=data)
    out = os.path.join(work, "flags_out")
    flags = [*FLAGS_ON, "--stripes-batch-cal"]
    metrics.reset()
    metrics.enable(device=device)
    reset_launches()
    try:
        secs, _ = convert_cli(clip, out, device, *flags)
    finally:
        metrics.disable()
    launches = read_launches()
    spans = metrics.totals()
    files = dng_files(out)
    check(len(files) == frames, f"flags-on: {frames} DNGs (got {len(files)})")
    n_batches = math.ceil(frames / batch_size)
    for name in ("fetch", "decode", "process", "finish"):
        n = spans.get(name, {}).get("count", 0)
        check(n == n_batches, f"flags-on: {n_batches} {name} spans (got {n})")
    want = n_batches if device.startswith("cuda") else 0
    for name, n in launches.items():
        if name == "evmath":  # the batch stripe calibration's log2 and fma, once a clip
            check((n > 0) == device.startswith("cuda"), f"flags-on: EV kernel launches {n}, on the card only")
            continue
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

    # the CPU converts the whole first batch (the batch calibration's
    # input), without the card's sidecar
    n_ref = 4
    cfg = ProcessingConfig(device="cpu", use_sidecar_idx=False, deflicker=3000, chroma_smooth=3,
                           fix_stripes=True, stripes_batch_cal=True, fix_bad_pixels=1)
    ref_out = os.path.join(work, "flags_cpu")
    t0 = time.perf_counter()
    with MLVClip(clip) as mlv:
        conv = ClipConverter(mlv, cfg)
        try:
            conv.convert(ref_out, frames=range(batch_size))
        finally:
            conv.close()
        card_cal = kernels.ClipCalibration()
        calibration.load_into(card_cal, clip, mlv.guid, cfg)
    cpu_secs = time.perf_counter() - t0
    cpu_gains = np.asarray(conv._calibration.stripes_gains)
    check(card_cal.stripes_done and np.array_equal(card_cal.stripes_gains, cpu_gains)
          and card_cal.stripes_needed == conv._calibration.stripes_needed,
          f"flags-on: the card's batch-calibrated gains {card_cal.stripes_gains} == the cpu's {cpu_gains}")
    for p, q in zip(files[:n_ref], dng_files(ref_out)):
        check(read(p) == read(q), f"flags-on {os.path.basename(p)}: {device} == cpu, byte for byte")
    mb = frames * (DNG_HEADER + w * h * 2) / 1e6
    print(f"convert 5D3 {w}x{h} 14-bit {' '.join(flags)}, {frames} frames, --device {device}: "
          f"{secs:.3f} s, {frames / secs:.1f} f/s, {mb / secs:.1f} MB/s written; spans (host s, "
          f"overlapping) " + ", ".join(f"{k} {v['host_ms'] / 1e3:.3f}" for k, v in sorted(spans.items()))
          + f"; launches {launches}; {len(bad)} bad pixels fixed, stripes changed {restriped} "
          f"green px of frame 0; gains {cpu_gains.tolist()} from the first batch == the cpu's; first "
          f"{n_ref} DNGs == cpu conversion ({cpu_secs:.1f} s on the cpu for {batch_size} frames) [{card}]")
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
    --stripes --stripes-batch-cal``, with the card's default (device) fit,
    then with the host fit. Returns the launches per kernel of the default
    converts."""
    import numpy as np

    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    total = {}
    cases = [
        ("5D3", size, frames, 0x80000285, "Canon EOS 5D Mark III", False, []),
        ("EOS M", eosm_size, eosm_frames, 0x80000331, "Canon EOS M", True,
         ["--bad-pix", "--cs2x2", "--stripes", "--stripes-batch-cal"]),
    ]
    for tag, (w, h), n, model, name, odd_plain, extra in cases:
        data = dual_iso_frames(n, w, h, odd_plain)
        clip = os.path.join(work, f"di_{model:x}", "MDI.MLV")
        synth_clip(clip, n, w, h, model, name, frame_data=data, dual_iso=3)
        flags = dict(dual_iso=1, use_sidecar_idx=False)
        if extra:
            flags.update(fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True, stripes_batch_cal=True)
        batches = math.ceil(n / batch_size) if device.startswith("cuda") else 0
        for fit, card_mode, cpu_mode in (("device fit", None, "1"), ("host fit", "0", "0")):
            out = os.path.join(work, f"di_{model:x}_out_{card_mode}")
            reset_launches()
            with preview_dev_mode(card_mode):
                secs, _ = convert_cli(clip, out, device, "--dual-iso-preview", "--no-idx", *extra)
            launches = read_launches()
            if card_mode is None:
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            files = dng_files(out)
            check(len(files) == n, f"dual-ISO {tag}, {fit}: {n} DNGs (got {len(files)})")
            want_fit = batches if card_mode is None else 0
            check(launches["preview_fit"] == want_fit,
                  f"dual-ISO {tag}, {fit}: fit kernel launches {launches['preview_fit']} == {want_fit}")
            check(launches["dualiso_preview"] == batches,
                  f"dual-ISO {tag}, {fit}: preview kernel launches {launches['dualiso_preview']} == {batches}")
            if extra:
                check(launches["chroma_smooth"] == 2 * batches,
                      f"dual-ISO {tag}: mixed batches smooth under both levels")
            ref_out = os.path.join(work, f"di_{model:x}_cpu_{cpu_mode}")
            t0 = time.perf_counter()
            with preview_dev_mode(cpu_mode):
                convert_clip(clip, ref_out, ProcessingConfig(device="cpu", **flags))
            cpu_secs = time.perf_counter() - t0
            ri_black, ri_white = 2048, 15000
            converted = 0
            ref_files = dng_files(ref_out)
            check(len(ref_files) == n, f"dual-ISO {tag}, {fit}: {n} cpu DNGs (got {len(ref_files)})")
            for i, (p, q) in enumerate(zip(files, ref_files)):
                raw = read(p)
                check(raw == read(q), f"dual-ISO {tag} {os.path.basename(p)}, {fit}: {device} == cpu, "
                                      f"byte for byte")
                dual = not (odd_plain and i % 2)
                want = (4 * ri_black, 4 * ri_white) if dual else (ri_black, ri_white)
                check(dng_levels(raw) == want, f"dual-ISO {tag} frame {i}: levels {dng_levels(raw)} == {want}")
                if not extra:  # the preview's <<2 output, untouched by later steps
                    payload = np.frombuffer(raw, "<u2", offset=DNG_HEADER)
                    check(bool((payload % 4 == 0).all()), f"dual-ISO {tag} frame {i}: converted")
                converted += dual
            print(f"convert {tag} {w}x{h} 14-bit dual-ISO {' '.join(['--dual-iso-preview', *extra])}, "
                  f"{fit} (MLVFS_TPU_PREVIEW_DEV={card_mode or 'unset'}), {n} frames, --device {device}: "
                  f"{secs:.3f} s, {n / secs:.1f} f/s; launches {launches}; of the {n} DNGs "
                  f"{converted} converted at x4 levels, the rest at their own, all == cpu conversion "
                  f"(MLVFS_TPU_PREVIEW_DEV={cpu_mode or 'unset'}, {cpu_secs:.1f} s on the cpu) [{card}]")
    return total


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10 * math.log10(65535.0 ** 2 / mse)


DUAL_ISO_FULL = ["--dual-iso", "--mean23"]
DUAL_ISO_AMAZE = ["--dual-iso"]  # amaze-edge, the default interpolation


def dif_paths(work, interp, model):
    """(clip, card DNGs, CPU DNGs) of phase 3e/3f's clip of camera ``model``."""
    base = os.path.join(work, f"dif_{interp}_{model:x}")
    return os.path.join(base, "MDIF.MLV"), base + "_out", base + "_cpu"


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
        if interp == "mean23":
            hdr_check_on_card(tag, data[:8], ri_black, ri_white, card)
        clip, out, ref_out = dif_paths(work, interp, model)
        clips[tag] = clip
        synth_clip(clip, n, w, h, model, name, frame_data=data, dual_iso=3)
        reset_launches()
        graphs = analysis_graph_counts()
        secs, _ = convert_cli(clip, out, device, *program, "--no-idx", *extra)
        launches = read_launches()
        captures, replays = (n - m for n, m in zip(analysis_graph_counts(), graphs))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        files = dng_files(out)
        check(len(files) == n, f"dual-ISO full {tag}: {n} DNGs (got {len(files)})")
        batches = math.ceil(n / batch_size) if device.startswith("cuda") else 0
        check((launches["evmath"] > 0) == (batches > 0),
              f"dual-ISO full {tag}: the EV kernel launches on the card only ({launches['evmath']})")
        check(launches["alias_filter"] == batches,
              f"dual-ISO full {tag}: alias kernel launches {launches['alias_filter']} == {batches}")
        check(launches["chroma_smooth"] == 0 and launches["dualiso_preview"] == 0,
              f"dual-ISO full {tag}: no 16-bit chroma or preview kernel ({launches})")
        check(launches["fit_scores"] == batches,
              f"dual-ISO full {tag}: the fit's scoring launches {launches['fit_scores']} == {batches}, "
              f"replayed or not")
        # a batch shape captures on its second batch and replays from then on
        # (an earlier convert may have seen the clip's shapes): the 5D3 clip's
        # two batches of one shape replay at least once
        check(captures <= replays <= batches and replays >= (1 if tag == "5D3" and batches else 0),
              f"dual-ISO full {tag}: analysis graph captures {captures}, replays {replays} of {batches} batches")
        recon_per_batch = 4 if "--cs2x2" in extra else 3  # match, blend, (alias planes,) final
        check(launches["dualiso_recon"] == recon_per_batch * batches,
              f"dual-ISO full {tag}: fused stage launches {launches['dualiso_recon']} == "
              f"{recon_per_batch} x {batches}")
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
            worst_psnr, worst_share = min(worst_psnr, pv), max(worst_share, share)
            check(raw == ref, f"dual-ISO full {tag} {os.path.basename(p)}: {device} == cpu, byte for "
                  f"byte (PSNR {pv:.1f} dB, {100 * share:.4f} % of pixels differ)")
        print(f"convert {tag} {w}x{h} 14-bit dual-ISO {' '.join([*program, *extra])}, {n} frames, "
              f"--device {device}: {secs:.3f} s, {n / secs:.1f} f/s; launches {launches}; {converted} "
              f"frames converted at x4 levels, the rest at their own; first {n_ref} DNGs == cpu "
              f"({cpu_secs:.1f} s on the cpu), byte for byte (PSNR >= {worst_psnr:.1f} dB, at most "
              f"{100 * worst_share:.4f} % of pixels differ) [{card}]")
    if interp != "mean23":
        return total
    out = os.path.join(work, "dif_noalias_out")
    reset_launches()
    graphs = analysis_graph_counts()
    secs, _ = convert_cli(clips["5D3"], out, device, *DUAL_ISO_FULL, "--no-alias-map", "--no-idx")
    launches = read_launches()
    captures, replays = (n - m for n, m in zip(analysis_graph_counts(), graphs))
    batches = math.ceil(frames / batch_size) if device.startswith("cuda") else 0
    check(captures == 0 and replays == batches and launches["fit_scores"] == batches,
          f"--no-alias-map: every batch replays the analysis graph the first 5D3 convert captured "
          f"(captures {captures}, replays {replays}, scoring launches {launches['fit_scores']} of {batches})")
    check(launches["alias_filter"] == 0, f"--no-alias-map: alias kernel launches {launches['alias_filter']} == 0")
    check(launches["dualiso_recon"] == (3 * math.ceil(frames / batch_size) if device.startswith("cuda") else 0),
          f"--no-alias-map: fused stage launches {launches['dualiso_recon']}")
    files = dng_files(out)
    check(len(files) == frames and all(dng_levels(read(p)) == (4 * ri_black, 4 * ri_white) for p in files),
          "--no-alias-map: every frame converted at x4 levels")
    print(f"convert 5D3 {size[0]}x{size[1]} {' '.join(DUAL_ISO_FULL)} --no-alias-map, {frames} frames: "
          f"{secs:.3f} s; launches {launches} [{card}]")
    return total


def hdr_check_on_card(tag, frames, black, white, card):
    """hdr_check's decisions and exact sums on the card equal the CPU's on a
    clip's frames (uint16, (n, h, w))."""
    import torch

    from mlvfs_tpu_torch.ops import dualiso_full

    t = torch.from_numpy(frames.view("int16"))
    got = dualiso_full.hdr_check_batch(t.cuda(), black, white).cpu()
    want = dualiso_full.hdr_check_batch(t, black, white)
    sums = dualiso_full.hdr_check_sums(dualiso_full.hdr_check_terms(t.cuda(), black, white)[0]).cpu()
    check(torch.equal(got, want) and torch.equal(sums, dualiso_full.hdr_check_sums(
        dualiso_full.hdr_check_terms(t, black, white)[0])),
          f"dual-ISO full {tag}: hdr_check on the card decides as on the cpu, with the same sums")
    print(f"hdr_check {tag}, {len(frames)} frames: {int(got.sum())} interlaced on the card and on the cpu, "
          f"sums equal to the bit [{card}]")


def amaze_mega_path(work, card, device="cuda", batch_size=16, n_ref=2):
    """Phase 3f in mega mode: phase 3f's two clips and flags converted once
    more with MLVFS_AMAZE_PALLAS_MODE=mega. Per batch #9 launches once and
    #8 and #10 not at all; every DNG equals the split mode's card DNG and
    the first ``n_ref`` the port's CPU DNGs, byte for byte. Returns the
    launches per kernel."""
    total = {}
    cases = [("5D3", 0x80000285, []), ("EOS M", 0x80000331, ["--bad-pix", "--cs2x2", "--stripes"])]
    for tag, model, extra in cases:
        clip, split_out, cpu_out = dif_paths(work, "amaze", model)
        out = split_out + "_mega"
        reset_launches()
        with amaze_mode("mega"):
            secs, _ = convert_cli(clip, out, device, *DUAL_ISO_AMAZE, "--no-idx", *extra)
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        files, split_files = dng_files(out), dng_files(split_out)
        n = len(split_files)
        check(len(files) == n, f"mega {tag}: {n} DNGs (got {len(files)})")
        batches = math.ceil(n / batch_size)
        want = {"amaze_mega": batches, "amaze_demosaic": 0, "amaze_raster_passes": 0,
                "amaze_edge_pick": batches, "alias_filter": batches}
        for name, per_run in want.items():
            check(launches[name] == per_run, f"mega {tag}: {name} launches {launches[name]} == {per_run}")
        for p, q in zip(files, split_files):
            check(read(p) == read(q), f"mega {tag} {os.path.basename(p)}: == split mode's, byte for byte")
        for p, q in zip(files[:n_ref], dng_files(cpu_out)):
            check(read(p) == read(q), f"mega {tag} {os.path.basename(p)}: == cpu, byte for byte")
        print(f"convert {tag} dual-ISO {' '.join([*DUAL_ISO_AMAZE, *extra])} with "
              f"MLVFS_AMAZE_PALLAS_MODE=mega, {n} frames, --device {device}: {secs:.3f} s, "
              f"{n / secs:.1f} f/s; launches {launches}; all {n} DNGs == split mode's, first {n_ref} "
              f"== cpu conversion, byte for byte [{card}]")
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


def flags_on_chroma_input(work, frames=16, size=(1920, 1080)):
    """(frames, method, black) that the flags-on program hands the chroma
    kernel in its first batch (after the deflicker, bad-pixel and focus
    fixes), captured from one convert on the card."""
    from mlvfs_tpu_torch.ops import chroma_smooth as cs

    w, h = size
    clip = os.path.join(work, "cap", "MCAP.MLV")
    synth_clip(clip, frames, w, h, 0x80000285, "Canon EOS 5D Mark III",
               frame_data=flagged_frames(frames, w, h)[0])
    captured = []
    smooth = cs.chroma_smooth_batch

    def capture(imgs, method, black):
        captured.append((imgs.clone(), method, black))
        return smooth(imgs, method, black)

    cs.chroma_smooth_batch = capture
    try:
        convert_cli(clip, os.path.join(work, "cap_out"), "cuda", *FLAGS_ON)
    finally:
        cs.chroma_smooth_batch = smooth
        shutil.rmtree(os.path.join(work, "cap"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "cap_out"), ignore_errors=True)
    check(len(captured) == 1, f"the flags-on convert smoothed one batch (got {len(captured)})")
    return captured[0]


def breakdown(work, card, frames):
    """``--breakdown N``: the per-layer times of the flags-on, pattern-noise,
    preview and full dual-ISO steps (mean23 and amaze-edge), then each of
    the five programs as an N-frame 1080p convert: twice, and once under
    torch.profiler."""
    import numpy as np
    import torch

    import types

    from mlvfs_tpu_torch.ops import (alias, amaze, amaze_core, amaze_edge, chroma_smooth, dualiso,
                                     dualiso_analysis_dev, dualiso_full, dualiso_preview_dev, evmath,
                                     histogram, patternnoise, patternnoise_fused, pixels, stripes, unpack)
    from mlvfs_tpu_torch.utils import metrics

    w, h, b, black, white = 1920, 1080, 16, 2048, 15000
    data, _ = flagged_frames(b, w, h)
    t0 = time.perf_counter()
    bad = pixels.detect_bad_pixels(data[0], w, h, black, False, 0, 0)
    t1 = time.perf_counter()
    gains, _ = stripes.compute_correction(data[0], black, white, w, frame_size_bytes=w * h * 14 // 8)
    t2 = time.perf_counter()
    imgs = torch.from_numpy(data.view(np.int16)).cuda()
    batch_cal = []
    for _ in range(3):  # each run to its gains on the host, as the pipeline reads them
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        g_dev, needed_dev = stripes.calibrate_batch_device(imgs, black, white, w * h * 14 // 8)
        g_dev.cpu(), bool(needed_dev)
        batch_cal.append(1e3 * (time.perf_counter() - t3))
    print(f"once per clip: bad-pixel detection {1e3 * (t1 - t0):.1f} ms on the host ({len(bad)} px), "
          f"stripe calibration from frame 0 on the host {1e3 * (t2 - t1):.1f} ms, from the whole batch "
          f"of {b} on the card (--stripes-batch-cal) {' / '.join(f'{v:.1f}' for v in batch_cal)} ms "
          f"(three runs, the gains read back) [{card}]")
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

    def preview_step(mode):
        def run():
            with preview_dev_mode(mode):
                return dualiso.hdr_preview_batch(di_imgs, fh, None)
        return run

    padded, real, stored = dualiso_preview_dev.sorted_phases(di_imgs, white)
    fit_sorted_args = (padded, real, dualiso_preview_dev.median_ranks(real, stored), black, white, stored[0])

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

    def mega_demosaic():
        with amaze_mode("mega"):
            return amaze_core.amaze_demosaic(squeezed)

    layers = [
        ("unpack kernel", lambda: unpack.unpack_batch(words, 14, h, w)),
        ("deflicker median", lambda: histogram.deflicker_median(imgs, (1 << 14) + 1)),
        ("pattern noise, whole step (2 directions)",
         lambda: patternnoise.fix_pattern_noise_batch(pn_imgs, white)),
        ("  pattern-noise blur kernel #3, rows", lambda: patternnoise_fused.blur_interleaved(raw)),
        ("  pattern-noise column stage, rows",
         lambda: patternnoise_fused.fix_column_noise_interleaved(raw, den, white)),
        ("dual-ISO preview, whole step, device fit (the card's default; ok read back, syncs)",
         preview_step(None)),
        ("  preview device fit: sorts + fit kernel", lambda: dualiso_preview_dev.preview_fit_device(
            di_imgs, black, white)),
        ("  preview fit kernel", lambda: dualiso_preview_dev.fit_sorted(*fit_sorted_args)),
        ("dual-ISO preview, whole step, host fit (MLVFS_TPU_PREVIEW_DEV=0)", preview_step("0")),
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
        ("  AMaZE demosaic, kernel #9 (mega mode), on its squeezed frames", mega_demosaic),
        ("  edge kernel #6 on its EV planes", lambda: amaze_edge.edge_pick(*edge_args)),
        ("bad-pixel fix", lambda: pixels.fix_pixel_list_batch(imgs, bad, black, 0, 0, False)),
        ("chroma kernel cs3x3", lambda: chroma_smooth.chroma_smooth_batch(imgs, 3, black)),
        ("stripe apply", lambda: stripes.apply_correction_batch(imgs, gains, black, white)),
    ]
    # the bounds of #7, #6 and #10 on the main path's own inputs, beside the
    # times of their rows below
    n_px = alias_map.numel()
    n_sel, pairs, n_work, tiles = alias_work(alias_skip)
    a_bound = bound(n_px * (4 + 1 + 4), alias_ops(n_sel, n_px))
    design = pairs * ALIAS_PAIR_OPS + n_sel * ALIAS_BLUR_OPS + n_px * ALIAS_CELL_OPS
    print(f"the mean23 reconstruction's alias filter #7 selects {n_sel} of {n_px} pixels "
          f"({100 * n_sel / n_px:.1f} %) on these frames: bound {a_bound[0]:.4f} ms ({a_bound[1]}); "
          f"{n_work} of {tiles} tiles work, {pairs} pairs, the design's own steps "
          f"{design / max(n_sel, 1):.1f} operations a selected pixel [{card}]")
    n_px = edge_args[4].numel()
    n_scored, e_ops, forms = edge_work(edge_args[4], amaze_edge.DIRECT_PER_ROW)
    e_bound = bound(n_px * (3 * 4 + 1 + 4) + edge_args[3].numel() * 4, edge_ops(n_scored, n_px))
    print(f"the amaze-edge reconstruction's edge pick #6 scores {n_scored} of {n_px} pixels "
          f"({100 * n_scored / n_px:.1f} %) on these frames: bound {e_bound[0]:.4f} ms ({e_bound[1]}); "
          f"tiles by form {forms}, the design's own steps {e_ops / max(n_scored, 1):.1f} operations a "
          f"scored pixel [{card}]")
    p_bound = bound(2 * di_imgs.numel() * 2, 17 * di_imgs.numel(), FP32_OPS_PER_S)
    p_ms, p_runs = _profiled_seen_ms(lambda: dualiso.apply_preview(di_imgs, *fit_args, black, white),
                                     ("preview_kernel",), "the preview kernel")
    print(f"the preview kernel #5 on the preview's own frames and fits ({b}x{h}x{w}, "
          f"{sum(f.ok for f in fits)} of {b} frames detected): {p_ms:.4f} ms device time (torch.profiler; "
          f"runs {p_runs}); "
          f"bound {p_bound[0]:.4f} ms ({p_bound[1]}: 2 B in and 2 B out a pixel) [{card}]")
    cs_imgs, cs_method, cs_black = flags_on_chroma_input(work, b, (w, h))
    ny, nx = chroma_smooth.cell_window(h, w)
    c_bound = bound(chroma_bytes(cs_imgs), chroma_ops(cs_method, cs_imgs.shape[0] * ny * nx))
    c_runs, c_ms, c_dev_runs = chroma_times(cs_imgs, cs_method, cs_black)
    print(f"the chroma kernel #2 (cs{cs_method}x{cs_method}) on the flags-on program's own frames "
          f"({tuple(cs_imgs.shape)}, black {cs_black}): call {min(c_runs):.4f} ms by CUDA events "
          f"(runs {c_runs[0]:.4f}/{c_runs[1]:.4f}), device {c_ms:.4f} ms (torch.profiler; runs "
          f"{c_dev_runs}); bound {c_bound[0]:.4f} ms ({c_bound[1]}) [{card}]")
    bs, hs, ws = squeezed.shape
    n_padded = bs * (hs + 32) * (ws + 32)
    pass_ms = _profiled_ms(lambda: amaze_core.amaze_demosaic(squeezed), PASS_KERNELS)
    print(f"raster passes #10 inside the demosaic of the squeezed frames (torch.profiler): {pass_ms:.4f} ms; "
          f"bound {5 * 2 * n_padded * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: each of the five passes "
          f"reads and writes its {ws + 32}x{hs + 32} B={bs} plane) [{card}]")
    for name, fn in layers:
        launched = ""
        if name.startswith("dual-ISO full"):
            before = getattr(evmath, "KERNEL_LAUNCHES", 0)  # a parent without the EV kernel has none
            fn()
            launched = f", {getattr(evmath, 'KERNEL_LAUNCHES', 0) - before} EV kernel launches a call"
        device_ms = _median_ms(fn)
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(1e3 * (time.perf_counter() - t0))
        print(f"per batch of {b} at {w}x{h}: {name}: device {device_ms:.4f} ms, host enqueue "
              f"{sorted(host)[10]:.4f} ms{launched} [{card}]")

    programs = [
        ("flags-on", FLAGS_ON, flagged_frames(frames, w, h)[0], {}),
        ("pattern-noise", ["--fix-pattern-noise"], pattern_noise_frames(frames, w, h), {}),
        ("dual-ISO preview, device fit", ["--dual-iso-preview"], dual_iso_frames(frames, w, h),
         {"dual_iso": 3}),
        ("dual-ISO preview, host fit", ["--dual-iso-preview"], dual_iso_frames(frames, w, h),
         {"dual_iso": 3}),
        ("dual-ISO full", DUAL_ISO_FULL, dual_iso_frames(frames, w, h), {"dual_iso": 3}),
        ("dual-ISO amaze-edge", DUAL_ISO_AMAZE, dual_iso_frames(frames, w, h), {"dual_iso": 3}),
    ]
    for label, flags, data, spec in programs:
        mode = "0" if label.endswith("host fit") else None
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
                metrics.enable(device=True)
                try:
                    with preview_dev_mode(mode):
                        secs, _ = convert_cli(clip, out, "cuda", *flags)
                finally:
                    metrics.disable()
                spans = metrics.totals()
                print(f"{label} convert {w}x{h}, {frames} frames, {run}: {secs:.3f} s, "
                      f"{frames / secs:.1f} f/s; spans (host s, overlapping; device s) "
                      + ", ".join(f"{k} {v['host_ms'] / 1e3:.3f}"
                                  + ("" if v["device_ms"] is None else f"/{v['device_ms'] / 1e3:.3f}")
                                  for k, v in sorted(spans.items()) if "." not in k or k.startswith("recon."))
                      + f" [{card}]")
                continue
            with preview_dev_mode(mode):
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
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="GPU smoke test of mlvfs_tpu_torch (see the module doc)")
    ap.add_argument("--breakdown", type=int, metavar="N",
                    help="per-layer times and N-frame converts instead of the smoke test")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only the unpack and chroma calls' times (phases 2 and 2b's inputs)")
    ap.add_argument("--mega", action="store_true",
                    help="only phase 2h: the fused AMaZE kernel #9 against the twin and split mode")
    ap.add_argument("--recon", action="store_true",
                    help="only phase 2l: the reconstruction's fused stages and the analysis' graph")
    ap.add_argument("--package-root", default=ROOT, metavar="DIR",
                    help="the checkout whose mlvfs_tpu_torch is measured (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.package_root))
    from mlvfs_tpu_torch import _build
    from mlvfs_tpu_torch.ops import amaze_core

    os.environ.pop(amaze_core.MODE_ENV, None)  # split mode, unless a phase picks mega

    check_no_reference("the port loads")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, package {os.path.abspath(args.package_root)}")
    if args.kernel_times:
        _build.library("unpack")
        _build.library("chroma")
        kernel_times(card)
        check_no_reference("the port ran")
        return 0
    if args.mega:
        _build.build_all()
        amaze_mega_vs_plain(card)
        check_no_reference("the port ran")
        return 0
    if args.recon:
        recon_vs_plain(card)
        analysis_replay_vs_eager(card)
        check_no_reference("the port ran")
        return 0
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {', '.join(sorted({src for src, _ in KERNELS.values()}))} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if args.breakdown is not None:
        try:
            breakdown(work, card, args.breakdown)
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
    mega_row = amaze_mega_vs_plain(card)
    frame_row, frame_launches = amaze_frame_vs_plain(card)
    fit_row, fit_chain_ms = preview_fit_vs_plain(card)
    ev_row = ev_vs_plain(card)
    recon_row = recon_vs_plain(card)
    scores_row = analysis_replay_vs_eager(card)
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
        mega_launches = amaze_mega_path(work, card)
        compressed_variants(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check_no_reference("the port ran")

    rows = {"unpack": unpack_row, "chroma_smooth": chroma_rows[3],  # the path's --cs3x3
            **pn_rows, "dualiso_preview": preview_row, "alias_filter": alias_row,
            "amaze_edge_pick": edge_row, **amaze_rows, "amaze_mega": mega_row,
            "amaze_raster_frame": frame_row, "preview_fit": fit_row, "evmath": ev_row,
            "dualiso_recon": recon_row, "fit_scores": scores_row}
    paths = (flags_launches, pn_launches, di_launches, full_launches, amaze_launches, mega_launches)
    launches = {name: sum(path[name] for path in paths) for name in rows}
    launches["unpack"] += default_launches
    for name in ("pn_blur_interleaved", "dualiso_preview", "alias_filter", "amaze_edge_pick",
                 "amaze_demosaic", "amaze_raster_passes", "amaze_mega", "preview_fit", "evmath",
                 "dualiso_recon", "fit_scores"):
        check(launches[name] > 0, f"the main paths launched {name}")
    # kernels #4 and #11 are on no convert path: their launches there are 0,
    # and those of their kernel phases are listed apart
    phase_launches = {"pn_blur_split": split_launches, "amaze_raster_frame": frame_launches}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes any of these functions
        **({"kernel_phase_launches": phase_launches[name]} if name in phase_launches else {}),
        **({"pallas_original": False} if name in NO_PALLAS_ORIGINAL else {}),
        **({"chain_bound_ms": fit_chain_ms} if name == "preview_fit" else {}),
    } for name, (err, ms, plain_ms, bound_ms, bound_by) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
