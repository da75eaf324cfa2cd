#!/usr/bin/env python3
"""GPU smoke test of mlvfs_tpu_torch, the PyTorch + CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

  1. the card's name and power limit; build of the CUDA kernels from csrc/;
  2. the unpack kernel against its plain PyTorch twin on the card, bit-equal
     (torch.equal), at 8/10/12/14 bpp: 1920x1080 with B=16, 1808x727, a pixel
     count that leaves a partial last block, and a truncated word stream;
     median CUDA-event times of both and the kernel's GB/s;
  3. the main path, ``python -m mlvfs_tpu_torch convert CLIP -o OUT --device
     cuda`` through ``cli.main``: a 1920x1080 14-bit 5D Mark III clip (64
     frames) whose DNG payloads must equal the synthesized frames, and a
     1872x1060 EOS M clip (32 frames, bundled focus-pixel map) whose first
     DNGs must be byte-identical to the port's own CPU conversion; the
     unpack kernel's launch count must grow by the number of batches;
  4. LZMA and LJ92 variants of a short 1080p clip through the card, whose
     DNGs must be byte-identical to the uncompressed clip's.

Without a CUDA card it exits non-zero and prints no result. The line before
the last is a JSON summary of the kernels; the last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch files go to build/smoke/ under the repository and are removed at
the end.
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
KERNEL_SOURCE = "mlvfs_tpu_torch/csrc/unpack.cu"
KERNEL_REPLACES = "mlvfs_tpu/ops/unpack.py:96"
DNG_HEADER = 65536


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
    """Phase 2. Returns (max_abs_err, kernel_ms, plain_ms) at 1080p/14 bpp/B=16."""
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
            headline = (kernel_ms, plain_ms)
    print(f"unpack kernel vs plain: bit-equal in all cases, max_abs_err {max_err}")
    return max_err, headline[0], headline[1]


def synth_clip(path, frames, width, height, camera_model, camera_name, frame_data=None, **kw):
    import numpy as np

    from mlvfs_tpu.format import synth

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


def convert_cli(clip, outdir, device):
    """One default conversion through the CLI. Returns (seconds, launches)."""
    from mlvfs_tpu_torch import cli
    from mlvfs_tpu_torch.ops import unpack

    before = unpack.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    rc = cli.main(["convert", clip, "-o", outdir, "--device", device])
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mlvfs_tpu_torch import _build
    from mlvfs_tpu_torch.ops import unpack

    check("jax" not in sys.modules, "the port runs without jax")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library("unpack")
    print(f"built {KERNEL_SOURCE} ({_build.library_path('unpack')}) in "
          f"{time.perf_counter() - t0:.2f} s")

    max_err, kernel_ms, plain_ms = kernel_vs_plain()

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        unpack.KERNEL_LAUNCHES = 0
        launches = main_path(work, card=card)
        check(launches > 0, "the main path launched the unpack kernel")
        compressed_variants(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules, "the port ran without jax")

    print(json.dumps({"kernels": [{
        "name": "unpack", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
