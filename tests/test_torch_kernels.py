"""The port's CUDA kernels against their plain PyTorch twins, on the card,
and the card's conversions against the CPU's.

The tests marked ``cuda`` skip without a card. This file imports torch and
the port only (no jax), so the GPU machine runs it on its own:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kernels.py
"""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch import _build
from mlvfs_tpu_torch.ops import (alias, amaze_core, amaze_edge, amaze_scans, chroma_smooth, dualiso,
                                 dualiso_full, dualiso_preview_dev, evmath, patternnoise,
                                 patternnoise_fused, pixels, stripes, unpack)
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip
from mlvfs_tpu_torch.utils import metrics
from tests.test_torch_hdr_frames import hdr_threshold_frames


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _words(rng, b, n_words):
    return torch.from_numpy(rng.integers(0, 1 << 16, (b, n_words), dtype=np.uint16).view(np.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [8, 10, 12, 14, 16, 11])
def test_unpack_kernel_matches_plain(bpp):
    """Bit-equal to the twin, including a partial last block, a truncated
    stream (cut inside the last group), frames whose words and pixels start
    off 16-byte boundaries, and a bpp without a form of its own (11)."""
    _need_card()
    rng = np.random.default_rng(bpp)
    for h, w, b, cut, off in [(1080, 1920, 4, 0, 0), (727, 1808, 2, 0, 0), (5, 27, 3, 0, 0),
                              (64, 96, 2, 1000, 0), (727, 1807, 3, 0, 1), (1060, 1872, 2, 3, 3),
                              (64, 96, 2, 0, 4)]:
        n_words = unpack.words_for_pixels(h * w, bpp) - cut
        words = _words(rng, 1, b * n_words + off)[0, off:].view(b, n_words).cuda()
        before = unpack.KERNEL_LAUNCHES
        got = unpack.unpack_batch(words, bpp, h, w)
        assert unpack.KERNEL_LAUNCHES == before + 1
        want = unpack.unpack_batch_plain(words, bpp, h, w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (h, w, b, cut, off)
        assert torch.equal(got.cpu(), unpack.unpack_batch(words.cpu(), bpp, h, w))


@pytest.mark.cuda
def test_unpack_kernel_refuses_bad_input():
    _need_card()
    words = torch.zeros((2, 64), dtype=torch.int16, device="cuda")
    with pytest.raises(TypeError):
        unpack.unpack_batch(words.to(torch.int32), 14, 4, 8)
    with pytest.raises(ValueError):
        unpack.unpack_batch(words[:, ::2], 14, 4, 4)
    with pytest.raises(ValueError):
        unpack.unpack_batch(words, 17, 4, 8)
    assert unpack.unpack_batch(words[:0], 14, 4, 8).shape == (0, 4, 8)


@pytest.mark.cuda
def test_pixel_fix_on_card_matches_cpu():
    """The focus-pixel fix (plain torch) gives the same bits on the card."""
    _need_card()
    h, w, black = 1060, 1872, 2047
    pl = pixels.load_focus_pixel_map(0x80000331, w, h)
    rng = np.random.default_rng(5)
    imgs = rng.integers(black - 8, 15000, (3, h, w)).astype(np.uint16)
    imgs[:, ::3, ::7] = black
    t = torch.from_numpy(imgs.view(np.int16))
    want = pixels.fix_pixel_list_batch(t, pl, black, 0, 0, False)
    got = pixels.fix_pixel_list_batch(t.cuda(), pl, black, 0, 0, False)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["none", "lzma", "lj92"])
def test_convert_on_card_matches_cpu(compression, tmp_path):
    """The whole default convert (with --all sidecars, tail batch) writes the
    same bytes on the card as on the CPU."""
    _need_card()
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=320, height=96, frames=5, compression=compression,
                    camera_model=0x80000331, audio=True)
    rng = np.random.default_rng(4)
    fpm = tmp_path / "80000331_320x96.fpm"
    fpm.write_text("".join(f"{x} {y}\n" for x, y in zip(rng.integers(-2, 324, 400),
                                                          rng.integers(-2, 98, 400))))
    trees = []
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        random.seed(3)  # the WAV emitter draws a random originator reference
        convert_clip(src, str(out), ProcessingConfig(device=device, batch_size=2,
                                                     export_all=True, focus_pixel_dir=str(tmp_path)))
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert list(trees[0]) == list(trees[1]) and len(trees[0]) == 8
    assert trees[0] == trees[1]


@pytest.mark.cuda
@pytest.mark.parametrize("method", [2, 3, 5])
def test_chroma_kernel_matches_plain(method):
    """Bit-equal to the twin at the smoke test's shapes and black levels,
    with a block of pixels exactly at black (raw2ev = INT_MIN); frames over
    the whole u16 range at black * 4 (the dual-ISO preview's), a frame at or
    above 16,384 everywhere (past the staged table), and the widest and
    shortest windowed shapes."""
    _need_card()
    rng = np.random.default_rng(method)
    cases = [(b, h, w, black, black - 40, 16000) for b, h, w in
             [(16, 1080, 1920), (4, 727, 1808), (1, 8, 8), (1, 8, 16), (1, 16, 8)] for black in (2047, 2048)]
    cases += [(4, 1080, 1920, 8188, 0, 65536), (2, 727, 1808, 8192, 0, 65536),
              (2, 1080, 1920, 2047, 16384, 65536),
              (1, 10, 5760, 2048, 2008, 16000), (2, 1080, 10, 2047, 2007, 16000), (3, 10, 10, 2047, 2007, 16000)]
    for b, h, w, black, lo, hi in cases:
        imgs = rng.integers(lo, hi, (b, h, w)).astype(np.uint16)
        if lo < 16384:
            imgs[:, 10:20, 10:40] = black
        t = torch.from_numpy(imgs.view(np.int16)).cuda()
        before = chroma_smooth.KERNEL_LAUNCHES
        got = chroma_smooth.chroma_smooth_batch(t, method, black)
        assert chroma_smooth.KERNEL_LAUNCHES == before + 1
        want = chroma_smooth.chroma_smooth_batch_plain(t, method, black)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, h, w, black, lo)


@pytest.mark.cuda
def test_chroma_kernel_refuses_bad_input():
    _need_card()
    imgs = torch.zeros((2, 16, 24), dtype=torch.int16, device="cuda")
    with pytest.raises(TypeError):
        chroma_smooth.chroma_smooth_batch(imgs.to(torch.int32), 3, 2048)
    with pytest.raises(ValueError):
        chroma_smooth.chroma_smooth_batch(imgs[:, :, ::2], 3, 2048)
    with pytest.raises(ValueError):
        chroma_smooth.chroma_smooth_batch(imgs[:, :, :23], 5, 2048)
    with pytest.raises(ValueError):
        chroma_smooth.chroma_smooth_batch(imgs, 4, 2048)
    assert chroma_smooth.chroma_smooth_batch(imgs[:0], 3, 2048).shape == (0, 16, 24)


@pytest.mark.cuda
def test_flags_convert_on_card_matches_cpu(tmp_path):
    """The flags-on convert (deflicker, bad pixels, 3x3 chroma smoothing,
    stripes) writes the same DNGs and .CAL on the card as on the CPU, with
    one chroma kernel launch per batch."""
    _need_card()
    spec = synth.SynthSpec(width=320, height=96, frames=5)
    rng = np.random.default_rng(spec.seed)
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(spec.frames)]).astype(np.float64)
    gain = np.array([1.0, 1.0, 1.04, 0.985, 1.0, 1.01, 0.97, 1.0])[np.arange(spec.width) % 8]
    data = spec.black + (data - spec.black) * gain
    data[:, 20, 30], data[:, 9, 14] = 0, 16383
    data = np.clip(data, 0, 16383).astype(np.uint16)
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        before = chroma_smooth.KERNEL_LAUNCHES
        convert_clip(str(src), str(tmp_path / device / "out"), ProcessingConfig(
            device=device, batch_size=2, deflicker=3000, chroma_smooth=3, fix_stripes=True,
            fix_bad_pixels=1))
        assert chroma_smooth.KERNEL_LAUNCHES - before == (3 if device == "cuda" else 0)
        out = tmp_path / device / "out"
        tree = {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}
        tree["CAL"] = (tmp_path / device / "C.CAL").read_bytes()
        trees.append(tree)
    assert len(trees[0]) == 6 and trees[0] == trees[1]


def _pn_frames(rng, kind, b, h, w):
    """int32 frames for the blur: ``mixed`` full-range int16 pixels with a
    flat noisy half, ``flat`` noise of +-40 (every window 50 entries),
    ``jump`` green averages 4000 apart from cell to cell (every window one
    entry), ``edges`` steps of 3000 every 5 to 40 cells (window edges inside
    every run of pixels)."""
    if kind == "flat":
        return 3000 + rng.integers(-40, 40, (b, h, w)).astype(np.int32)
    if kind == "jump":
        return ((np.arange(w) // 2 % 2 * 4000) + rng.integers(-40, 40, (b, h, w))).astype(np.int32)
    if kind == "edges":
        level = np.searchsorted(np.cumsum(rng.integers(10, 80, w)), np.arange(w), side="right") % 2
        return (2000 + 3000 * level + rng.integers(-300, 300, (b, h, w))).astype(np.int32)
    x = rng.integers(-32768, 32768, (b, h, w)).astype(np.int32)
    x[:, :, : w // 2] = 3000 + rng.integers(-40, 40, (b, h, w // 2))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind, b, h, w", [
    ("mixed", 2, 1080, 1920),
    ("mixed", 1, 1078, 640),  # 1078 rows, no multiple of 4
    ("mixed", 2, 64, 124),    # below the window
    ("mixed", 2, 64, 128),    # at the window
    ("mixed", 1, 2, 2),
    ("flat", 2, 1080, 1920),
    ("jump", 1, 64, 1920),
    ("edges", 2, 270, 1920),
    ("flat", 1, 64, 124),
    ("edges", 1, 64, 128),
    ("flat", 2, 8, 2),
])
def test_pattern_noise_kernels_match_plain(kind, b, h, w):
    """Kernels #3 and #4 are bit-equal to the plain twin on every kind of
    window: full, one entry, edges inside runs, and widths of 2, 124 and
    128 px; the counting entry point gives the same frames."""
    _need_card()
    rng = np.random.default_rng(3 + h + w)
    sites = ((0, 0), (0, 1), (1, 0), (1, 1))
    t = torch.from_numpy(_pn_frames(rng, kind, b, h, w)).cuda()
    before = patternnoise_fused.KERNEL_LAUNCHES
    got = patternnoise_fused.blur_interleaved(t)
    assert patternnoise_fused.KERNEL_LAUNCHES == before + 1
    want = patternnoise_fused.blur_interleaved_plain(t)
    planes = [t[:, py::2, px::2].contiguous() for py, px in sites]
    got4 = patternnoise.edge_aware_blur(*planes)
    want4 = patternnoise.edge_aware_blur_plain(*planes)
    ops = torch.zeros(1, dtype=torch.int64, device="cuda")
    counted = torch.empty_like(t)
    assert _build.library("patternnoise").mlvfs_pn_blur_ops(
        t.data_ptr(), counted.data_ptr(), ops.data_ptr(), b, h, w, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want), (kind, b, h, w)
    assert torch.equal(counted, want) and int(ops) > 0, (kind, b, h, w)
    assert all(torch.equal(g, v) for g, v in zip(got4, want4)), (kind, b, h, w)


@pytest.mark.cuda
def test_pattern_noise_kernel_refuses_bad_input():
    _need_card()
    x = torch.zeros((2, 6, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        patternnoise_fused.blur_interleaved(x.to(torch.int16))
    with pytest.raises(ValueError):
        patternnoise_fused.blur_interleaved(x[:, :, :7])
    with pytest.raises(ValueError):
        patternnoise_fused.blur_interleaved(x.transpose(1, 2))
    with pytest.raises(ValueError):
        patternnoise.edge_aware_blur(x, x, x, x[:1])
    assert patternnoise_fused.blur_interleaved(x[:0]).shape == (0, 6, 8)


@pytest.mark.cuda
def test_preview_kernel_matches_plain():
    """Kernel #5 is bit-equal to its twin over the four dark-row phases,
    with over-white and below-shadow pixels, at heights 5, 6, 7 (below one
    32-row chunk of its ring), 70 and 1080 (not a multiple of it), and at
    widths that are not a multiple of its 128-column block, whose rows copy
    8 or 4 bytes at a time (300, 306) or plainly (97, odd)."""
    _need_card()
    rng = np.random.default_rng(4)
    for b, h, w in [(8, 1080, 1920), (4, 5, 96), (4, 6, 96), (4, 7, 300), (2, 70, 306), (2, 100, 97),
                    (3, 33, 1872)]:
        imgs = rng.integers(0, 1 << 14, (b, h, w)).astype(np.uint16)
        imgs[:, h // 4 : h // 2 + 1, : w // 3] = 15007
        imgs[:, h // 2 :, w // 2 :] = 5
        t = torch.from_numpy(imgs.view(np.int16)).cuda()
        a = torch.from_numpy(rng.uniform(0.05, 2.0, b).astype(np.float32)).cuda()
        bb = torch.from_numpy(rng.uniform(-20, 20, b).astype(np.float32)).cuda()
        shadow = torch.full((b,), 2948.0, device="cuda")
        drs = torch.arange(b, dtype=torch.int32, device="cuda") % 4
        before = dualiso.KERNEL_LAUNCHES
        got = dualiso.apply_preview(t, a, bb, shadow, drs, 2048, 15000)
        assert dualiso.KERNEL_LAUNCHES == before + 1
        want = dualiso.apply_preview_plain(t, a, bb, shadow, drs, 2048, 15000)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, h, w)
        cpu = dualiso.apply_preview(t.cpu(), a.cpu(), bb.cpu(), shadow.cpu(), drs.cpu(), 2048, 15000)
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(fix_pattern_noise=True),
    dict(dual_iso=1, fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True),
])
def test_pattern_noise_and_preview_convert_on_card_match_cpu(flags, tmp_path, monkeypatch):
    """--fix-pattern-noise, and --dual-iso-preview on an 800x600 clip whose
    third frame is not dual-ISO (a mixed batch) with bad pixels, 2x2 chroma
    smoothing and stripes, write the same DNGs and .CAL on the card as on
    the CPU; the kernels launch on the card only. The preview runs in both
    fit modes: the card's default (the device fit, whose kernel launches
    once per batch) against the CPU under MLVFS_TPU_PREVIEW_DEV=1, and the
    host fit (=0) on the card against the CPU's default."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=800, height=600, frames=5, dual_iso=3)
    rng = np.random.default_rng(6)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    data[2, 101, 200] = 16383
    modes = [(None, None)] if not flags.get("dual_iso") else [(None, "1"), ("0", None)]
    for card_mode, cpu_mode in modes:
        trees = []
        for device, mode in (("cuda", card_mode), ("cpu", cpu_mode)):
            if mode is None:
                monkeypatch.delenv("MLVFS_TPU_PREVIEW_DEV", raising=False)
            else:
                monkeypatch.setenv("MLVFS_TPU_PREVIEW_DEV", mode)
            src = tmp_path / f"{device}{mode}" / "C.MLV"
            src.parent.mkdir()
            synth.write_mlv(str(src), spec, frame_data=data)
            counters = (patternnoise_fused, dualiso, dualiso_preview_dev)
            before = [m.KERNEL_LAUNCHES for m in counters]
            convert_clip(str(src), str(src.parent / "out"),
                         ProcessingConfig(device=device, batch_size=2, **flags))
            launched = tuple(m.KERNEL_LAUNCHES - n for m, n in zip(counters, before))
            if flags.get("fix_pattern_noise"):
                want = (6, 0, 0)
            else:  # 3 batches, each holding a detected frame
                want = (0, 3, 3 if card_mode is None else 0)
            assert launched == (want if device == "cuda" else (0, 0, 0))
            out = src.parent / "out"
            tree = {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}
            cal = src.parent / "C.CAL"
            tree["CAL"] = cal.read_bytes() if cal.exists() else None
            trees.append(tree)
        assert len(trees[0]) == 6 and trees[0] == trees[1], (card_mode, cpu_mode)


def _fit_batches(rng):
    """(label, sorted samples (B, 4, L), real counts, median ranks, black,
    white, total) on the CPU: 1080p dual-ISO frames of the four dark-row
    phases, 640x192 dual, flat and single-ISO frames, an EOS M frame, a
    width whose stored counts fall short of the slices, frames whose greens
    sit below black where several of detect_phase's cases hold, and random
    sorted samples with long runs of one value."""
    import dataclasses

    def frames(w, h, kinds, seed):
        spec = synth.SynthSpec(width=w, height=h, frames=len(kinds), dual_iso=3, seed=seed)
        g = np.random.default_rng(seed)
        out = []
        for k in kinds:
            if k == "flat":
                out.append(np.full((h, w), spec.black + 7, np.uint16))
            else:
                out.append(synth.make_frame_data(dataclasses.replace(
                    spec, dual_iso=0 if k == "plain" else 3, dual_iso_phase=0 if k == "plain" else k), g))
        padded, real, stored = dualiso_preview_dev.sorted_phases(
            torch.from_numpy(np.stack(out).view(np.int16)), spec.white)
        return padded, real, dualiso_preview_dev.median_ranks(real, stored), spec.black, spec.white, stored[0]

    yield ("1080p", *frames(1920, 1080, [0, 1, 2, 3, 0, 1, 2, 3], 1))
    yield ("640x192 mixed", *frames(640, 192, [0, "flat", "plain"], 5))
    yield ("EOS M", *frames(1872, 1060, [0, "plain"], 3))
    yield ("1030 wide", *frames(1030, 500, [1, 2], 7))
    for medians in ((-15, -10, -20, -15), (-12, -5, -10, -20)):
        # greens a little below black: c1 (or c2) and c3 hold, c0 not, and
        # the first case picks the hi phase (0, where c3 picks 2)
        black, white = 2048, 15000
        base = black + np.asarray(medians)[np.arange(600) % 4][:, None]
        imgs = np.stack([(base + rng.integers(-k, k + 1, (600, 800))).astype(np.uint16) for k in (4, 9)])
        padded, real, stored = dualiso_preview_dev.sorted_phases(torch.from_numpy(imgs.view(np.int16)), white)
        yield (f"below black {medians}", padded, real, dualiso_preview_dev.median_ranks(real, stored),
               black, white, stored[0])
    white, length = 15000, 9000
    padded = np.full((12, 4, length), white + 1, np.int32)
    real = [length, length - 1, length - 3, length - 2]
    for f in range(12):
        for q in range(4):
            v = np.clip(rng.normal(rng.integers(0, white // 2), rng.choice([1, 300, 3000]), real[q]), 0, white)
            v = v.astype(np.int32)
            if f % 3 == 0:
                v[: real[q] // 2] = v[0]
            padded[f, q, : real[q]] = np.sort(v)
    yield ("random sorted", torch.from_numpy(padded), real, [n // 2 for n in real], 2048, white, real[0] - 1)


@pytest.mark.cuda
def test_preview_fit_kernel_matches_plain():
    """The preview fit kernel is bit-equal to its twin on the card (and to
    the twin on the CPU): ok, a, b, shadow, dark-row start, one launch a
    call."""
    _need_card()
    rng = np.random.default_rng(8)
    for label, padded, real, ranks, black, white, total in _fit_batches(rng):
        dev = padded.cuda()
        before = dualiso_preview_dev.KERNEL_LAUNCHES
        got = dualiso_preview_dev.fit_sorted(dev, real, ranks, black, white, total)
        assert dualiso_preview_dev.KERNEL_LAUNCHES == before + 1
        want = dualiso_preview_dev.fit_sorted_plain(dev, real, ranks, black, white, total)
        cpu = dualiso_preview_dev.fit_sorted_plain(padded, real, ranks, black, white, total)
        torch.cuda.synchronize()
        for g, w, c in zip(got, want, cpu):
            assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g.cpu(), c), label
            if g.dtype == torch.float32:  # signed zeros too
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), label


@pytest.mark.cuda
def test_stripes_batch_cal_on_card_matches_cpu(tmp_path):
    """The whole-batch stripe calibration gives the same gains on the card
    as on the CPU (a 1080p batch of 16, and the x4 levels), and a
    --stripes --stripes-batch-cal convert writes the same DNGs and .CAL."""
    _need_card()
    rng = np.random.default_rng(9)
    gain = np.array([1.0, 1.0, 1.04, 0.985, 1.0, 1.01, 0.97, 1.0])
    for black, white in ((2048, 15000), (8192, 60000)):
        base = rng.integers(black - 30, int(black + (white - black) / 1.4), (16, 1080, 1920))
        imgs = np.clip(black + (base - black) * gain[np.arange(1920) % 8], 0, 65535).astype(np.uint16)
        t = torch.from_numpy(imgs.view(np.int16))
        got = stripes.calibrate_batch_device(t.cuda(), black, white, 1920 * 1080 * 14 // 8)
        want = stripes.calibrate_batch_device(t, black, white, 1920 * 1080 * 14 // 8)
        assert torch.equal(got[0].cpu(), want[0]) and bool(got[1]) == bool(want[1]) and bool(want[1])
    spec = synth.SynthSpec(width=640, height=192, frames=5)
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(spec.frames)]).astype(np.float64)
    data = np.clip(spec.black + (data - spec.black) * gain[np.arange(640) % 8], 0, 16383).astype(np.uint16)
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        out = tmp_path / device / "out"
        convert_clip(str(src), str(out), ProcessingConfig(
            device=device, batch_size=4, fix_stripes=True, stripes_batch_cal=True))
        tree = {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}
        tree["CAL"] = (tmp_path / device / "C.CAL").read_bytes()
        trees.append(tree)
    assert len(trees[0]) == 6 and trees[0] == trees[1]


@pytest.mark.cuda
def test_alias_kernel_matches_plain():
    """Kernel #7 is bit-equal to its twin at 1080p and at the small, odd and
    multi-tile sizes (no inner pixels below 13 px, no cells at 4 px, sizes
    not a multiple of its 64 x 64 tile), skip densities 0, 1/2, 0.9 (the
    main path's low work) and 1, with one working pixel at a tile's corner,
    whole tiles without work, and on a sub-frame one row down (GBRG)."""
    _need_card()
    rng = np.random.default_rng(7)
    for b, h, w in [(4, 1080, 1920), (3, 5, 9), (3, 12, 16), (1, 13, 13), (2, 64, 37), (2, 300, 41),
                    (1, 4, 4), (2, 129, 130)]:
        for density in (0.0, 0.5, 0.9, 1.0):
            a = torch.from_numpy(rng.integers(0, 65531, (b, h, w), dtype=np.int32)).cuda()
            skip = torch.from_numpy(rng.random((b, h, w)) < density).cuda()
            before = alias.KERNEL_LAUNCHES
            got = alias.alias_filter(a, skip)
            assert alias.KERNEL_LAUNCHES == before + 1
            want = alias.alias_filter_plain(a, skip)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (b, h, w, density)
    a = torch.from_numpy(rng.integers(0, 65531, (3, 200, 300), dtype=np.int32)).cuda()
    skip = torch.ones((3, 200, 300), dtype=torch.bool, device="cuda")
    skip[0, 64, 64] = skip[1, 127, 191] = False  # a tile's first and last pixel
    skip[2, 70:90, 100:180] = False
    assert torch.equal(alias.alias_filter(a, skip), alias.alias_filter_plain(a, skip))
    a = torch.from_numpy(rng.integers(0, 65531, (2, 101, 64), dtype=np.int32)).cuda()
    skip = torch.from_numpy(rng.random((2, 101, 64)) < 0.3).cuda()
    assert torch.equal(alias.alias_filter(a[:, 1:], skip[:, 1:]),
                       alias.alias_filter_plain(a[:, 1:], skip[:, 1:]))
    with pytest.raises(TypeError):
        alias.alias_filter(a.float(), skip)
    with pytest.raises(ValueError):
        alias.alias_filter(a[:, :, 1:], skip[:, :, 1:])


@pytest.mark.cuda
def test_traced_convert_on_a_second_card(tmp_path, monkeypatch):
    """``convert --device cuda:1 -v`` with cuda:0 current: every CUDA event,
    the tracer's included, is recorded on a stream of the converting card,
    every device span gets its device time, and the DNGs equal the
    untraced conversion's."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    from mlvfs_tpu_torch.utils import metrics

    seen = []

    class Event(torch.cuda.Event):
        def record(self, stream=None):
            seen.append((stream or torch.cuda.current_stream()).device)
            return super().record(stream)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    torch.cuda.set_device(0)
    src = tmp_path / "DI.MLV"
    synth.write_mlv(str(src), width=640, height=192, frames=4, dual_iso=3)
    cfg = ProcessingConfig(device="cuda:1", batch_size=2, dual_iso=2, hdr_interpolation_method=1)
    trees = []
    for traced in (False, True):
        out = tmp_path / f"out{int(traced)}"
        metrics.reset()
        if traced:
            metrics.enable(device=cfg.device)
        try:
            convert_clip(str(src), str(out), cfg)
        finally:
            spans = metrics.spans()
            metrics.disable()
            metrics.reset()
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert trees[0] == trees[1] and len(trees[0]) == 4
    device = [s for s in spans if s.kind == metrics.DEVICE]
    assert {"decode", "process", "recon", "ev"} <= {s.name for s in device}
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in device)
    assert seen and set(seen) == {torch.device("cuda", 1)}
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_dual_iso_convert_on_card_matches_cpu(tmp_path):
    """--dual-iso --mean23 with --bad-pix --cs2x2 --stripes on a clip whose
    third frame is single-ISO: kernel #7 launches once per batch that holds
    a converted frame; the frame that is not converted and every DNG header
    are byte-identical to the CPU's, converted frames within PSNR 90 dB and
    3 % of pixels (the float32 stages round differently on the card)."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=640, height=192, frames=5, dual_iso=3)
    rng = np.random.default_rng(8)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        before = alias.KERNEL_LAUNCHES
        convert_clip(str(src), str(tmp_path / device / "out"), ProcessingConfig(
            device=device, batch_size=2, dual_iso=2, hdr_interpolation_method=1, fix_bad_pixels=1,
            chroma_smooth=2, fix_stripes=True))
        assert alias.KERNEL_LAUNCHES - before == (3 if device == "cuda" else 0)
        out = tmp_path / device / "out"
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert list(trees[0]) == list(trees[1]) and len(trees[0]) == 5
    for i, name in enumerate(trees[0]):
        card, cpu = trees[0][name], trees[1][name]
        assert card[:65536] == cpu[:65536], name
        a = np.frombuffer(card, "<u2", offset=65536).astype(np.float64)
        b = np.frombuffer(cpu, "<u2", offset=65536).astype(np.float64)
        if i == 2:
            assert card == cpu
        mse = np.mean((a - b) ** 2)
        assert mse == 0 or 10 * np.log10(65535.0 ** 2 / mse) >= 90, name
        assert (a != b).mean() <= 0.03, name


def _edge_inputs(rng, b, h, w, density):
    """EV planes with flat areas (where directions tie), row signs of the
    four dark-row phases, a restricted map of the given density."""
    ev = lambda: rng.integers(-2 * 32768, 14 * 32768, (b, h, w), dtype=np.int32)  # noqa: E731
    evgray, ewa, ewb = ev(), ev(), ev()
    evgray[:, h // 3 :, : w // 2] //= 64
    ys = np.arange(h)
    s = np.stack([np.where((((ys - i) % 4) >= 2) == (((ys + 1 - i) % 4) >= 2), -1, 1)
                  for i in range(b)]).astype(np.int32)
    restricted = rng.random((b, h, w)) < density
    return [torch.from_numpy(v) for v in (evgray, ewa, ewb, s, restricted)]


@pytest.mark.cuda
def test_hdr_check_on_card_matches_cpu():
    """hdr_check decides on the card as on the CPU, with the same sums to the
    bit, on frames whose means sit just below and just above 0.5 and on
    dual-ISO and single-ISO frames."""
    _need_card()
    black, white = 2048, 15000
    near, _ = hdr_threshold_frames(black, white)
    spec = synth.SynthSpec(width=256, height=192, frames=4, dual_iso=3)
    rng = np.random.default_rng(8)
    plain = [synth.make_frame_data(synth.SynthSpec(width=256, height=192, frames=1), rng) for _ in range(2)]
    mixed = np.stack([synth.make_frame_data(spec, rng) for _ in range(2)] + plain)
    for frames in (near, mixed):
        t = torch.from_numpy(frames.view(np.int16))
        diff, _ = dualiso_full.hdr_check_terms(t, black, white)
        card, _ = dualiso_full.hdr_check_terms(t.cuda(), black, white)
        assert torch.equal(dualiso_full.hdr_check_sums(card).cpu(), dualiso_full.hdr_check_sums(diff))
        got = dualiso_full.hdr_check_batch(t.cuda(), black, white)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), dualiso_full.hdr_check_batch(t, black, white))
    assert dualiso_full.hdr_check_batch(torch.from_numpy(near.view(np.int16)).cuda(), black, white).tolist() == [
        False, True]


@pytest.mark.cuda
def test_amaze_edge_kernel_matches_plain():
    """Kernel #6 is bit-equal to its twin (and to the CPU) at 1080p and at
    odd, even, short and tall sizes (not a multiple of its 8 x 128 tile),
    restricted densities 0, 1/2, 0.96 (the main path's low work) and 1, in
    each of its two scoring forms, with one scored pixel at a tile's corner
    and whole tiles without work."""
    _need_card()
    rng = np.random.default_rng(9)
    for b, h, w in [(4, 1080, 1920), (3, 300, 41), (3, 64, 40), (3, 11, 12), (2, 5, 7), (2, 61, 250)]:
        for density in (0.0, 0.5, 0.96, 1.0):
            cpu = _edge_inputs(rng, b, h, w, density)
            args = [v.cuda() for v in cpu]
            before = amaze_edge.KERNEL_LAUNCHES
            got = amaze_edge.edge_pick(*args)
            assert amaze_edge.KERNEL_LAUNCHES == before + 1
            want = amaze_edge.edge_pick_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (b, h, w, density)
            assert torch.equal(got.cpu(), amaze_edge.edge_pick(*cpu)), (b, h, w, density)
            for per_row in (0, 128):  # every tile row by row; every tile pixel by pixel
                assert torch.equal(amaze_edge._edge_pick_cuda(*args, direct_per_row=per_row), want), \
                    (b, h, w, density, per_row)
    cpu = _edge_inputs(rng, 2, 40, 300, 1.0)
    cpu[4][0, 8, 128] = cpu[4][1, 15, 255] = False  # a tile's first and last pixel
    cpu[4][1, 20:30, 10:60] = False
    args = [v.cuda() for v in cpu]
    want = amaze_edge.edge_pick_plain(*args)
    for per_row in (amaze_edge.DIRECT_PER_ROW, 0, 128):
        assert torch.equal(amaze_edge._edge_pick_cuda(*args, direct_per_row=per_row), want), per_row


@pytest.mark.cuda
def test_amaze_raster_pass_kernels_match_plain():
    """Kernel #10's three passes are bit-equal to their twins on the 1080p
    padded frame (9 tiles), two tiles, one short tile, a frame whose last
    tile reads rows below it, planes of 4 and 6 rows (fewer than refine's
    and dilate's rings hold), rows that are not 16-B aligned (wp 34, 38,
    50), the widest plane dilate's ring takes (wp 2048: 32 words of cells)
    and the next (2050: dilate's row walk beside refine's ring), the widest
    refine's ring takes (7264) and a plane too wide for both rings (wp
    7800, #9's row walks)."""
    _need_card()
    rng = np.random.default_rng(10)
    for b, hp, wp in [(2, 1112, 1952), (2, 224, 192), (1, 40, 34), (1, 290, 50), (1, 4, 34), (2, 6, 38),
                      (1, 40, 2048), (1, 40, 2050), (1, 40, 7264), (1, 40, 7800)]:
        wt = torch.from_numpy(rng.random((b, hp, wp), np.float32)).cuda()
        nyq = torch.from_numpy((rng.random((b, hp, wp)) > 0.6).astype(np.int32)).cuda()
        D = torch.from_numpy(rng.normal(0, 0.1, (b, hp, wp)).astype(np.float32)).cuda()
        before = amaze_scans.KERNEL_LAUNCHES
        got = [amaze_scans.refine(wt), amaze_scans.dilate(nyq), amaze_scans.chroma(D, 0),
               amaze_scans.chroma(D, 1)]
        assert amaze_scans.KERNEL_LAUNCHES == before + 4
        want = [amaze_core.refine_plain(wt), amaze_core.dilate_plain(nyq), amaze_core.chroma_plain(D, 0),
                amaze_core.chroma_plain(D, 1)]
        torch.cuda.synchronize()
        for name, g, v in zip(("refine", "dilate", "chroma 0", "chroma 1"), got, want):
            assert torch.equal(g, v), (name, b, hp, wp, float((g.double() - v.double()).abs().max()))


def _mosaic(rng, b, h, w, straddle=False):
    """RGGB mosaics on the 20-bit scale the reconstruction hands AMaZE: a
    smooth scene with edges and noise, and a clipped block; ``straddle``
    adds one-pixel checkerboards (Nyquist cells) over padded rows and
    columns 24..39, across the edges of kernel #8's 32 x 32 tiles."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    gains = np.array([[0.85, 1.0], [1.0, 0.55]])[y.astype(int) % 2, x.astype(int) % 2]
    out = []
    for i in range(b):
        base = 9000 + 6000 * np.sin(x / (7.0 + i)) * np.cos(y / 11.0) + 20000 * ((x + 2 * y) % 97 < 18)
        img = base * gains + rng.normal(0, 60, (h, w))
        img[h // 3 : h // 2, w // 4 : w // 2] = 900000
        if straddle:
            img[8:24, :] += 300000 * ((x + y) % 2)[8:24, :]
            img[:, 8:24] += 300000 * ((x + y) % 2)[:, 8:24]
        out.append(np.clip(img, 0, (1 << 20) - 1))
    return torch.from_numpy(np.stack(out).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w, straddle", [
    (2, 1080, 1920, False),
    (1, 160, 224, False),   # two tiles of the raster passes
    (2, 17, 18, False),     # the smallest frame, narrower than a tile and its aprons
    (2, 33, 46, False),
    (1, 300, 50, False),
    (16, 1060, 1872, False),  # EOS M at B=16: 1904 padded columns, no multiple of a tile
    (2, 160, 224, True),    # Nyquist cells across a tile edge
    (1, 96, 7300, False),   # past both rings of #10: its row walks between the groups
])
def test_amaze_demosaic_kernel_matches_plain(b, h, w, straddle):
    """Kernel #8's stage groups with #10's passes between them are bit-equal
    to the plain twin at the shapes that cross #8's tile edges; each call
    adds one to #8's counter and five to #10's."""
    _need_card()
    rng = np.random.default_rng(11 + h + w)
    raw = _mosaic(rng, b, h, w, straddle).cuda()
    before = (amaze_core.KERNEL_LAUNCHES, amaze_scans.KERNEL_LAUNCHES)
    got = amaze_core.amaze_demosaic(raw)
    assert (amaze_core.KERNEL_LAUNCHES, amaze_scans.KERNEL_LAUNCHES) == (before[0] + 1, before[1] + 5)
    want = amaze_core.amaze_demosaic_plain(raw)
    torch.cuda.synchronize()
    for g, v in zip(got, want):
        assert g.shape == (b, h, w) and bool(torch.isfinite(g).all())
        assert torch.equal(g, v), (b, h, w, float((g - v).abs().max()))
    with pytest.raises(ValueError):
        amaze_core.amaze_demosaic(raw[:, :, 1:])


@pytest.mark.cuda
def test_amaze_mega_kernel_matches_plain_and_split(monkeypatch):
    """Kernel #9 is bit-equal to the plain twin and to #8 + #10 (split mode)
    at 1080p, at two tiles, at three tiles, at odd heights, at the smallest
    frame, past the dilate ring's width (2,132 padded columns: its row walk)
    and past the refine ring's (7,332: both row walks), and on a batch of
    small frames whose group and pass items are more than the grid's blocks
    and no multiple of them, so that blocks take a second item and not all
    do; each call adds one to MEGA_LAUNCHES and nothing to #8's or #10's
    counters."""
    _need_card()
    rng = np.random.default_rng(13)
    shapes = [(2, 1080, 1920), (1, 160, 224), (3, 300, 50), (2, 33, 46), (1, 17, 18), (1, 160, 2100),
              (1, 96, 7300), (270, 40, 64)]
    plan = amaze_core.mega_plan(40, 64)
    grid = plan["blocks_per_sm"] * plan["sms"]
    hp, wp = 40 + 2 * amaze_core.PAD, 64 + 2 * amaze_core.PAD
    items = (270 * -(-hp // 32) * -(-wp // 32), 270 * amaze_core.n_tiles(hp))  # group tiles, pass tiles
    assert all(n > grid and n % grid for n in items), (items, grid)
    assert not amaze_core.mega_plan(160, 2100)["dilate_ring"]
    assert not amaze_core.mega_plan(96, 7300)["refine_ring"] and amaze_core.mega_plan(1080, 1920)["refine_ring"]
    for b, h, w in shapes:
        raw = _mosaic(rng, b, h, w).cuda()
        monkeypatch.setenv(amaze_core.MODE_ENV, "split")
        split = amaze_core.amaze_demosaic(raw)
        monkeypatch.setenv(amaze_core.MODE_ENV, "mega")
        before = (amaze_core.MEGA_LAUNCHES, amaze_core.KERNEL_LAUNCHES, amaze_scans.KERNEL_LAUNCHES)
        got = amaze_core.amaze_demosaic(raw)
        assert (amaze_core.MEGA_LAUNCHES, amaze_core.KERNEL_LAUNCHES, amaze_scans.KERNEL_LAUNCHES) == (
            before[0] + 1, before[1], before[2])
        want = amaze_core.amaze_demosaic_plain(raw)
        torch.cuda.synchronize()
        for g, s, v in zip(got, split, want):
            assert g.shape == (b, h, w) and bool(torch.isfinite(g).all())
            assert torch.equal(g, v), (b, h, w, float((g - v).abs().max()))
            assert torch.equal(g, s), (b, h, w, float((g - s).abs().max()))
    assert all(o.shape == (0, 20, 20) for o in amaze_core.amaze_demosaic(torch.zeros((0, 20, 20), device="cuda")))
    with pytest.raises(ValueError):
        amaze_core.amaze_demosaic(raw[:, :16, :])


@pytest.mark.cuda
def test_amaze_mega_step_stamps():
    """With stamps, kernel #9 gives the same bits and a positive time for
    each of its ten steps, in MEGA_STEPS order, summing to no more than the
    call's time by CUDA events."""
    _need_card()
    raw = _mosaic(np.random.default_rng(15), 2, 300, 224).cuda()
    want = amaze_core.amaze_demosaic_plain(raw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got, steps = amaze_core.amaze_demosaic_mega_steps(raw)
    end.record()
    torch.cuda.synchronize()
    assert list(steps) == list(amaze_core.MEGA_STEPS)
    assert all(ms > 0 for ms in steps.values()), steps
    assert sum(steps.values()) <= start.elapsed_time(end)
    assert all(torch.equal(g, v) for g, v in zip(got, want))


@pytest.mark.cuda
def test_amaze_mega_entry_refuses_bad_shape():
    """The C entry refuses a frame it cannot run (16 rows, under the reflect
    pad's 17; 65,538 padded columns, past its 65,536) with a CUDA error
    code, on which the wrapper raises."""
    _need_card()
    lib = _build.library("amaze_mega")
    x = torch.zeros((1, 16, 18), device="cuda")
    ws = torch.zeros((len(amaze_core.SPLIT_PLANES), 1, 48, 50), device="cuda")  # #9's workspace
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.mlvfs_amaze_mega(x.data_ptr(), ws.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                1, 16, 18, 1, amaze_core.INV_65535, None, stream) != 0
    with pytest.raises(RuntimeError):
        amaze_core._amaze_demosaic_mega_cuda(torch.zeros((1, 17, 65506), device="cuda"))


@pytest.mark.cuda
def test_amaze_frame_passes_match_plain():
    """Kernel #11's frame-level entry points are bit-equal to their twins on
    2-D and batched planes (the 1080p padded frame, two tiles, a 1920-wide
    two-tile plane), dilate on float32 and int32 cells; each call adds one to
    FRAME_LAUNCHES (chroma_frame's two planes are one launch) and nothing to
    #10's counter."""
    _need_card()
    rng = np.random.default_rng(14)
    for shape in [(2, 1112, 1952), (224, 192), (1, 320, 1920)]:
        wt = torch.from_numpy(rng.random(shape, np.float32)).cuda()
        nyq = torch.from_numpy((rng.random(shape) > 0.6).astype(np.int32)).cuda()
        D0 = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)).cuda()
        D1 = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)).cuda()
        before = (amaze_scans.FRAME_LAUNCHES, amaze_scans.KERNEL_LAUNCHES)
        got = [amaze_scans.refine_frame(wt), amaze_scans.dilate_frame(nyq),
               amaze_scans.dilate_frame(nyq.float()), *amaze_scans.chroma_frame(D0, D1)]
        assert (amaze_scans.FRAME_LAUNCHES, amaze_scans.KERNEL_LAUNCHES) == (before[0] + 4, before[1])
        batched = [t if t.dim() == 3 else t[None] for t in (wt, nyq, D0, D1)]
        want = [amaze_core.refine_plain(batched[0]), amaze_core.dilate_plain(batched[1]),
                amaze_core.dilate_plain(batched[1]).float(), amaze_core.chroma_plain(batched[2], 1),
                amaze_core.chroma_plain(batched[3], 0)]
        torch.cuda.synchronize()
        for name, g, v in zip(("refine", "dilate", "dilate f32", "chroma 0", "chroma 1"), got, want):
            assert g.shape == shape and g.dtype == v.dtype, (name, shape)
            assert torch.equal(g, v.reshape(shape)), (name, shape)


@pytest.mark.cuda
def test_dual_iso_amaze_edge_convert_on_card_matches_cpu(tmp_path):
    """--dual-iso (amaze-edge) with --bad-pix --cs2x2 --stripes on a clip
    whose third frame is single-ISO: per batch that holds a converted frame
    #6, #8 and #7 launch once and #10 five times; headers and the frame that
    is not converted equal the CPU's, converted frames within PSNR 90 dB and
    3 % of pixels."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=640, height=192, frames=5, dual_iso=3)
    rng = np.random.default_rng(12)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    counters = (amaze_edge, amaze_core, amaze_scans, alias)
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        before = [m.KERNEL_LAUNCHES for m in counters]
        convert_clip(str(src), str(tmp_path / device / "out"), ProcessingConfig(
            device=device, batch_size=2, dual_iso=2, fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True))
        launched = [m.KERNEL_LAUNCHES - n for m, n in zip(counters, before)]
        assert launched == ([3, 3, 15, 3] if device == "cuda" else [0, 0, 0, 0])
        out = tmp_path / device / "out"
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert list(trees[0]) == list(trees[1]) and len(trees[0]) == 5
    for i, name in enumerate(trees[0]):
        card, cpu = trees[0][name], trees[1][name]
        assert card[:65536] == cpu[:65536], name
        a = np.frombuffer(card, "<u2", offset=65536).astype(np.float64)
        b = np.frombuffer(cpu, "<u2", offset=65536).astype(np.float64)
        if i == 2:
            assert card == cpu
        mse = np.mean((a - b) ** 2)
        assert mse == 0 or 10 * np.log10(65535.0 ** 2 / mse) >= 90, name
        assert (a != b).mean() <= 0.03, name


@pytest.mark.cuda
def test_dual_iso_amaze_edge_mega_convert_on_card_matches_split(tmp_path, monkeypatch):
    """--dual-iso (amaze-edge) with MLVFS_AMAZE_PALLAS_MODE=mega writes the
    split mode's DNGs byte for byte: per batch that holds a converted frame
    #9 launches once and #8 and #10 not at all."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=640, height=192, frames=5, dual_iso=3)
    rng = np.random.default_rng(15)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    src = tmp_path / "C.MLV"
    synth.write_mlv(str(src), spec, frame_data=data)
    trees = []
    for mode in ("split", "mega"):
        monkeypatch.setenv(amaze_core.MODE_ENV, mode)
        before = (amaze_core.MEGA_LAUNCHES, amaze_core.KERNEL_LAUNCHES, amaze_scans.KERNEL_LAUNCHES)
        out = tmp_path / mode
        convert_clip(str(src), str(out), ProcessingConfig(device="cuda", batch_size=2, dual_iso=2,
                                                          use_sidecar_idx=False))
        launched = (amaze_core.MEGA_LAUNCHES - before[0], amaze_core.KERNEL_LAUNCHES - before[1],
                    amaze_scans.KERNEL_LAUNCHES - before[2])
        assert launched == ((0, 3, 15) if mode == "split" else (3, 0, 0))
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert len(trees[0]) == 5 and trees[0] == trees[1]


def _same_values(a, b):
    """Equal dtype, shape and bits; float NaNs compare as NaN (the card's
    arithmetic NaN and the CPU's carry different payloads)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.cpu(), b.cpu()
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))


def _ev_float_sweep():
    """Every 4099th float32 bit pattern of both signs (subnormals included)
    and the specials: +-0, +-inf, NaN, the smallest subnormal and normal,
    exp's clamps and 2^n's edges."""
    bits = np.arange(0, 1 << 32, 4099, dtype=np.int64)
    xs = ((bits + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32).view(np.float32)
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45, 1e-40, 2.0 ** -126, 1.0,
                     2.0, 88.8, 88.7, -104.0, -103.9, 127.9, 128.0, -126.0, -150.0], np.float32)
    return torch.from_numpy(np.concatenate([xs, spec]))


def _fma_ties(rng, n):
    """(x, y, z) whose exact x * y + z lies just inside, or exactly on, a
    midpoint of z's float32 neighbours: z with an odd last bit, x * y = half
    an ulp of z times (1 - 2^-46) or exactly. Rounding x * y + z in float64
    first lands on the midpoint, and round-to-even then picks the wrong
    neighbour for half of them."""
    e = rng.integers(-100, 100, n)
    z = np.ldexp((rng.integers(1 << 23, 1 << 24, n) | 1).astype(np.float64), e - 23) * rng.choice([-1.0, 1.0], n)
    x = 1.0 + rng.choice([-2.0 ** -24, 0.0, 2.0 ** -23], n)
    y = np.ldexp(1.0, e - 24) * rng.choice([-1.0, 1.0], n) * np.where(
        x > 1, 1 - 2.0 ** -23, np.where(x < 1, 1 + 2.0 ** -23, 1.0))
    return [torch.from_numpy(v.astype(np.float32)) for v in (x, y, z)]


def _ev_cases(name):
    """[(args on the CPU, label)] of one EV entry: the inputs its card test
    holds bit-equal."""
    evr = 32768
    if name in ("raw2ev20", "fullres_weight"):
        every = torch.arange(1 << 20, dtype=torch.int32).reshape(16, 256, 256)  # every 20-bit input
        return [((every, black20), f"black20 {black20}") for black20 in (2048 * 64, 2047 * 64 + 17)]
    if name == "ev2raw20":
        ev = torch.cat([torch.arange(-10 * evr, 14 * evr, dtype=torch.int32),
                        torch.arange(-(1 << 22), -10 * evr, 997, dtype=torch.int32),  # the tails
                        torch.arange(14 * evr, 1 << 22, 997, dtype=torch.int32),
                        torch.tensor([-(1 << 31), (1 << 31) - 1], dtype=torch.int32)])
        cases = []
        for white20 in (15000 * 64, 640000):
            white_ev = dualiso_full.white_ev_of(2048 * 64, white20)
            cases.append(((ev, 2048 * 64, white20, white_ev), f"white20 {white20}"))
        return cases
    xs = _ev_float_sweep()
    if name != "log2_add":
        return [((xs,), "sweep")]
    frames = xs[: 16 * 256 * 255].reshape(16, 256, 255).contiguous()
    rng = np.random.default_rng(11)
    return [((xs, -4.0), "by value"),
            ((xs, torch.from_numpy(rng.standard_normal(xs.shape[0]).astype(np.float32))), "full plane"),
            ((frames, torch.from_numpy(rng.standard_normal((16, 1, 1)).astype(np.float32))), "per frame")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["log_f32", "log2_f32", "log2_add", "exp2_f32", "raw2ev20", "ev2raw20",
                                  "fullres_weight"])
def test_ev_kernel_matches_plain(name):
    """Each EV transform's kernel entry (csrc/evmath.cu) is bit-equal to its
    plain twin on the card and to the twin on the CPU: raw2ev20 and the
    fullres curve on every 20-bit input at the cell's black and one off the
    64-grid, ev2raw20 on every EV of [-10, 14) * EVR and both tails at two
    whites, the logs and exps on a float32 sweep with subnormals, +-0,
    negatives, +-inf and NaN. One launch a call."""
    _need_card()
    fn, plain = getattr(evmath, name), getattr(evmath, name + "_plain")
    for args, label in _ev_cases(name):
        card = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        before, counted = evmath.KERNEL_LAUNCHES, metrics.counters().get("ev.launches", 0)
        got = fn(*card)
        assert evmath.KERNEL_LAUNCHES == before + 1 and metrics.counters()["ev.launches"] == counted + 1
        want = plain(*card)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and _same_values(got, want), (name, label)
        assert _same_values(got, plain(*args)), (name, label, "the CPU twin")


@pytest.mark.cuda
def test_ev_fma_kernel_matches_plain_in_every_form():
    """The fma entry is bit-equal to the twin (on the card and on the CPU)
    on random triples over a wide exponent range, constructed midpoint ties
    and subnormal results, and with every operand form its callers pass:
    full planes, per-frame (B, 1, 1) vectors, Python floats, 0-dim host
    tensors, the analysis' (B, 1) x (1, S) + (B, 1) and (1, N) x (S, 1) +
    (S, 1) products, and full planes that start off 16-byte boundaries.
    Results stay below 2^128: past it the twin's float64 emulation gives
    the largest float where the sum it rounds is inexact, and the kernel
    the IEEE infinity."""
    _need_card()
    rng = np.random.default_rng(12)

    def r(*shape):
        v = rng.standard_normal(shape) * 10.0 ** rng.integers(-18, 18, shape)
        return torch.from_numpy(v.astype(np.float32))

    b, h, w = 16, 108, 192
    full = [r(b, h, w) for _ in range(3)]
    frame = r(b, 1, 1)
    tx, ty, tz = _fma_ties(rng, 1 << 20)
    sub = [torch.from_numpy((rng.random(1 << 20) * 2 - 1).astype(np.float32)) * s
           for s in (2.0 ** -70, 2.0 ** -70, 2.0 ** -130)]
    bmed, a_cand, hb, bc = r(b), r(3000), r(b, 4621), r(b, 3000)
    odd = r(b * h * w + 3)
    cases = {
        "random": full, "ties": [tx, ty, tz], "subnormal": sub,
        "frame, frame, full": [frame, r(b, 1, 1), full[2]],
        "full, frame, value": [full[0], frame, 0.5],
        "value, full, host 0-dim": [-0.075, full[1], torch.tensor(1.5)],
        "full, full, frame": [full[0], full[1], frame],
        "(B,1) x (1,S) + (B,1)": [-bmed[:, None], a_cand[None, :], bmed[:, None]],
        "(1,N) x (S,1) + (S,1)": [hb[3][None, :], a_cand[:, None], bc[3][:, None]],
        "short": [r(7), r(7), r(7)],
    }
    offsets = [(1, 1 + b * h * w), (2, 2 + b * h * w), (3, 3 + b * h * w)]
    odd_card = odd.cuda()
    for label, args in [*cases.items(), ("off 16 B", [odd[i:j].view(b, h, w) for i, j in offsets])]:
        card = [a.cuda() if isinstance(a, torch.Tensor) and a.dim() else a for a in args]
        if label == "off 16 B":  # views of one card buffer, each starting 4, 8 or 12 B past 16
            card = [odd_card[i:j].view(b, h, w) for i, j in offsets]
        before = evmath.KERNEL_LAUNCHES
        got = evmath.fma(*card)
        assert evmath.KERNEL_LAUNCHES == before + 1, label
        want = evmath.fma_plain(*card)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and _same_values(got, want), label
        assert _same_values(got, evmath.fma_plain(*args)), (label, "the CPU twin")
    naive = (tx.double() * ty.double() + tz.double()).float()
    assert (naive != evmath.fma(tx.cuda(), ty.cuda(), tz.cuda()).cpu()).any()  # the ties bite
    big = torch.tensor([1.8903134e19], device="cuda")
    assert evmath.fma(big, big, -1.0).item() == float("inf")  # 3.57e38 rounds up past the largest float


@pytest.mark.cuda
def test_ev_kernels_refuse_bad_input():
    """A wrong dtype, a CPU tensor beside a CUDA one, a non-contiguous full
    plane and an x smaller than log2_add's result raise before any launch;
    an empty input launches nothing."""
    _need_card()
    x = torch.ones((4, 6, 8), device="cuda")
    before = evmath.KERNEL_LAUNCHES
    for call, error in [
        (lambda: evmath.log2_f32(x.double()), TypeError),
        (lambda: evmath.raw2ev20(x, 2048 * 64), TypeError),
        (lambda: evmath.fma(x, x.to(torch.float16), 1.0), TypeError),
        (lambda: evmath.fma(x, torch.ones((4, 6, 8)), 1.0), ValueError),
        (lambda: evmath.log2_add(x, torch.ones((4, 1, 1))), ValueError),
        (lambda: evmath.fma(x.transpose(1, 2).contiguous().transpose(1, 2), x, 1.0), ValueError),
        (lambda: evmath.exp2_f32(x[:, :, ::2]), ValueError),
        (lambda: evmath.log2_add(x[:, :1], x), ValueError),
    ]:
        with pytest.raises(error):
            call()
    assert evmath.KERNEL_LAUNCHES == before
    assert evmath.log2_f32(x[:0]).shape == (0, 6, 8) and evmath.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["mean23", "amaze-split", "amaze-mega"])
def test_dual_iso_convert_on_card_equals_cpu(program, tmp_path, monkeypatch):
    """--dual-iso --mean23, and --dual-iso (amaze-edge) in split and mega
    mode, on a clip whose third frame is single-ISO, write DNGs on the card
    byte-identical to the CPU's: every EV transform launches csrc/evmath.cu
    (KERNEL_LAUNCHES grows on the card only), which gives its twin's bits."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=640, height=192, frames=5, dual_iso=3)
    rng = np.random.default_rng(16)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    monkeypatch.setenv(amaze_core.MODE_ENV, "mega" if program == "amaze-mega" else "split")
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        before = evmath.KERNEL_LAUNCHES
        convert_clip(str(src), str(tmp_path / device / "out"), ProcessingConfig(
            device=device, batch_size=2, dual_iso=2, hdr_interpolation_method=int(program == "mean23")))
        launched = evmath.KERNEL_LAUNCHES - before
        print(f"{program} on {device}: evmath.KERNEL_LAUNCHES grew by {launched}")
        assert (launched > 0) == (device == "cuda")
        out = tmp_path / device / "out"
        trees.append({n: (out / n).read_bytes() for n in sorted(os.listdir(out))})
    assert len(trees[0]) == 5
    differ = {n: int((np.frombuffer(trees[0][n], "<u2") != np.frombuffer(trees[1][n], "<u2")).sum())
              for n in trees[0] if trees[0][n] != trees[1][n]}
    assert not differ, f"{program}: samples that differ from the CPU's, by DNG: {differ}"


def test_library_path_follows_source(tmp_path, monkeypatch):
    """A library is named by the hash of its source, so an edit rebuilds."""
    path = _build.library_path("unpack")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    src = tmp_path / "unpack.cu"
    shutil.copy(os.path.join(_build.SRC_DIR, "unpack.cu"), src)
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    assert _build.library_path("unpack") == path
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("unpack") != path


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """Editing a csrc/ header renames the library of every source that
    includes it, and of no other."""
    for name in os.listdir(_build.SRC_DIR):
        shutil.copy(os.path.join(_build.SRC_DIR, name), tmp_path / name)
    names = list(_build._SIGNATURES)
    before = {n: _build.library_path(n) for n in names}
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    assert {n: _build.library_path(n) for n in names} == before
    assert _build.sources("amaze_mega") == ["amaze_mega.cu", "amaze_passes.cuh", "amaze_tiles.cuh",
                                            "cp_async.cuh", "team.cuh", "amaze_stages.cuh"]
    for header, users in [("amaze_stages.cuh", {"amaze", "amaze_mega"}),
                          ("amaze_tiles.cuh", {"amaze", "amaze_mega"}),
                          ("amaze_passes.cuh", {"amaze_scans", "amaze_mega"}),
                          ("team.cuh", {"amaze", "amaze_scans", "amaze_mega"}),
                          ("cp_async.cuh", {"amaze_scans", "amaze_mega", "dualiso_preview"})]:
        path = tmp_path / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: _build.library_path(n) for n in names}
        assert {n for n in names if after[n] != before[n]} == users, header
        before = after


PTXAS_REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z6helperv
    24 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z4kernPf' for 'sm_90a'
ptxas info    : Function properties for _Z4kernPf
    176 bytes stack frame, 356 bytes spill stores, 596 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 368 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_entry():
    """The -Xptxas -v report gives each entry function's registers and its
    own stack and spills, not a callee's."""
    assert _build.parse_ptxas(PTXAS_REPORT) == {
        "_Z4kernPf": {"registers": 64, "stack": 176, "spill_stores": 356, "spill_loads": 596},
        "_Z5otherv": {"registers": 40, "stack": 0, "spill_stores": 0, "spill_loads": 0},
    }
    assert "-v" in _build.flags("amaze_mega") and _build.flags("amaze_mega")[-1] == "-fmad=false"


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: "/nonexistent/lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("unpack")
