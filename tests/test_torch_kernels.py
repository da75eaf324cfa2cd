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
from mlvfs_tpu_torch.ops import (chroma_smooth, dualiso, patternnoise, patternnoise_fused,
                                 pixels, unpack)
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _words(rng, b, n_words):
    return torch.from_numpy(rng.integers(0, 1 << 16, (b, n_words), dtype=np.uint16).view(np.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [8, 10, 12, 14])
def test_unpack_kernel_matches_plain(bpp):
    """Bit-equal to the twin, including a partial last block and a truncated stream."""
    _need_card()
    rng = np.random.default_rng(bpp)
    for h, w, b, cut in [(1080, 1920, 4, 0), (727, 1808, 2, 0), (5, 27, 3, 0), (64, 96, 2, 1000)]:
        words = _words(rng, b, unpack.words_for_pixels(h * w, bpp) - cut).cuda()
        before = unpack.KERNEL_LAUNCHES
        got = unpack.unpack_batch(words, bpp, h, w)
        assert unpack.KERNEL_LAUNCHES == before + 1
        want = unpack.unpack_batch_plain(words, bpp, h, w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (h, w, b, cut)
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
    with a block of pixels exactly at black (raw2ev = INT_MIN)."""
    _need_card()
    rng = np.random.default_rng(method)
    for b, h, w in [(16, 1080, 1920), (4, 727, 1808), (1, 8, 8), (1, 8, 16), (1, 16, 8)]:
        for black in (2047, 2048):
            imgs = rng.integers(black - 40, 16000, (b, h, w)).astype(np.uint16)
            imgs[:, 10:20, 10:40] = black
            t = torch.from_numpy(imgs.view(np.int16)).cuda()
            before = chroma_smooth.KERNEL_LAUNCHES
            got = chroma_smooth.chroma_smooth_batch(t, method, black)
            assert chroma_smooth.KERNEL_LAUNCHES == before + 1
            want = chroma_smooth.chroma_smooth_batch_plain(t, method, black)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (b, h, w, black)


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


@pytest.mark.cuda
def test_pattern_noise_kernels_match_plain():
    """Kernels #3 and #4 are bit-equal to the plain twin: a multi-block
    height that is no multiple of the block's 4 rows, the 124- and 128-px
    widths at and below the window, and int16 pixels of the full range."""
    _need_card()
    rng = np.random.default_rng(3)
    sites = ((0, 0), (0, 1), (1, 0), (1, 1))
    for b, h, w in [(2, 1080, 1920), (1, 1078, 640), (2, 64, 124), (2, 64, 128), (1, 2, 2)]:
        x = rng.integers(-32768, 32768, (b, h, w)).astype(np.int32)
        x[:, :, : w // 2] = 3000 + rng.integers(-40, 40, (b, h, w // 2))
        t = torch.from_numpy(x).cuda()
        before = patternnoise_fused.KERNEL_LAUNCHES
        got = patternnoise_fused.blur_interleaved(t)
        assert patternnoise_fused.KERNEL_LAUNCHES == before + 1
        want = patternnoise_fused.blur_interleaved_plain(t)
        planes = [t[:, py::2, px::2].contiguous() for py, px in sites]
        got4 = patternnoise.edge_aware_blur(*planes)
        want4 = patternnoise.edge_aware_blur_plain(*planes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, h, w)
        assert all(torch.equal(g, v) for g, v in zip(got4, want4)), (b, h, w)


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
    with over-white and below-shadow pixels, at heights 5, 6, 7 and 1080."""
    _need_card()
    rng = np.random.default_rng(4)
    for b, h, w in [(8, 1080, 1920), (4, 5, 96), (4, 6, 96), (4, 7, 300)]:
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
def test_pattern_noise_and_preview_convert_on_card_match_cpu(flags, tmp_path):
    """--fix-pattern-noise, and --dual-iso-preview on a clip whose third
    frame is not dual-ISO (a mixed batch) with bad pixels, 2x2 chroma
    smoothing and stripes, write the same DNGs and .CAL on the card as on
    the CPU; the kernels launch on the card only."""
    _need_card()
    import dataclasses

    spec = synth.SynthSpec(width=640, height=192, frames=5, dual_iso=3)
    rng = np.random.default_rng(6)
    data = np.stack([synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if i == 2 else spec,
                                           rng) for i in range(spec.frames)])
    data[2, 101, 200] = 16383
    trees = []
    for device in ("cuda", "cpu"):
        src = tmp_path / device / "C.MLV"
        src.parent.mkdir()
        synth.write_mlv(str(src), spec, frame_data=data)
        before = (patternnoise_fused.KERNEL_LAUNCHES, dualiso.KERNEL_LAUNCHES)
        convert_clip(str(src), str(tmp_path / device / "out"),
                     ProcessingConfig(device=device, batch_size=2, **flags))
        launched = (patternnoise_fused.KERNEL_LAUNCHES - before[0], dualiso.KERNEL_LAUNCHES - before[1])
        want = (6, 0) if flags.get("fix_pattern_noise") else (0, 3)  # 3 batches
        assert launched == (want if device == "cuda" else (0, 0))
        out = tmp_path / device / "out"
        tree = {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}
        cal = tmp_path / device / "C.CAL"
        tree["CAL"] = cal.read_bytes() if cal.exists() else None
        trees.append(tree)
    assert len(trees[0]) == 6 and trees[0] == trees[1]


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


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: "/nonexistent/lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("unpack")
