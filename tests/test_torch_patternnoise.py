"""Pattern noise (--fix-pattern-noise) in the port vs mlvfs_tpu on CPU JAX.

The port's plain twins of the two blur kernels (#3 interleaved, #4 split
planes), its column stage and its batch entry point must equal the
reference bit for bit: the reference's Pallas kernels run in interpret mode,
beside its split XLA formulation. Frames hold int16 pixels of the full
range (u16 values at and above 32768 are negative there), flat patches that
open wide windows and edges that close them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import patternnoise as ref_pn
from mlvfs_tpu.ops import patternnoise_fused as ref_pf
from mlvfs_tpu.ops.patternnoise_pallas import edge_aware_blur_pallas
from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu.pipeline.convert import convert_clip as ref_convert
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.ops import patternnoise as pn
from mlvfs_tpu_torch.ops import patternnoise_fused as pf
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig as PortConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip as port_convert

SITES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _frame(h, w, seed, lo=-32768, hi=32768):
    """int32 frame: random pixels, a flat noisy band, a bright band."""
    rng = np.random.default_rng(seed)
    img = rng.integers(lo, hi, (h, w)).astype(np.int32)
    img[h // 4 : h // 2] = 4000 + rng.integers(-30, 30, (h // 2 - h // 4, w))
    img[h // 2 : h // 2 + 2, w // 3 :] = 15500
    return img


@pytest.mark.parametrize("h, w", [(64, 96), (32, 124), (16, 128)])
def test_blur_interleaved_plain_matches_pallas(h, w):
    """Kernel #3's twin vs the reference's Pallas blur_interleaved in
    interpret mode: both window edges, a frame narrower than the window
    (124 px: 62 channel columns) and one just at it (128 px)."""
    img = _frame(h, w, seed=h + w)
    want = np.asarray(ref_pf.blur_interleaved(jnp.asarray(img), interpret=True))
    got = pf.blur_interleaved(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h2, w2", [(37, 96), (8, 62), (4, 20)])
def test_edge_aware_blur_plain_matches_reference(h2, w2):
    """Kernel #4's twin vs the reference's Pallas edge_aware_blur_pallas
    (interpret mode) and its split XLA formulation, on four planes with a
    flat patch in g1."""
    rng = np.random.default_rng(h2 * w2)
    chans = [rng.integers(-2000, 16000, (h2, w2)).astype(np.int32) for _ in range(4)]
    chans[1][h2 // 4 : h2 // 2] = 4000
    want_xla = ref_pn._edge_aware_blur(*map(jnp.asarray, chans))
    want_pallas = edge_aware_blur_pallas(*map(jnp.asarray, chans), interpret=True)
    got = pn.edge_aware_blur(*map(torch.from_numpy, chans))
    for g, wx, wp in zip(got, want_xla, want_pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp))


@pytest.mark.parametrize("h, w", [(8, 4), (12, 40), (20, 130), (6, 256)])
def test_interleaved_twin_equals_split_twin(h, w):
    """The interleaved blur is the split blur at each Bayer site, batched."""
    img = np.stack([_frame(h, w, seed=s) for s in range(3)])
    got = pf.blur_interleaved_plain(torch.from_numpy(img))
    split = pn.edge_aware_blur_plain(*(torch.from_numpy(img[:, py::2, px::2]) for py, px in SITES))
    for (py, px), s in zip(SITES, split):
        assert torch.equal(got[:, py::2, px::2], s)


@pytest.mark.parametrize("h, w", [(16, 40), (24, 124)])
def test_direction_matches_reference(h, w):
    """One direction: the port's fused form (blur + interleaved column stage)
    equals both reference forms, the split XLA one and the fused one, with
    pixels at and above white (15000) masked out of the column medians."""
    img = _frame(h, w, seed=7)
    want = np.asarray(ref_pn._fix_column_noise_rggb(jnp.asarray(img), 15000))
    want_fused = np.asarray(ref_pf.fix_pattern_noise_direction(jnp.asarray(img), 15000,
                                                               interpret=True))
    np.testing.assert_array_equal(want_fused, want)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(pf.fix_pattern_noise_direction(t, 15000).numpy(), want)


def test_hgrad_interleaved_is_the_channel_gradient():
    """The interleaved gradient, with its row wrap, equals the reference's
    flat gradient of each channel (patternnoise.c:78-86)."""
    img = np.stack([_frame(10, 12, seed=s) for s in range(2)])
    got = pf._hgrad_flat_interleaved(torch.from_numpy(img)).numpy()
    for frame, got_frame in zip(img, got):
        for py, px in SITES:
            want = ref_pn._horizontal_gradient_flat(jnp.asarray(frame[py::2, px::2]))
            np.testing.assert_array_equal(got_frame[py::2, px::2], np.asarray(want))


@pytest.mark.parametrize("b, h, w", [(2, 32, 96), (1, 33, 61), (2, 20, 124), (1, 1, 40)])
def test_fix_pattern_noise_batch_matches_reference(b, h, w):
    """The batch and one-frame entry points vs the reference on u16 frames
    of the full range: even dimensions, odd ones (the even-cropped core is
    processed, the last row and column pass through), a frame narrower than
    the window, and a single row (nothing to do)."""
    rng = np.random.default_rng(b * h * w)
    imgs = rng.integers(0, 1 << 16, (b, h, w)).astype(np.uint16)
    imgs[:, :, : w // 2] = 3000 + rng.integers(-30, 30, (b, h, w // 2))
    want = np.asarray(ref_pn.fix_pattern_noise_batch(jnp.asarray(imgs), 15000))
    got = pn.fix_pattern_noise_batch(torch.from_numpy(imgs.view(np.int16)), 15000)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    if h > 1:
        assert (want != imgs).any()
    np.testing.assert_array_equal(
        pn.fix_pattern_noise_image(torch.from_numpy(imgs[0].view(np.int16)), 15000).numpy(),
        np.asarray(ref_pn.fix_pattern_noise_image(jnp.asarray(imgs[0]), 15000)).view(np.int16))


def test_blur_wrappers_refuse_bad_input():
    with pytest.raises(ValueError, match="even"):
        pf.blur_interleaved(torch.zeros((2, 6, 7), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        pf.blur_interleaved(torch.zeros((2, 6, 8), dtype=torch.int16))
    with pytest.raises(ValueError, match="unsupported device"):
        pf.blur_interleaved(torch.zeros((2, 6, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pn.edge_aware_blur(*[torch.zeros((3, 4), dtype=torch.int32, device="meta")] * 4)


def _tree(outdir):
    return {n: open(os.path.join(outdir, n), "rb").read() for n in sorted(os.listdir(outdir))}


def test_pattern_noise_convert_matches_jax(tmp_path):
    """--fix-pattern-noise through both packages' convert: byte-identical
    DNG trees, and the fix changes the frames."""
    spec = synth.SynthSpec(width=320, height=96, frames=4)
    rng = np.random.default_rng(11)
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(4)]).astype(np.float64)
    data += rng.normal(0, 6, 320)[None, None, :]  # column noise
    data = np.clip(data, 0, 16383).astype(np.uint16)
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, spec, frame_data=data)
    cfg = dict(batch_size=2, fix_pattern_noise=True)
    ref_convert(src, str(tmp_path / "ref"), RefConfig(**cfg))
    port_convert(src, str(tmp_path / "port"), PortConfig(device="cpu", **cfg))
    port = _tree(tmp_path / "port")
    assert len(port) == 4 and port == _tree(tmp_path / "ref")
    port_convert(src, str(tmp_path / "plain"), PortConfig(device="cpu", batch_size=2))
    plain = _tree(tmp_path / "plain")
    assert all(port[n] != plain[n] for n in port)
