"""Port stripe correction (mlvfs_tpu_torch.ops.stripes) vs the JAX reference,
bit-exact, on the CPU."""

import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import stripes as ref
from mlvfs_tpu_torch.ops import stripes as port


def _striped(rng, h, w, black, white):
    """Seeded frame with a period-8 column gain, dark and clipped pixels."""
    base = rng.integers(black - 30, int(black + (white - black) / 1.4), (h, w)).astype(np.float64)
    gain = np.array([1.0, 1.0, 1.03, 0.98, 1.0, 1.012, 0.96, 1.0])[np.arange(w) % 8]
    img = black + (base - black) * gain
    img[::7, ::5] = white + 100
    return np.clip(img, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("h, w, black, white", [(64, 200, 2048, 15000), (40, 96, 512, 4000),
                                                (30, 16, 2048, 15000)])
def test_compute_correction_matches_jax(h, w, black, white):
    img = _striped(np.random.default_rng(w), h, w, black, white)
    want_g, want_needed = ref.compute_correction(img, black, white, w, frame_size_bytes=h * w * 14 // 8)
    got_g, got_needed = port.compute_correction(img, black, white, w, frame_size_bytes=h * w * 14 // 8)
    np.testing.assert_array_equal(got_g, want_g)
    assert got_g.dtype == np.int32 and got_needed == want_needed
    if w >= 96:
        assert got_needed and (got_g[2:] != 65536).any()


@pytest.mark.parametrize("w", [96, 100])
def test_apply_correction_matches_jax(w):
    black, white = 2048, 15000
    rng = np.random.default_rng(w)
    imgs = rng.integers(0, 1 << 16, (3, 20, w)).astype(np.uint16)
    imgs[:, :4] = rng.integers(black, black + 70, (3, 4, w))  # around the black + 64 gate
    gains = np.array([65536, 0, 67000, 64000, 131071, 1, 65537, 70000], np.int32)
    want = np.asarray(ref.apply_correction_batch(imgs, gains, black, white))
    got = port.apply_correction_batch(torch.from_numpy(imgs.view(np.int16)), gains, black, white)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    if w % 8 == 0:
        assert (want != imgs).any()
    else:
        np.testing.assert_array_equal(want, imgs)
