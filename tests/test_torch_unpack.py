"""Port unpack (mlvfs_tpu_torch.ops.unpack) vs the JAX reference, bit-exact.

On the CPU the port's unpack_batch runs its plain PyTorch twin and the
reference's takes its plain XLA path; the CUDA kernel is held against the
twin on the card by tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.format.bits import pack_bits_np
from mlvfs_tpu.ops import unpack as ref
from mlvfs_tpu_torch.ops import unpack as port


@functools.lru_cache(maxsize=None)
def _ref_batch(bpp, h, w):
    return jax.jit(lambda words: ref.unpack_batch(words, bpp, h, w))


def _t16(a: np.ndarray) -> torch.Tensor:
    """u16 numpy → the port's int16 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint16).view(np.int16))


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint16)


# (H, W): a full frame, odd sizes whose pixel count leaves a partial last
# block at 10/12/14 bpp, and a single row
SIZES = [(16, 40), (7, 13), (5, 27), (1, 9)]


@pytest.mark.parametrize("bpp", [8, 10, 12, 14])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_unpack_batch_matches_jax(bpp, size):
    h, w = size
    rng = np.random.default_rng(1000 * bpp + h * w)
    n_words = port.words_for_pixels(h * w, bpp)
    assert n_words == ref.words_for_pixels(h * w, bpp)
    # random words exercise every bit, including bits past the last pixel
    words = rng.integers(0, 1 << 16, (3, n_words + 5), dtype=np.uint16)
    got = _u16(port.unpack_batch(_t16(words), bpp, h, w))
    want = np.asarray(_ref_batch(bpp, h, w)(jnp.asarray(words)))
    assert got.shape == (3, h, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpp", [8, 10, 12, 14])
def test_unpack_short_stream_matches_jax(bpp):
    """A truncated stream reads as zero-padded in both packages."""
    h, w = 6, 22
    rng = np.random.default_rng(bpp)
    n_words = port.words_for_pixels(h * w, bpp)
    words = rng.integers(0, 1 << 16, (2, n_words // 2 + 1), dtype=np.uint16)
    got = _u16(port.unpack_batch(_t16(words), bpp, h, w))
    want = np.asarray(_ref_batch(bpp, h, w)(jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)
    assert not got.reshape(2, -1)[:, -1].any()  # the missing tail is zeros


@pytest.mark.parametrize("bpp", [8, 10, 12, 14])
def test_unpack_words_roundtrips_packed_pixels(bpp):
    n = 1001
    vals = np.random.default_rng(bpp).integers(0, 1 << bpp, n).astype(np.uint16)
    words = pack_bits_np(vals, bpp)
    np.testing.assert_array_equal(_u16(port.unpack_words(_t16(words), bpp, n)), vals)
    frame = port.unpack_frame(_t16(words), bpp, 7, 143)
    np.testing.assert_array_equal(_u16(frame), vals.reshape(7, 143))


@pytest.mark.parametrize("bpp", [8, 10, 12, 14])
def test_pack16_matches_jax_and_roundtrips(bpp):
    n = 333
    vals = np.random.default_rng(7 + bpp).integers(0, 1 << bpp, n).astype(np.uint16)
    got = _u16(port.pack16(_t16(vals), bpp))
    want = np.asarray(jax.jit(ref.pack16, static_argnums=(1,))(jnp.asarray(vals), bpp))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_u16(port.unpack_words(_t16(got), bpp, n)), vals)


@pytest.mark.parametrize("shape", [(6, 8), (2, 10, 4), (3, 2, 12, 6)])
def test_lj92_detile_matches_jax(shape):
    img = np.random.default_rng(len(shape)).integers(0, 1 << 16, shape, dtype=np.uint16)
    got = _u16(port.lj92_detile(_t16(img)))
    want = np.asarray(ref.lj92_detile(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port.lj92_detile(_t16(np.zeros((5, 4), np.uint16)))


@pytest.mark.parametrize("nbytes", [0, 1, 6, 7])
def test_bytes_to_words_np_matches_jax(nbytes):
    payload = np.arange(nbytes, dtype=np.uint8) * 37
    np.testing.assert_array_equal(port.bytes_to_words_np(payload), ref.bytes_to_words_np(payload))


def test_unpack_batch_refuses_other_devices():
    words = torch.zeros((1, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.unpack_batch(words, 14, 2, 4)

