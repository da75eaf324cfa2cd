"""Port deflicker median (mlvfs_tpu_torch.ops.histogram) vs the JAX
reference, bit-exact, on the CPU; and the BaselineExposure it turns into."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import histogram as ref
from mlvfs_tpu_torch.ops import histogram as port
from mlvfs_tpu_torch.pipeline import kernels


# (B, H, W): even widths (the reference's parity-mask branch), odd widths and
# odd pixel counts (its strided branch), a single row, a single pixel
SHAPES = [(3, 16, 40), (2, 7, 13), (2, 6, 9), (2, 1, 9), (1, 1, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bpp", [12, 14])
def test_deflicker_median_matches_jax(shape, bpp):
    white = (1 << bpp) + 1
    rng = np.random.default_rng(sum(shape) + bpp)
    imgs = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    imgs[0] = np.minimum(imgs[0], 3000)  # a frame whose median lies below white
    want = np.asarray(jax.vmap(lambda im: ref.deflicker_median(im, white))(jnp.asarray(imgs)))
    got = port.deflicker_median(torch.from_numpy(imgs.view(np.int16)), white)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_exposure_bias_matches_reference_formula():
    medians = np.array([2048, 2047, 3000, 9000, 2100], np.int32)
    target, black = 3000, 2048
    m = medians.astype(np.float64)
    corr = np.log2((target - black) / np.maximum(m - black, 1e-9))
    assert kernels.exposure_bias(medians, target, black) == [(int(c * 10000), 10000) for c in corr]
    assert kernels.exposure_bias(medians, target, black)[2] == (0, 10000)
