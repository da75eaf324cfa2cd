"""Port chroma smoothing (mlvfs_tpu_torch.ops.chroma_smooth) vs the JAX
reference, bit-exact, on the CPU.

The port's plain twin is held against the reference's XLA form and its Pallas
kernel in interpret mode; the CUDA kernel is held against the twin on the
card by tests/test_torch_kernels.py. The kernel's median networks are held
equal to the reference's proven tables here, by reading its source.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import chroma_smooth as ref
from mlvfs_tpu.ops import medians as ref_medians
from mlvfs_tpu.ops.chroma_pallas import chroma_smooth_pallas
from mlvfs_tpu_torch import _build
from mlvfs_tpu_torch.ops import chroma_smooth as port
from mlvfs_tpu_torch.ops import medians as port_medians

_ref_batch = jax.jit(ref.chroma_smooth_batch, static_argnums=(1, 2))


def _frames(rng, b, h, w, black):
    """Seeded u16 frames with pixels at, below and far above black, a black
    block (raw2ev = INT_MIN) and a dark patch (the skip rule)."""
    imgs = rng.integers(black - 40, 16000, (b, h, w)).astype(np.uint16)
    imgs[:, 3:9, 5:20] = black
    imgs[:, -6:, : w // 2] = black + rng.integers(0, 4, (b, min(6, h), w // 2))
    imgs[0, ::5, ::3] = black
    return imgs


def _port(imgs, method, black):
    got = port.chroma_smooth_batch(torch.from_numpy(imgs.view(np.int16)), method, black)
    assert got.dtype == torch.int16
    return got.numpy().view(np.uint16)


@pytest.mark.parametrize("method", [2, 3, 5])
@pytest.mark.parametrize("black", [2047, 2048])
def test_plain_matches_jax_xla(method, black):
    rng = np.random.default_rng(10 * method + black)
    imgs = _frames(rng, 3, 40, 58, black)
    want = np.asarray(_ref_batch(jnp.asarray(imgs), method, black))
    got = _port(imgs, method, black)
    np.testing.assert_array_equal(got, want)
    assert (got != imgs).sum() > 100  # the smoothing ran


@pytest.mark.parametrize("method", [2, 3, 5])
def test_plain_matches_pallas_interpret(method):
    """One small frame with a black block, against the TPU kernel itself."""
    black = 2048
    rng = np.random.default_rng(method)
    img = _frames(rng, 1, 24, 36, black)[0]
    want = np.asarray(chroma_smooth_pallas(jnp.asarray(img), method, black, interpret=True))
    np.testing.assert_array_equal(_port(img[None], method, black)[0], want)


@pytest.mark.parametrize("size", [(8, 8), (8, 16), (16, 8), (9, 7)])
def test_degenerate_sizes_pass_through(size):
    """Frames without a cell window come back unchanged, as a copy."""
    imgs = np.random.default_rng(1).integers(0, 1 << 14, (2, *size)).astype(np.uint16)
    for method in (2, 3, 5):
        want = np.asarray(_ref_batch(jnp.asarray(imgs), method, 2048))
        np.testing.assert_array_equal(want, imgs)
        t = torch.from_numpy(imgs.view(np.int16))
        out = port.chroma_smooth_batch(t, method, 2048)
        assert out.data_ptr() != t.data_ptr()
        np.testing.assert_array_equal(out.numpy().view(np.uint16), imgs)


def test_odd_width_5x5_refused_like_the_reference():
    imgs = np.full((1, 24, 27), 5000, np.uint16)
    with pytest.raises(TypeError):
        _ref_batch(jnp.asarray(imgs), 5, 2048)
    with pytest.raises(ValueError, match="even frame width"):
        _port(imgs, 5, 2048)
    for method in (2, 3):  # the smaller neighbourhoods take odd widths
        want = np.asarray(_ref_batch(jnp.asarray(imgs), method, 2048))
        np.testing.assert_array_equal(_port(imgs, method, 2048), want)


def test_bad_arguments_raise():
    imgs = torch.zeros((1, 16, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="method"):
        port.chroma_smooth_batch(imgs, 4, 2048)
    with pytest.raises(ValueError, match="unsupported device"):
        port.chroma_smooth_batch(imgs.to("meta"), 3, 2048)


def test_offsets_and_window_match_reference():
    for method in (2, 3, 5):
        assert port._offsets(method) == ref._offsets(method)
    assert [len(port._offsets(m)) for m in (2, 3, 5)] == [5, 9, 25]
    assert port.cell_window(1080, 1920) == (536, 956)


def test_median_networks_match_reference():
    """The port's tables are the reference's (proven by the 0-1 principle in
    tests/test_medians.py), and torch's network gives sort's median."""
    assert port_medians.NETWORKS == ref_medians.NETWORKS
    rng = np.random.default_rng(0)
    for k in (5, 9, 25):
        assert port_medians.prune(port_medians.NETWORKS[k], k // 2) == ref_medians.prune(
            ref_medians.NETWORKS[k], k // 2)
        planes = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (k, 300), dtype=np.int64))
        planes[:, :50] = 7  # ties
        got = port_medians.median_planes(list(planes))
        torch.testing.assert_close(got, planes.sort(dim=0).values[k // 2], rtol=0, atol=0)
    with pytest.raises(ValueError):
        port_medians.median_planes([torch.zeros(1)] * 4)


def test_kernel_source_runs_the_reference_networks():
    """csrc/chroma.cu spells out the same compare-exchange sequences."""
    with open(os.path.join(_build.SRC_DIR, "chroma.cu")) as f:
        src = f.read()
    for k in (5, 9, 25):
        body = re.search(r"median<%d>\(int\* v\) \{(.*?)return v\[(\d+)\];" % k, src, re.S)
        assert body, k
        pairs = [(int(a), int(b)) for a, b in re.findall(r"PIX_SORT\((\d+), (\d+)\)", body.group(1))]
        assert pairs == ref_medians.NETWORKS[k]
        assert int(body.group(2)) == k // 2
    assert "mlvfs_chroma_smooth" in _build._SIGNATURES["chroma"]
