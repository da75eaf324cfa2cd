"""Port focus-pixel fix (mlvfs_tpu_torch.ops.pixels) vs the JAX reference,
bit-exact, on the CPU."""

import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import pixels as ref
from mlvfs_tpu_torch.ops import pixels as port


def _fix_both(imgs, pixel_list, black, crop_x, crop_y, dual_iso):
    import jax.numpy as jnp

    want = np.asarray(
        ref.fix_pixel_list_batch(jnp.asarray(imgs), pixel_list, black, crop_x, crop_y, dual_iso)
    )
    got = port.fix_pixel_list_batch(
        torch.from_numpy(imgs.view(np.int16)), pixel_list, black, crop_x, crop_y, dual_iso
    )
    return got.numpy().view(np.uint16), want


def _hard_list(rng, h, w, crop_x, crop_y):
    """Interior, edge, corner, out-of-bounds, flat-index-0, duplicate and
    row-aliasing entries (x off the frame but the flat index inside it), in
    sensor coordinates."""
    xs = np.concatenate([
        rng.integers(0, w, 150),  # anywhere, edges included
        [0, 1, 2, 3, w - 3, w - 2, w - 1, 0, w - 1, 5, 5],
        [-1, -2, w, w + 2, -5, 7],  # off the row: alias into the previous/next row
        [4, 4],  # duplicate target
    ])
    ys = np.concatenate([
        rng.integers(0, h, 150),
        [7, 8, 9, 10, 11, 12, 13, 0, h - 1, 0, h - 1],
        [9, 10, 11, 12, h + 3, -4],  # the last two fall off the frame
        [6, 6],
    ])
    pl = np.stack([xs + crop_x, ys + crop_y], axis=1).astype(np.int32)
    # flat index 0 (never fixed by the reference) and the frame's last pixel
    return np.concatenate([pl, [[crop_x, crop_y], [w - 1 + crop_x, h - 1 + crop_y]]])


@pytest.mark.parametrize("dual_iso", [False, True])
@pytest.mark.parametrize("crop", [(0, 0), (8, 2)])
def test_fix_random_lists_matches_jax(dual_iso, crop):
    h, w, black = 40, 56, 2048
    rng = np.random.default_rng(11 + crop[0] + dual_iso)
    imgs = rng.integers(black - 64, 16000, (3, h, w)).astype(np.uint16)
    # pixels exactly at black: raw2ev = INT_MIN, whose C ABS wraps to INT_MIN
    at_black = rng.random((3, h, w)) < 0.15
    imgs[at_black] = black
    imgs[0, :, :] = np.where(rng.random((h, w)) < 0.5, black, imgs[0])
    imgs[1, 10:20, :] = black + 1  # flat patch: zero gradient sums
    pl = _hard_list(rng, h, w, *crop)
    got, want = _fix_both(imgs, pl, black, *crop, dual_iso)
    np.testing.assert_array_equal(got, want)
    assert (got != imgs).any()


def test_fix_bundled_fpm_matches_jax():
    """The bundled EOS M map at its own 1808x727 geometry."""
    h, w, black = 727, 1808, 2047
    pl = port.load_focus_pixel_map(0x80000331, w, h)
    np.testing.assert_array_equal(pl, ref.load_focus_pixel_map(0x80000331, w, h))
    assert len(pl) > 10000
    rng = np.random.default_rng(3)
    imgs = rng.integers(black, 12000, (2, h, w)).astype(np.uint16)
    imgs[:, ::7, ::5] = black
    got, want = _fix_both(imgs, pl, black, 0, 0, False)
    np.testing.assert_array_equal(got, want)
    assert (got != imgs).sum() > 10000


def test_fpm_lookup_order(tmp_path, monkeypatch):
    """Caller dir, then the CWD, then the bundled maps; empty maps count as none."""
    name = "80000331_1808x727.fpm"
    bundled = port.load_focus_pixel_map(0x80000331, 1808, 727)
    assert port.load_focus_pixel_map(0x80000331, 1808, 728) is None
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    (cwd / name).write_text("5 6\n7 8\n")
    monkeypatch.chdir(cwd)
    np.testing.assert_array_equal(port.load_focus_pixel_map(0x80000331, 1808, 727), [[5, 6], [7, 8]])
    given = tmp_path / "given"
    given.mkdir()
    (given / name).write_text("0x10 9\nnot a line\n")
    np.testing.assert_array_equal(
        port.load_focus_pixel_map(0x80000331, 1808, 727, str(given)), [[16, 9]]
    )
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / name).write_text("")
    assert port.load_focus_pixel_map(0x80000331, 1808, 727, str(empty)) is None
    monkeypatch.chdir(tmp_path)
    np.testing.assert_array_equal(port.load_focus_pixel_map(0x80000331, 1808, 727), bundled)


def test_empty_list_is_identity():
    imgs = torch.zeros((1, 8, 8), dtype=torch.int16)
    assert port.fix_pixel_list_batch(imgs, None, 0, 0, 0, False) is imgs
    out_of_frame = np.array([[100, 100], [-50, -50]], np.int32)
    out = port.fix_pixel_list_batch(imgs + 5, out_of_frame, 0, 0, 0, False)
    assert torch.equal(out, imgs + 5)


@pytest.mark.parametrize("aggressive", [False, True])
@pytest.mark.parametrize("crop", [(0, 0), (8, 2)])
def test_detect_bad_pixels_matches_jax(aggressive, crop):
    """Cold, hot and (aggressive) warm pixels, at any crop, in scan order."""
    h, w, black = 48, 72, 2048
    rng = np.random.default_rng(20 + aggressive + crop[0])
    img = rng.integers(black + 200, black + 1200, (h, w)).astype(np.uint16)
    ys, xs = rng.integers(6, h - 6, 40), rng.integers(6, w - 6, 40)
    img[ys[:10], xs[:10]] = black - 200  # cold
    img[ys[10:25], xs[10:25]] = 16383  # hot: > 2 EV above the neighbours
    img[ys[25:], xs[25:]] = black + 3000  # warm: 1-2 EV, caught only when aggressive
    img[0, :] = 0  # outside the detection window
    want = ref.detect_bad_pixels(img, w, h, black, aggressive, *crop)
    got = port.detect_bad_pixels(img, w, h, black, aggressive, *crop)
    assert got.dtype == np.int32 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)
    assert len(got) >= (30 if aggressive else 20)
