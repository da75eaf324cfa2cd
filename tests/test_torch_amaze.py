"""The amaze-edge pieces of the port vs mlvfs_tpu on CPU JAX.

Tolerances, and why:
- bit-exact: the squeeze permutation, the edge scorer and pick (kernel #6's
  twin, integer arithmetic, against the XLA form and the Pallas kernel in
  interpret mode) and the Nyquist dilation (#10's integer pass);
- atol 1e-6: the refinement and chrominance passes (float32, the
  reference's own bound between its scan forms,
  tests/test_amaze_scans_pallas.py:40,74);
- rtol 1e-5, atol 0.01 on the 0..65535 planes: the AMaZE demosaic, the
  reference's bound between its AMaZE forms
  (tests/test_amaze_scans_pallas.py:107). The twin fuses the float32
  products XLA on the CPU contracts into fused multiply-adds (the CUDA
  kernels repeat the twin's roundings), but which products XLA fuses
  depends on how it fuses the whole program; measured on these frames: at
  most 0.002 on the 0..65535 scale, the green plane bit-equal.
The reconstruction and the CLI with amaze-edge are in
tests/test_torch_dualiso_full.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.ops import amaze as ref_amaze
from mlvfs_tpu.ops import amaze_core as ref_core
from mlvfs_tpu.ops import amaze_edge_pallas
from mlvfs_tpu.ops import amaze_scans_pallas as ref_scans
from mlvfs_tpu.ops.amaze_pallas import amaze_demosaic_pallas
from mlvfs_tpu_torch.ops import amaze, amaze_core, amaze_edge, amaze_scans
from mlvfs_tpu_torch.ops.luts import EV_RESOLUTION as EVR

HP, WP = 192 + 32, 160 + 32  # 2 scan tiles, as tests/test_amaze_scans_pallas.py:21


@pytest.fixture(autouse=True)
def _xla_scans(monkeypatch):
    # the reference's frame-level XLA scans (its CPU path)
    monkeypatch.setenv("MLVFS_AMAZE_PALLAS", "0")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _phase_rows(phase, h):
    """row_bright and s of a frame whose dark rows start at ``phase``."""
    ib = np.array([((q - phase) % 4) >= 2 for q in range(4)])
    ys = np.arange(h)
    return ib[ys % 4], np.where(ib[ys % 4] == ib[(ys + 1) % 4], -1, 1).astype(np.int32)


# ------------------------------------------------------------ squeeze


@pytest.mark.parametrize("h", [192, 191, 30])
def test_squeeze_rows_matches_reference(h):
    """The squeeze permutation over the four dark-row phases, and a frame
    with no bright rows (a frame not converted), bit for bit."""
    rows = np.stack([_phase_rows(p, h)[0] for p in range(4)] + [np.zeros(h, bool)])
    got = amaze.squeeze_rows(_t(rows)).numpy()
    for i in range(len(rows)):
        want = np.asarray(ref_amaze.squeeze_rows(jnp.asarray(rows[i]), h))
        np.testing.assert_array_equal(got[i], want)


# ------------------------------------------------------------ kernel #6


def _edge_inputs(rng, b, h, w, density):
    ev = lambda: rng.integers(-2 * EVR, 14 * EVR, (b, h, w), dtype=np.int32)  # noqa: E731
    evgray, ewa, ewb = ev(), ev(), ev()
    evgray[:, h // 3 :, : w // 2] //= 64  # flat areas, where directions tie
    s = np.stack([_phase_rows(i % 4, h)[1] for i in range(b)])
    restricted = rng.random((b, h, w)) < density
    return evgray, ewa, ewb, s, restricted


@jax.jit
def _ref_edge_batch(evgray, ewa, ewb, s, restricted):
    h, w = evgray.shape[1:]
    return jax.vmap(lambda *a: ref_amaze.edge_pick_xla(*a, h, w))(evgray, ewa, ewb, s, restricted)


@pytest.mark.parametrize("h, w", [(300, 41), (64, 40), (11, 12)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_edge_pick_plain_matches_reference(h, w, density):
    """Kernel #6's twin vs the XLA form, and vs the Pallas kernel in
    interpret mode, bit for bit: odd and even widths, a height above the
    Pallas kernel's 256-row chunk, a frame with hardly a scored pixel,
    restricted densities 0, 1/2 and 1, the four row phases."""
    rng = np.random.default_rng(h * 7 + w + int(density * 10))
    evgray, ewa, ewb, s, restricted = _edge_inputs(rng, 4, h, w, density)
    got = amaze_edge.edge_pick(*map(_t, (evgray, ewa, ewb, s, restricted)))
    assert got.dtype == torch.int32 and amaze_edge.KERNEL_LAUNCHES == 0
    want = np.asarray(_ref_edge_batch(*map(jnp.asarray, (evgray, ewa, ewb, s, restricted))))
    np.testing.assert_array_equal(got.numpy(), want)
    if density == 0.5:
        i = h % 4
        pallas = amaze_edge_pallas.edge_pick(*(jnp.asarray(v[i]) for v in (evgray, ewa, ewb, s, restricted)),
                                             h, w, interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(pallas))


def test_edge_pick_refuses_bad_input():
    z = torch.zeros((2, 8, 8), dtype=torch.int32)
    s = torch.ones((2, 8), dtype=torch.int32)
    r = torch.zeros((2, 8, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        amaze_edge.edge_pick(z.float(), z, z, s, r)
    with pytest.raises(ValueError, match="row sign"):
        amaze_edge.edge_pick(z, z, z, s[:, :4], r)
    with pytest.raises(ValueError, match="unsupported device"):
        amaze_edge.edge_pick(*(t.to("meta") for t in (z, z, z, s, r)))


# ------------------------------------------------------------ kernel #10


def _crop(a):
    # the Pallas tile kernels read zeros below a tile where the frame-level
    # form reads the frame: only the frame's last rows see it
    return np.asarray(a)[..., : HP - 16, :]


def _to_tiles(frame):
    """A (hp, wp) frame in the split AMaZE path's tile layout: the 160/128
    row chunks, lanes padded to a multiple of 128 with the wrap copies
    (mlvfs_tpu/ops/amaze_pallas.py:748-756)."""
    T = ref_core._n_tiles(HP)
    tiles = ref_core._chunk_rows(jnp.asarray(frame), T)
    wpp = -(-WP // 128) * 128
    if 0 < wpp - WP < 16:
        wpp += 128
    x = jnp.pad(tiles, ((0, 0), (0, 0), (0, wpp - WP)))
    x = x.at[..., WP : WP + 8].set(x[..., 0:8])
    return x.at[..., wpp - 8 :].set(x[..., WP - 8 : WP])


def _from_tiles(x):
    return ref_core._unchunk_rows(x[..., :WP], HP)


def test_refine_plain_matches_reference(rng):
    wt = rng.random((2, HP, WP), np.float32)
    got = amaze_scans.refine(_t(wt))
    assert amaze_scans.KERNEL_LAUNCHES == 0
    for i in range(2):
        want = ref_core._neighbor_refine_scan(jnp.asarray(wt[i]), HP, WP)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-6)
    tiles = np.asarray(_from_tiles(ref_scans.refine_tiles(_to_tiles(wt[0]), WP, interpret=True)))
    np.testing.assert_allclose(_crop(got[0].numpy()), _crop(tiles), rtol=0, atol=1e-6)


def test_dilate_plain_matches_reference(rng):
    nyq = (rng.random((2, HP, WP)) > 0.6).astype(np.int32)
    rbmask = jnp.asarray(((np.arange(HP)[:, None] + np.arange(WP)[None, :]) % 2) == 0)
    got = amaze_scans.dilate(_t(nyq))
    for i in range(2):
        want = ref_core._nyquist_dilate(jnp.asarray(nyq[i]), rbmask, HP, WP)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    tiles = _to_tiles(nyq[0].astype(np.float32))
    tiles = np.asarray(_from_tiles(ref_scans.dilate_tiles(tiles, WP, interpret=True)))
    np.testing.assert_array_equal(_crop(got[0].numpy()), _crop(tiles).astype(np.int32))


def test_chroma_plain_matches_reference(rng):
    D = rng.normal(0, 0.1, (2, 2, HP, WP)).astype(np.float32)
    yy, xx = np.arange(HP)[:, None], np.arange(WP)[None, :]
    bsite = jnp.asarray((yy % 2 == 1) & (xx % 2 == 1))
    rbmask = jnp.asarray((yy + xx) % 2 == 0)
    got0, got1 = amaze_scans.chroma(_t(D[0]), 1), amaze_scans.chroma(_t(D[1]), 0)
    for i in range(2):
        w0, w1 = ref_core._chroma_smooth_scan(jnp.asarray(D[0, i]), jnp.asarray(D[1, i]), bsite, rbmask,
                                              HP, WP)
        np.testing.assert_allclose(got0[i].numpy(), np.asarray(w0), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got1[i].numpy(), np.asarray(w1), rtol=0, atol=1e-6)
    for plane, parity, got in ((0, 1, got0), (1, 0, got1)):
        tiles = ref_scans.chroma_one_tiles(_to_tiles(D[plane, 0]), WP, parity, interpret=True)
        np.testing.assert_allclose(_crop(got[0].numpy()), _crop(_from_tiles(tiles)), rtol=0, atol=1e-6)


def test_raster_passes_refuse_bad_input():
    with pytest.raises(TypeError, match="float32"):
        amaze_scans.refine(torch.zeros((1, 40, 40), dtype=torch.int32))
    with pytest.raises(ValueError, match="even width"):
        amaze_scans.dilate(torch.zeros((1, 40, 41), dtype=torch.int32))
    with pytest.raises(ValueError, match="0 or 1"):
        amaze_scans.chroma(torch.zeros((1, 40, 40)), 2)


# ------------------------------------------------------------ kernel #8


def _smooth_frame(rng, h=160, w=224):
    """The smooth mosaic of tests/test_amaze_scans_pallas.py:93-99."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 8000 + 6000 * np.sin(x / 9.0) * np.cos(y / 11.0) + 3000 * (x / w)
    gains = np.array([[0.8, 1.0], [1.0, 0.6]])
    return np.clip(base * gains[y.astype(int) % 2, x.astype(int) % 2] + rng.normal(0, 30, (h, w)),
                   0, 65535).astype(np.float32)


def _natural_frame(rng, h=320, w=352):
    """The natural-statistics mosaic of tests/test_parity_amaze.py:62-79:
    a 1/f spectrum, occlusion edges, shot-like noise; several scan tiles."""
    gains = np.array([[0.85, 1.0], [1.0, 0.55]])
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    img = np.real(np.fft.ifft2(amp * np.exp(2j * np.pi * rng.random((h, w)))))
    img = (img - img.min()) / (img.max() - img.min())
    y, x = np.mgrid[0:h, 0:w]
    img = np.where((x + 2 * y) % 97 < 18, img * 0.25 + 0.7, img)
    img[h // 3 : h // 2, w // 4 : w // 2] *= 0.15
    mosaic = (1500 + img * 12000) * gains[y % 2, x % 2]
    mosaic += rng.normal(0, np.sqrt(np.maximum(mosaic, 1)) * 0.5)
    return np.clip(mosaic, 0, 65535).astype(np.float32)


@pytest.mark.parametrize("frame", ["smooth", "natural"])
def test_amaze_demosaic_plain_matches_reference(frame, rng):
    """The AMaZE twin vs the reference's CPU form (frame-wide stencils, the
    tile grid's raster passes) and vs its split Pallas path in interpret
    mode, at the reference's bound between AMaZE forms."""
    img = _smooth_frame(rng) if frame == "smooth" else _natural_frame(rng)
    got = amaze_core.amaze_demosaic(_t(img[None]))
    assert amaze_core.KERNEL_LAUNCHES == 0
    want = jax.jit(ref_core.amaze_demosaic)(jnp.asarray(img))
    split = amaze_demosaic_pallas(jnp.asarray(img), interpret=True, mode="split")
    for g, x, p in zip(got, want, split):
        assert g.shape == (1, *img.shape) and torch.isfinite(g).all()
        np.testing.assert_allclose(g[0].numpy(), np.asarray(x), rtol=1e-5, atol=0.01)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(p), rtol=1e-5, atol=0.01)


def test_amaze_demosaic_refuses_bad_input():
    with pytest.raises(TypeError, match="float32"):
        amaze_core.amaze_demosaic(torch.zeros((1, 40, 40), dtype=torch.int32))
    with pytest.raises(ValueError, match="even width"):
        amaze_core.amaze_demosaic(torch.zeros((1, 40, 41)))
    with pytest.raises(ValueError, match="unsupported device"):
        amaze_core.amaze_demosaic(torch.zeros((1, 40, 40), device="meta"))


def test_tile_grid_matches_reference():
    for hp in (33, 160, 161, 224, 1112):
        assert amaze_core.n_tiles(hp) == ref_core._n_tiles(hp)
        a = np.arange(hp * 6, dtype=np.float32).reshape(hp, 6)
        T = amaze_core.n_tiles(hp)
        tiles = amaze_core.chunk_rows(_t(a), T)
        np.testing.assert_array_equal(tiles.numpy(), np.asarray(ref_core._chunk_rows(jnp.asarray(a), T)))
        np.testing.assert_array_equal(amaze_core.unchunk_rows(tiles, hp).numpy(), a)
    assert os.environ["MLVFS_AMAZE_PALLAS"] == "0"


def _enum(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return [t.strip() for t in body.replace("\n", " ").split(",") if t.strip()]


def test_workspace_planes_match_the_kernels_enums():
    """ops/amaze_core.py's plane lists follow csrc/amaze_stages.cuh: PLANES
    (every plane the stages name) is enum Plane, SPLIT_PLANES (the workspace
    of kernels #8 and #9) is enum SplitSlot, each S_<plane> naming the plane it holds, split_slot()
    mapping every plane to its slot and every other plane to -1, and the
    int32 planes are in both where #8 holds them."""
    src = open(os.path.join(os.path.dirname(amaze_core.__file__), "..", "csrc", "amaze_stages.cuh")).read()
    planes = _enum(src, "Plane")
    slots = _enum(src, "SplitSlot")
    assert planes[-1] == "N_PLANES" and slots[-1] == "N_SPLIT"
    planes, slots = planes[:-1], slots[:-1]
    assert len(planes) == len(amaze_core.PLANES) and len(slots) == len(amaze_core.SPLIT_PLANES)
    assert all(s.startswith("S_") and s[2:] in planes for s in slots)
    held = [planes.index(s[2:]) for s in slots]
    assert [amaze_core.PLANES[i] for i in held] == list(amaze_core.SPLIT_PLANES)
    mapping = dict(re.findall(r"P == (\w+)\s*\? (S_\w+)", src[src.index("constexpr int split_slot"):]))
    assert mapping == {s[2:]: s for s in slots}
    assert set(amaze_core.INT_PLANES) <= set(amaze_core.SPLIT_PLANES) <= set(amaze_core.PLANES)
    assert len(slots) < len(planes)
