"""Full dual-ISO (--dual-iso, amaze-edge and --mean23) in the port vs mlvfs_tpu
on CPU JAX.

Tolerances, and why:
- bit-exact: the alias filter chain (kernel #7's twin, against the XLA form
  and the Pallas kernel in interpret mode), the overexposure blur, mean23
  with the same inputs and table transforms, the 20-bit chroma smoothing,
  the integer analysis (Bayer order, fields, white levels), hdr_check, the
  conversion mask, row phases and white levels, and every frame that is not
  converted;
- the exposure fit: the same ok and chosen candidate, a and b within one
  ulp, white_darkened within 1 (float32 scoring; measured: equal);
- converted frames (and the whole reconstruction at the same scalars, in
  both exact_luts modes, with mean23 and with amaze-edge, whose AMaZE
  demosaic the reference computes in float32 with XLA's own fused
  multiply-adds): PSNR >= 90 dB over the 16-bit output and at most
  3 % of pixels different, the reference's own gate between backends
  (tests/test_parity_dualiso_full.py:50-53). The port reproduces XLA's
  float32 log, exp and fused multiply-adds, but not its cos; measured on
  these frames: at most 0.01 % of pixels differ, by one code, PSNR >= 135 dB.
"""

import dataclasses
import math
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu import cli as ref_cli
from mlvfs_tpu.format.reader import MLVClip as RefClip
from mlvfs_tpu.ops import alias_pallas
from mlvfs_tpu.ops import chroma_smooth as ref_cs
from mlvfs_tpu.ops import dualiso_analysis as ref_analysis
from mlvfs_tpu.ops import dualiso_analysis_dev as ref_dev
from mlvfs_tpu.ops import dualiso_full as ref_full
from mlvfs_tpu.pipeline import kernels as ref_kernels
from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu_torch import cli
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.format.reader import MLVClip
from mlvfs_tpu_torch.ops import alias, amaze_core, amaze_edge, chroma_smooth, dualiso_analysis
from mlvfs_tpu_torch.ops import dualiso_analysis_dev as dev
from mlvfs_tpu_torch.ops import dualiso_full as full
from mlvfs_tpu_torch.ops import evmath, luts, pixels
from mlvfs_tpu_torch.pipeline import kernels
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig as PortConfig
from tests.test_torch_hdr_frames import hdr_threshold_frames

BLACK, WHITE = 2048, 15000
BLACK20 = BLACK * 64
W, H = 256, 192  # small enough for the tests, large enough for the analysis to convert
EVR = luts.EV_RESOLUTION


@pytest.fixture(autouse=True)
def _reference_tables(monkeypatch):
    # the reference's exact mode checks its arithmetic transforms against
    # the tables and then compiles them for minutes on the CPU; its switch
    # to the (value-identical) table gathers keeps the tests quick
    monkeypatch.setenv("MLVFS_TPU_EVARITH", "0")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(65535.0 ** 2 / mse)


def _assert_close_frames(got, want, what=""):
    """The PSNR-bounded gate of converted frames; prints what it measured
    (``pytest -s`` shows it)."""
    for i in range(len(want)):
        p, share = _psnr(got[i], want[i]), float((got[i] != want[i]).mean())
        print(f"{what} frame {i}: PSNR {p:.1f} dB, {100 * share:.4f} % of pixels differ")
        assert p >= 90 and share <= 0.03, f"{what} frame {i}: PSNR {p:.1f} dB, {100 * share:.3f} % differ"


# ------------------------------------------------------------ kernel #7


@jax.jit
def _ref_alias_batch(a, s):
    h, w = a.shape[1:]
    return jax.vmap(lambda x, y: ref_full._alias_filter_xla(x, y, h, w))(a, s)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [5, 12, 13, 64, 300])
@pytest.mark.parametrize("w", [37, 40])
def test_alias_filter_plain_matches_reference(b, h, w):
    """Kernel #7's twin vs the reference's XLA form and its Pallas kernel in
    interpret mode, bit for bit: no inner pixels below 13 px, odd and even
    sizes, a height above the Pallas kernel's 256-row chunk, skip densities
    0, 1/2 and 1, values up to 65530."""
    rng = np.random.default_rng(h * 100 + w + b)
    for density in (0.0, 0.5, 1.0):
        a = rng.integers(0, 65531, (b, h, w), dtype=np.int32)
        skip = rng.random((b, h, w)) < density
        got = alias.alias_filter(_t(a), _t(skip))
        assert got.dtype == torch.int32
        want = np.asarray(_ref_alias_batch(jnp.asarray(a), jnp.asarray(skip)))
        np.testing.assert_array_equal(got.numpy(), want)
    pallas = alias_pallas.alias_filter(jnp.asarray(a[0]), jnp.asarray(skip[0]), h, w, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pallas))


def test_alias_filter_refuses_bad_input():
    a = torch.zeros((2, 8, 8), dtype=torch.int32)
    skip = torch.zeros((2, 8, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        alias.alias_filter(a.float(), skip)
    with pytest.raises(ValueError, match="one shape"):
        alias.alias_filter(a, skip[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        alias.alias_filter(a.to("meta"), skip.to("meta"))


# ------------------------------------------------- integer reconstruction


def test_blur_overexposed_matches_reference():
    rng = np.random.default_rng(1)
    over = (rng.random((3, 37, 50)) < 0.3).astype(np.int32) * 100
    got = full._blur_overexposed(_t(over)).numpy()
    for i in range(3):
        want = np.asarray(ref_full._blur_overexposed(jnp.asarray(over[i]), 37, 50))
        np.testing.assert_array_equal(got[i], want)


def _phase_rows(phase, hh):
    """row_bright and s of a frame whose dark rows start at ``phase``."""
    ib = np.array([((q - phase) % 4) >= 2 for q in range(4)])
    ys = np.arange(hh)
    return ib[ys % 4], np.where(ib[ys % 4] == ib[(ys + 1) % 4], -1, 1).astype(np.int32)


def test_mean23_interpolate_matches_reference():
    """mean23 and the borders, bit for bit, for the four dark-row phases,
    with the 20-bit table transforms on both sides."""
    h, w = 40, 52
    white20 = 640000
    lut, inv = luts.raw2ev_lut20(BLACK20, white20), luts.ev2raw_lut20(BLACK20, white20)
    lut_t, inv_t = _t(lut.astype(np.int64)), _t(inv.astype(np.int64))
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 1 << 20, (4, h, w), dtype=np.int32)
    raw[:, 5:9, 10:30] = 0
    ev = lut[raw]
    rows = [_phase_rows(p, h) for p in range(4)]
    row_bright = np.stack([r for r, _ in rows])
    s = np.stack([v for _, v in rows])
    evw = lut[np.where(row_bright, white20, 400000)].astype(np.int32)

    def ref_inv(e):
        return jnp.asarray(inv)[jnp.clip(e + 10 * EVR, 0, 24 * EVR - 1)]

    def port_inv(e):
        return inv_t[(e.to(torch.int64) + 10 * EVR).clamp(0, 24 * EVR - 1)].to(torch.int32)

    dark, bright = full._mean23_interpolate(_t(raw), _t(ev), port_inv, _t(row_bright), _t(s), _t(evw))
    for i in range(4):
        wd, wb = ref_full._mean23_interpolate(jnp.asarray(raw[i]), jnp.asarray(ev[i]), ref_inv,
                                              jnp.asarray(row_bright[i]), jnp.asarray(s[i]),
                                              jnp.asarray(evw[i]), h, w)
        np.testing.assert_array_equal(dark[i].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(bright[i].numpy(), np.asarray(wb))
    assert lut_t.shape == (1 << 20,)


@pytest.mark.parametrize("method", [2, 3, 5])
def test_chroma_smooth_20bit_matches_reference(method):
    """The 20-bit form the reconstruction calls, through the same tables."""
    white20 = 640000
    lut, inv = luts.raw2ev_lut20(BLACK20, white20), luts.ev2raw_lut20(BLACK20, white20)
    rng = np.random.default_rng(method)
    frames = rng.integers(BLACK20 - 5000, 1 << 20, (2, 30, 44), dtype=np.int32)
    frames[:, 8:12, 8:20] = BLACK20
    got = chroma_smooth.chroma_smooth_20(_t(frames), method, _t(lut.astype(np.int64)),
                                         _t(inv.astype(np.int64)))
    lut_j, inv_j = jnp.asarray(lut), jnp.asarray(inv)
    for i in range(2):
        want = ref_cs.chroma_smooth_image(
            jnp.asarray(frames[i]), method, lambda x: lut_j[jnp.clip(x, 0, lut_j.shape[0] - 1)],
            lambda e: inv_j[10 * EVR:][e], 0)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


# ------------------------------------------------------------- the analysis


def _frames(kinds, seed=17, width=W, height=H, gbrg=False):
    """A batch by kind: an int is a dual-ISO frame with that dark-row phase,
    None a single-ISO frame."""
    spec = synth.SynthSpec(width=width, height=height, frames=len(kinds), dual_iso=3, gbrg=gbrg)
    rng = np.random.default_rng(seed)
    return spec, np.stack([
        synth.make_frame_data(dataclasses.replace(spec, dual_iso=0) if k is None else
                              dataclasses.replace(spec, dual_iso_phase=k), rng) for k in kinds])


def _fh(tmp_path, spec, frames, name="DI.MLV"):
    path = str(tmp_path / name)
    synth.write_mlv(path, spec, frame_data=frames)
    with RefClip(path) as a, MLVClip(path) as b:
        return a.frame_headers(0), b.frame_headers(0)


KINDS = [0, 1, 2, 3, None]


def _highlight_pairs(img, is_bright, white20, y1):
    """How many (bright, dark) sample pairs fall strictly between the 98th
    and 99.9th percentile of the unclipped brights: the exposure fit's
    selection before its hi_nmax cap (hdr.c:727-745), in numpy."""
    h, w = img.shape
    black, white = BLACK20 // 16, white20 // 16
    clip0 = white - black
    clip = int(np.float32(clip0) * np.float32(0.95))
    ys, xs = np.arange(y1 + 2, h - 2, 3), np.arange(0, w, 3)
    p16 = img.astype(np.int64) << 2
    pn, pa, pb = (p16[np.ix_(ys + d, xs)] - black for d in (0, -2, 2))
    pi = np.where((pa >= clip) | (pb >= clip), clip0, np.trunc((pa + pb + 1) / 2))
    pn = np.where(pi >= clip, clip0, pn)
    bright = np.where(np.asarray(is_bright)[ys % 4][:, None], pn, pi).ravel()
    vals = np.sort(bright[bright < clip])
    n = len(vals)
    b_lo, b_hi = vals[n * 98 // 100], vals[int(np.float32(n) * np.float32(0.999))]
    return int(((bright > b_lo) & (bright < b_hi)).sum())


def test_hdr_check_decides_near_threshold_as_reference():
    """hdr_check on frames whose mean |EV difference| sits just below and
    just above 0.5 decides as the reference does on CPU JAX, and its sums
    are math.fsum of the float32 differences, exactly."""
    frames, means = hdr_threshold_frames(BLACK, WHITE)
    assert means[0] < 0.5 < means[1] and max(abs(m - 0.5) for m in means) < 2e-4
    t = _t(frames.view(np.int16))
    got = full.hdr_check_batch(t, BLACK, WHITE)
    assert got.tolist() == [False, True]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_full.hdr_check_batch(jnp.asarray(frames),
                                                                                   BLACK, WHITE)))
    diff, num = full.hdr_check_terms(t, BLACK, WHITE)
    assert diff.dtype == torch.float32
    sums = full.hdr_check_sums(diff)
    for i in range(len(frames)):
        assert float(sums[i]) == math.fsum(diff[i].double().flatten().tolist())
        assert float(sums[i]) / int(num[i]) == means[i]


def test_hdr_check_sums_do_not_depend_on_order():
    """The sum of differences is the same whatever the order of its terms:
    the differences of a dual-ISO frame, shuffled, in float64, equal fsum."""
    _, frames = _frames([0, None])
    diff, _ = full.hdr_check_terms(_t(frames.view(np.int16)), BLACK, WHITE)
    rng = np.random.default_rng(3)
    for i in range(len(frames)):
        flat = diff[i].flatten()
        want = math.fsum(flat.double().tolist())
        for _ in range(3):
            shuffled = flat[torch.from_numpy(rng.permutation(flat.numel()))].reshape(diff[i].shape)
            assert float(full.hdr_check_sums(shuffled[None])[0]) == want


@pytest.mark.parametrize("gbrg", [False, True])
def test_analysis_stages_match_reference(gbrg):
    """hdr_check, the Bayer order, fields, white levels and the exposure fit
    on dual-ISO frames of the four phases and a single-ISO frame."""
    _, frames = _frames(KINDS, gbrg=gbrg)
    t = _t(frames.view(np.int16))
    j = jnp.asarray(frames)
    is_hdr = full.hdr_check_batch(t, BLACK, WHITE)
    np.testing.assert_array_equal(is_hdr.numpy(), np.asarray(ref_full.hdr_check_batch(j, BLACK, WHITE)))
    assert is_hdr[:4].all()
    rggb = bool(dev.rggb_stat(t[0]))
    assert rggb == bool(ref_dev.rggb_stat(j[0])) == (not gbrg)

    y_off = 0 if rggb else 1
    hh = H - y_off
    sub_t, sub_j = t[:, y_off : y_off + hh], j[:, y_off : y_off + hh]
    okf, ibf = dev.fields_stat_batch(sub_t, BLACK, y_off)
    rokf, ribf = ref_dev.fields_stat_batch(sub_j, BLACK, y_off)
    np.testing.assert_array_equal(okf.numpy(), np.asarray(rokf))
    np.testing.assert_array_equal(ibf.numpy(), np.asarray(ribf))
    area, max_pix = (y_off, 0, hh, W), W * hh // 2 // 9
    wd, wb = dev.white_detect_batch(sub_t, ibf, area, max_pix)
    rwd, rwb = ref_dev.white_detect_batch(sub_j, ribf, area, max_pix)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(rwd))
    np.testing.assert_array_equal(wb.numpy(), np.asarray(rwb))

    b20 = torch.full((len(KINDS),), BLACK20, dtype=torch.int32)
    w20 = torch.minimum(wd, wb) * 64
    ok, a, b, wdk = dev.match_exposures_batch(sub_t, ibf, b20, w20, (hh, W), y_off)
    rok, ra, rb, rwdk = ref_dev.match_exposures_batch(sub_j, ribf, jnp.asarray(b20.numpy()),
                                                      jnp.asarray(w20.numpy()), (hh, W), y_off)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    cands = dev.candidate_gains("cpu").numpy()
    ra, rb = np.asarray(ra), np.asarray(rb)
    conv = ok.numpy()
    assert conv[:4].all()
    # the same candidate (the gains' table equals XLA's exp2), a and b within one ulp
    assert [int(np.argmin(np.abs(cands - v))) for v in a.numpy()[conv]] == \
        [int(np.argmin(np.abs(cands - v))) for v in ra[conv]]
    for got_v, want_v in ((a.numpy(), ra), (b.numpy(), rb)):
        assert (np.abs(got_v - want_v) <= np.spacing(np.abs(want_v).astype(np.float32)))[conv].all()
    assert (np.abs(wdk.numpy() - np.asarray(rwdk)) <= 1)[conv].all()
    # fewer than hi_nmax highlight pairs qualify on these frames, so which
    # pairs among equal brights the capped window keeps (an unstable sort in
    # the reference, a stable one here) never arises
    hi_nmax = ((W + 2) * (hh + 2) // 9) // 50
    for i in np.nonzero(conv)[0]:
        assert _highlight_pairs(frames[i, y_off:], ribf[i], int(w20[i]), y_off) <= hi_nmax

    got = dev.analyze_batch(t, is_hdr, y_off, hh, BLACK)
    want = ref_full._analyze_batch(j, jnp.asarray(is_hdr.numpy()), y_off, hh, BLACK)
    names = ["ok", "row_bright", "s", "a", "b20", "white_darkened", "corr_ev", "overlap", "white20"]
    for name, g, r in zip(names, got, want):
        if name in ("ok", "row_bright", "s", "white20"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:  # measured equal; held to one ulp (white_darkened to 1)
            r = np.asarray(r)
            tol = 1 if name == "white_darkened" else np.spacing(np.abs(r).astype(np.float32))
            assert (np.abs(g.numpy() - r) <= tol).all(), name
    assert got[0].tolist() == [True, True, True, True, False]


def test_host_analysis_is_the_reference_copy():
    """The exact_luts mode's host analysis equals the reference's module."""
    _, frames = _frames([0, 2, None])
    for img in frames:
        assert dualiso_analysis.identify_rggb_or_gbrg(img) == ref_analysis.identify_rggb_or_gbrg(img)
        fok, ib = dualiso_analysis.identify_bright_and_dark_fields(img, BLACK)
        assert (fok, ib) == ref_analysis.identify_bright_and_dark_fields(img, BLACK)
        assert dualiso_analysis.white_detect(img, ib, (0, 0, H, W)) == \
            ref_analysis.white_detect(img, ib, (0, 0, H, W))
        fit = dualiso_analysis.match_exposures(img, ib, BLACK20, 640000)
        assert dataclasses.astuple(fit) == dataclasses.astuple(
            ref_analysis.match_exposures(img, ib, BLACK20, 640000))


def test_evmath_matches_reference():
    """The computed transforms: raw2ev20 and ev2raw20 bit for bit (the log
    and exp are XLA's own polynomials), the fullres curve within 2**-23 (cos
    is rounded once here)."""
    from mlvfs_tpu.ops import evmath as ref_evmath

    raw = np.arange(0, 1 << 20, 7, dtype=np.int32)
    np.testing.assert_array_equal(evmath.raw2ev20(_t(raw), BLACK20).numpy(),
                                  np.asarray(ref_evmath.raw2ev20(jnp.asarray(raw), BLACK20)))
    ev = np.arange(-10 * EVR, 14 * EVR, 5, dtype=np.int32)
    white_ev = full.white_ev_of(BLACK20, 640000)
    np.testing.assert_array_equal(
        evmath.ev2raw20(_t(ev), BLACK20, 640000, white_ev).numpy(),
        np.asarray(ref_evmath.ev2raw20(jnp.asarray(ev), BLACK20, 640000, white_ev)))
    got = evmath.fullres_weight(_t(raw), BLACK20).numpy()
    want = np.asarray(ref_evmath.fullres_weight(jnp.asarray(raw), BLACK20))
    assert (np.abs(got - want) <= 2.0 ** -23).all()


# ---------------------------------------------------------- reconstruction


def _ref_scalars(frames, y_off, hh):
    j = jnp.asarray(frames)
    is_hdr = ref_full.hdr_check_batch(j, BLACK, WHITE)
    return [np.asarray(v) for v in ref_full._analyze_batch(j, is_hdr, y_off, hh, BLACK)]


def _counts():
    return [m.KERNEL_LAUNCHES for m in (alias, amaze_core, amaze_edge)]


def _check_reconstruct(interp_method, exact, fullres, alias_map, cs):
    """The reconstruction at the reference's own scalars over the four
    dark-row phases, against the reference, on the CPU's plain twins."""
    _, frames = _frames([0, 1, 2, 3])
    ok, rb, s, a, b20, wd, ce, ov, w20 = _ref_scalars(frames, 0, H)
    assert ok.all()
    white20 = int(w20[0])
    kw = dict(black20=BLACK20, white20=white20, interp_method=interp_method, use_fullres=bool(fullres),
              use_alias=bool(alias_map), cs_method=cs, exact_luts=exact)
    lut = jnp.asarray(luts.raw2ev_lut20(BLACK20, white20))
    inv = jnp.asarray(luts.ev2raw_lut20(BLACK20, white20))
    frc = jnp.asarray(np.asarray(luts.fullres_curve(BLACK20), np.float32))
    want = np.asarray(ref_full.reconstruct_batch(
        jnp.asarray(frames), *map(jnp.asarray, (rb, s, a, b20, wd, ce, ov)), lut, inv, frc,
        white_ev=full.white_ev_of(BLACK20, white20), arith=False, **kw))
    before = _counts()
    got = full.reconstruct_batch(_t(frames.view(np.int16)), *map(_t, (rb, s, a, b20, wd, ce, ov)), **kw)
    assert _counts() == before  # the CPU runs the plain twins
    _assert_close_frames(got.numpy().view(np.uint16), want, f"reconstruct interp={interp_method} "
                         f"exact={exact} fullres={fullres} alias={alias_map} cs={cs}")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("fullres, alias_map, cs", [(0, 1, 0), (1, 0, 0), (1, 1, 3), (0, 0, 5)])
def test_reconstruct_batch_matches_reference(exact, fullres, alias_map, cs):
    """mean23, in the four option cases of tests/test_parity_dualiso_full.py:58."""
    _check_reconstruct(1, exact, fullres, alias_map, cs)


@pytest.mark.parametrize("exact, fullres, alias_map, cs", [(False, 1, 1, 0), (True, 1, 0, 3)])
def test_reconstruct_batch_amaze_edge_matches_reference(exact, fullres, alias_map, cs):
    """amaze-edge (the default, interp_method=0), in both transform modes."""
    _check_reconstruct(0, exact, fullres, alias_map, cs)


def test_reconstruct_batch_refuses_unknown_interpolation():
    _, frames = _frames([0])
    rb, s = (_t(v[None]) for v in _phase_rows(0, H))
    one = torch.ones(1)
    with pytest.raises(ValueError, match="interp_method"):
        full.reconstruct_batch(_t(frames.view(np.int16)), rb, s, one, one, one.int(), one, one,
                               black20=BLACK20, white20=640000, interp_method=2, use_fullres=True,
                               use_alias=True, cs_method=0, exact_luts=False)


def _check_cr2hdr20(tmp_path, interp_method, exact, gbrg):
    """The whole batch step: the four phases (or GBRG frames, whose
    reconstruction starts a row down, so AMaZE sees RGGB) and a single-ISO
    frame, which is not converted and keeps its bytes; the per-clip Bayer
    order and white level land in the calibration."""
    spec, frames = _frames(KINDS, seed=21, gbrg=gbrg)
    rfh, pfh = _fh(tmp_path, spec, frames)
    cfg = dict(dual_iso=2, hdr_interpolation_method=interp_method, exact_luts=exact)
    rcal, pcal = ref_kernels.ClipCalibration(), kernels.ClipCalibration()
    want, wok = ref_full.cr2hdr20_batch(jnp.asarray(frames), rfh, RefConfig(**cfg), rcal)
    got, gok = full.cr2hdr20_batch(_t(frames.view(np.int16)), pfh, PortConfig(device="cpu", **cfg), pcal)
    want, got = np.asarray(want), got.numpy().view(np.uint16)
    assert gok.tolist() == np.asarray(wok).tolist() == [True, True, True, True, False]
    np.testing.assert_array_equal(got[4], frames[4])
    np.testing.assert_array_equal(got[4], want[4])
    _assert_close_frames(got[:4], want[:4], f"cr2hdr20 interp={interp_method} exact={exact} gbrg={gbrg}")
    assert (pcal.dual_iso_rggb, pcal.dual_iso_white20) == (rcal.dual_iso_rggb, rcal.dual_iso_white20)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("gbrg", [False, True])
def test_cr2hdr20_batch_matches_reference(tmp_path, exact, gbrg):
    _check_cr2hdr20(tmp_path, 1, exact, gbrg)


@pytest.mark.parametrize("gbrg", [False, True])
def test_cr2hdr20_batch_amaze_edge_matches_reference(tmp_path, gbrg):
    _check_cr2hdr20(tmp_path, 0, False, gbrg)


# ------------------------------------------------------- the whole pipeline


def _levels(dng: bytes):
    ifd = struct.unpack_from("<I", dng, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", dng, ifd)[0]):
        tag, _, _, value = struct.unpack_from("<HHII", dng, ifd + 2 + 12 * i)
        tags[tag] = value
    return tags[50714], tags[50717]


def test_mixed_batch_matches_reference(tmp_path):
    """run_pipeline on a batch mixing a dual-ISO frame with a single-ISO one
    carrying bad pixels (mirrors tests/test_mixed_batch.py:103, against
    JAX): the per-clip bad-pixel map comes from frame 0 through the dual
    path, so frame 1's planted pixels survive; per-frame levels; no chroma
    smoothing on the frame not converted, which is byte-identical."""
    spec, frames = _frames([0, None], seed=7)
    pts = [(21, 43), (100, 80), (150, 201)]
    for i, (y, x) in enumerate(pts):
        frames[1, y, x] = 100 if i % 2 else 16200
    rfh, pfh = _fh(tmp_path, spec, frames)
    cfg = dict(dual_iso=2, hdr_interpolation_method=1, fix_bad_pixels=1, chroma_smooth=2,
               batch_size=2)
    rcal = ref_kernels.calibrate_clip(rfh, RefConfig(**cfg))
    pcal = kernels.calibrate_clip(pfh, PortConfig(device="cpu", **cfg))
    info = lambda: {"black_level": BLACK, "white_level": WHITE, "exposure_bias": None}  # noqa: E731
    want, winfo = ref_kernels.run_pipeline(jnp.asarray(frames), rfh, RefConfig(**cfg), rcal, info())
    got, ginfo = kernels.run_pipeline(_t(frames.view(np.int16)), pfh, PortConfig(device="cpu", **cfg),
                                      pcal, info())
    want, got = np.asarray(want), got.numpy().view(np.uint16)
    assert ginfo["levels"] == winfo["levels"] == [(4 * BLACK, 4 * WHITE), (BLACK, WHITE)]
    assert pcal.bad_pixels_done and rcal.bad_pixels_done
    np.testing.assert_array_equal(pcal.bad_pixel_list, rcal.bad_pixel_list)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1, 21, 43] == frames[1, 21, 43] == 16200  # the frame-0 map leaves it
    # the frame not converted gets the normal-mode fixes and no chroma smoothing
    fixed = frames[1:2].view(np.int16)
    if len(pcal.bad_pixel_list):
        crop_x, crop_y = (int(pfh.vidf["panPosX"]) + 7) & ~7, int(pfh.vidf["panPosY"]) & ~1
        fixed = pixels.fix_pixel_list_batch(_t(fixed), pcal.bad_pixel_list, BLACK, crop_x, crop_y,
                                            dual_iso=False).numpy()
    np.testing.assert_array_equal(got[1], fixed[0].view(np.uint16))
    smoothed = chroma_smooth.chroma_smooth_batch(_t(fixed), 2, BLACK).numpy().view(np.uint16)
    assert (smoothed[0] != got[1]).any()
    _assert_close_frames(got[:1], want[:1], "mixed")


def _tree(outdir):
    return {n: open(os.path.join(outdir, n), "rb").read() for n in sorted(os.listdir(outdir))}


def _check_cli(tmp_path, program, flags):
    """``convert CLIP`` with ``program`` on a clip whose fourth frame is
    single-ISO: the same DNG names, byte-identical headers (x4 levels on the
    converted frames) and frames not converted, payloads within the PSNR
    gate."""
    spec, frames = _frames([0, 1, 2, None, 3], seed=5)
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, spec, frame_data=frames)
    args = [src, *program, "--no-idx", "--batch-size", "2", *flags]
    assert ref_cli.main(["convert", "-o", str(tmp_path / "ref"), *args]) == 0
    assert cli.main(["convert", "-o", str(tmp_path / "port"), "--device", "cpu", *args]) == 0
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert list(port) == list(ref) and len(port) == 5
    for i, name in enumerate(ref):
        assert port[name][:65536] == ref[name][:65536], name
        assert _levels(port[name]) == ((BLACK, WHITE) if i == 3 else (4 * BLACK, 4 * WHITE))
        if i == 3:
            assert port[name] == ref[name]
        else:
            g = np.frombuffer(port[name], "<u2", offset=65536)
            r = np.frombuffer(ref[name], "<u2", offset=65536)
            _assert_close_frames(g[None], r[None], f"cli {' '.join([*program, *flags])} {name}")


CLI_FLAGS = [[], ["--no-alias-map", "--cs3x3"], ["--bad-pix", "--cs2x2", "--stripes"]]


@pytest.mark.parametrize("flags", CLI_FLAGS)
def test_cli_convert_matches_reference(flags, tmp_path):
    _check_cli(tmp_path, ["--dual-iso", "--mean23"], flags)


@pytest.mark.parametrize("flags", CLI_FLAGS)
def test_cli_convert_amaze_edge_matches_reference(flags, tmp_path):
    """amaze-edge, the default interpolation."""
    _check_cli(tmp_path, ["--dual-iso"], flags)
