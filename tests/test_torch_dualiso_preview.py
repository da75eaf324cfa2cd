"""Dual-ISO preview (--dual-iso-preview) in the port vs mlvfs_tpu on CPU JAX.

The row transform's plain twin (kernel #5's) must equal the reference's
lax.scan and its Pallas kernel in interpret mode bit for bit, the host fit
must give the same floats, and whole conversions, mixed batches (frames that
are not dual-ISO among ones that are) included, must write byte-identical
DNG trees and `.CAL` sidecars.
"""

import dataclasses
import fractions
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu.format.reader import MLVClip as RefClip
from mlvfs_tpu.ops import dualiso as ref_di
from mlvfs_tpu.ops.dualiso_preview_pallas import apply_preview_pallas
from mlvfs_tpu.pipeline import kernels as ref_kernels
from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu.pipeline.convert import convert_clip as ref_convert
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.format.reader import MLVClip
from mlvfs_tpu_torch.ops import dualiso as di
from mlvfs_tpu_torch.pipeline import calibration, kernels
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig as PortConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip as port_convert

BLACK, WHITE = 2048, 15000


def _preview_inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 1 << 14, (b, h, w), dtype=np.uint16)
    # an over-white band (replacement chains) and a below-shadow block
    imgs[:, h // 4 : h // 2 + 1, : w // 3] = WHITE + 7
    imgs[:, h // 2 :, w // 2 :] = 5
    a = np.array([0.23, 1.7, 0.5], np.float32)[:b]
    bb = np.array([3.0, -11.0, 0.1], np.float32)[:b]
    shadow = np.array([900.0, 40.0, 3000.0], np.float32)[:b]
    drs = ((np.arange(b) + h) % 4).astype(np.int32)  # all four phases over the cases
    return imgs, a, bb, shadow, drs


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [5, 6, 64, 130])
def test_apply_preview_plain_matches_reference(b, h):
    """Kernel #5's twin vs apply_preview_xla and apply_preview_pallas
    (interpret mode): the top and bottom row edges (H = 5, 6), the Pallas
    kernel's 128-row chunk boundary (H = 130)."""
    imgs, a, bb, shadow, drs = _preview_inputs(b, h, 64, seed=h)
    args = [jnp.asarray(v) for v in (imgs, a, bb, shadow, drs)]
    want = np.asarray(ref_di.apply_preview_xla(*args, BLACK, WHITE))
    np.testing.assert_array_equal(
        np.asarray(apply_preview_pallas(*args, BLACK, WHITE, interpret=True)), want)
    got = di.apply_preview(torch.from_numpy(imgs.view(np.int16)),
                           *map(torch.from_numpy, (a, bb, shadow, drs)), BLACK, WHITE)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def _round_f32(q: fractions.Fraction) -> np.float32:
    """The float32 nearest to the rational ``q`` (ties to even)."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    dist = [abs(fractions.Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    tied = [c for c, d in zip(cands, dist) if d == best]
    return min(tied, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma_f32_rounds_once():
    """x * y + z rounded once, the contraction XLA applies to the scale
    step: random operands, and a sum that float64 rounds onto a float32
    midpoint (where rounding twice would pick the wrong neighbour)."""
    rng = np.random.default_rng(0)
    x = (rng.integers(-65535, 65536, 200)).astype(np.float32)
    y = rng.uniform(-4, 4, 200).astype(np.float32)
    z = rng.integers(0, 65536, 200).astype(np.float32)
    one_ulp = np.float32(1 + 2.0**-23)
    x = np.append(x, one_ulp)
    y = np.append(y, np.float32(2.0**-24 * (1 - 2.0**-23)))
    z = np.append(z, one_ulp)
    got = di.fma_f32(*map(torch.from_numpy, (x, y, z))).numpy()
    for i in range(len(x)):
        want = _round_f32(fractions.Fraction(float(x[i])) * fractions.Fraction(float(y[i]))
                          + fractions.Fraction(float(z[i])))
        assert got[i] == want, (i, x[i], y[i], z[i])
    assert got[-1] == one_ulp  # the two-rounding answer would be 1 + 2**-22


def _dual_frames(width, height, kinds, seed=5):
    """Frames by kind: an int is a dual-ISO frame with that dark-row phase,
    None a single-ISO frame."""
    spec = synth.SynthSpec(width=width, height=height, frames=len(kinds), dual_iso=3)
    rng = np.random.default_rng(seed)
    return spec, np.stack([
        synth.make_frame_data(
            dataclasses.replace(spec, dual_iso=0) if k is None else
            dataclasses.replace(spec, dual_iso_phase=k), rng)
        for k in kinds])


def test_fit_and_preview_batch_match_reference(tmp_path):
    """Histograms, counts and per-frame fits (floats compared exactly) and
    the whole preview step, with the focus-pixel fix on detected frames,
    on a batch of three dual-ISO phases, a single-ISO frame and a flat one."""
    spec, frames = _dual_frames(640, 192, [0, None, 2, 3, None])
    frames[4] = BLACK + 7
    path = str(tmp_path / "D.MLV")
    synth.write_mlv(path, spec, frame_data=frames)
    t = torch.from_numpy(frames.view(np.int16))

    want_h, want_c = ref_di.green_phase_histograms(jnp.asarray(frames), WHITE)
    got_h, got_c = di.green_phase_histograms(t, WHITE)
    np.testing.assert_array_equal(got_h, np.asarray(want_h))
    np.testing.assert_array_equal(got_c, want_c)
    want_fits = ref_di.fit_preview(np.asarray(want_h), want_c, BLACK, WHITE)
    got_fits = di.fit_preview(got_h, got_c, BLACK, WHITE)
    assert [dataclasses.astuple(f) for f in got_fits] == [dataclasses.astuple(f) for f in want_fits]
    assert [f.ok for f in got_fits] == [True, False, True, True, False]

    focus = np.array([[64, 64], [321, 100], [101, 51], [600, 180]], np.int64)
    ref_cal = ref_kernels.ClipCalibration(focus_pixel_list=focus)
    port_cal = kernels.calibration_from_reference(ref_cal)
    with RefClip(path) as ref_clip, MLVClip(path) as port_clip:
        want, want_ok = ref_di.hdr_preview_batch(jnp.asarray(frames), ref_clip.frame_headers(0), ref_cal)
        got, got_ok = di.hdr_preview_batch(t, port_clip.frame_headers(0), port_cal)
    np.testing.assert_array_equal(got_ok, np.asarray(want_ok))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint16), frames[1])  # untouched


def test_preview_launches_nothing_without_a_detected_frame(tmp_path, monkeypatch):
    spec, frames = _dual_frames(320, 96, [None, None])
    path = str(tmp_path / "P.MLV")
    synth.write_mlv(path, spec, frame_data=frames)

    def refuse(*args, **kwargs):
        raise AssertionError("apply_preview ran without a detected frame")

    monkeypatch.setattr(di, "apply_preview", refuse)
    t = torch.from_numpy(frames.view(np.int16))
    with MLVClip(path) as clip:
        out, ok = di.hdr_preview_batch(t, clip.frame_headers(0), None)
    assert not ok.any() and out is t


def test_apply_preview_refuses_bad_input():
    imgs = torch.zeros((2, 6, 8), dtype=torch.int16)
    one = torch.ones(2)
    with pytest.raises(TypeError, match="int16"):
        di.apply_preview(imgs.to(torch.int32), one, one, one, one.int(), BLACK, WHITE)
    with pytest.raises(ValueError, match="per frame"):
        di.apply_preview(imgs, one[:1], one, one, one.int(), BLACK, WHITE)
    with pytest.raises(ValueError, match="unsupported device"):
        di.apply_preview(imgs.to("meta"), one, one, one, one.int(), BLACK, WHITE)


def _tree(outdir):
    return {n: open(os.path.join(outdir, n), "rb").read() for n in sorted(os.listdir(outdir))}


def _levels(dng: bytes):
    """(BlackLevel, WhiteLevel) from a DNG's IFD0."""
    ifd = struct.unpack_from("<I", dng, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", dng, ifd)[0]):
        tag, _, _, value = struct.unpack_from("<HHII", dng, ifd + 2 + 12 * i)
        tags[tag] = value
    return tags[50714], tags[50717]


def _convert_both(tmp_path, spec, frames, cfg):
    """Convert the clip with both packages (each beside its own sidecar);
    returns (ref tree, port tree, ref .CAL bytes or None, port's)."""
    trees, cals = [], []
    for name, convert, config in (("ref", ref_convert, RefConfig(**cfg)),
                                  ("port", port_convert, PortConfig(device="cpu", **cfg))):
        clip = tmp_path / f"{name}_clip" / "C.MLV"
        clip.parent.mkdir()
        synth.write_mlv(str(clip), spec, frame_data=frames)
        convert(str(clip), str(tmp_path / name), config)
        trees.append(_tree(tmp_path / name))
        cal = calibration.cal_path(str(clip))
        cals.append(open(cal, "rb").read() if os.path.exists(cal) else None)
    return (*trees, *cals)


def test_dual_iso_preview_convert_matches_jax(tmp_path):
    """--dual-iso-preview on a dual-ISO clip: byte-identical DNG trees, x4
    levels, and the frames differ from a plain conversion."""
    spec, frames = _dual_frames(640, 192, [0, 0, 1, 3], seed=8)
    ref, port, _, _ = _convert_both(tmp_path, spec, frames, dict(batch_size=2, dual_iso=1))
    assert list(port) == list(ref) and len(port) == 4 and port == ref
    assert all(_levels(v) == (4 * BLACK, 4 * WHITE) for v in port.values())
    port_convert(str(tmp_path / "port_clip" / "C.MLV"), str(tmp_path / "plain"),
                 PortConfig(device="cpu", batch_size=2))
    plain = _tree(tmp_path / "plain")
    assert all(port[n][65536:] != plain[n][65536:] for n in port)


# frames by kind: dual-ISO (phase 0) or single-ISO (None); at batch 2 the
# first batch is all dual-ISO (no bad-pixel detection there) and the second
# mixed, so the bad pixels are found on frame 3, the first single-ISO frame
MIXED = [0, 0, None, 0]


@pytest.mark.parametrize("case", ["eosm_fixes", "all_flags"])
def test_mixed_batch_convert_matches_jax(case, tmp_path):
    """Mixed batches: converted frames carry x4 levels and skip the
    normal-mode fixes, the others are fixed and keep their own levels;
    chroma smoothing and stripes run per frame at its own levels, and the
    stripes calibrate from frame 0 at x4. ``eosm_fixes`` is an EOS M clip
    with its bundled focus-pixel map and ``--bad-pix --cs2x2 --stripes``;
    ``all_flags`` adds pattern noise and deflicker to bad pixels, 3x3
    chroma smoothing and stripes."""
    if case == "eosm_fixes":
        spec, frames = _dual_frames(1808, 727, MIXED, seed=9)
        spec = dataclasses.replace(spec, camera_model=0x80000331, camera_name="Canon EOS M")
        cfg = dict(batch_size=2, dual_iso=1, fix_bad_pixels=1, chroma_smooth=2, fix_stripes=True)
    else:
        spec, frames = _dual_frames(640, 192, MIXED, seed=10)
        cfg = dict(batch_size=2, dual_iso=1, fix_pattern_noise=True, deflicker=3000,
                   fix_bad_pixels=1, chroma_smooth=3, fix_stripes=True)
    frames[2, 101, 200], frames[2, 51, 301] = 16383, 0  # hot and cold, in the single-ISO frame
    gain = np.array([1.0, 1.0, 1.04, 0.985, 1.0, 1.01, 0.97, 1.0])[np.arange(spec.width) % 8]
    frames = np.clip(BLACK + (frames - float(BLACK)) * gain, 0, 16383).astype(np.uint16)
    ref, port, ref_cal, port_cal = _convert_both(tmp_path, spec, frames, cfg)
    assert list(port) == list(ref) and len(port) == 4
    for name in ref:
        assert port[name] == ref[name], f"{name} differs"
    assert ref_cal is not None and port_cal == ref_cal
    levels = [_levels(port[n]) for n in port]
    assert levels == [(4 * BLACK, 4 * WHITE) if k is not None else (BLACK, WHITE) for k in MIXED]
    payload = np.frombuffer(port["C_000002.dng"], "<u2", offset=65536).reshape(spec.height, -1)
    assert payload[101, 200] != 16383 and payload[51, 301] != 0  # bad pixels fixed
