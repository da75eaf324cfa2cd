"""The flags-on processing program (deflicker, chroma smoothing, stripes, bad
pixels) through the port's convert on the CPU vs mlvfs_tpu on CPU JAX.

Every stage is integer, so the DNG trees must be byte-identical, and so must
the `.CAL` sidecars that hold the per-clip stripe gains and bad-pixel list.
The clips carry a period-8 column gain and injected hot and cold pixels, so
the stripe correction and the bad-pixel fix change pixels.
"""

import json
import os
import shutil

import numpy as np
import pytest

from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu.pipeline.convert import convert_clip as ref_convert
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.pipeline import calibration
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig as PortConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip as port_convert

ALL_FLAGS = dict(deflicker=3000, chroma_smooth=3, fix_stripes=True, fix_bad_pixels=1)


def _tree(outdir):
    return {n: open(os.path.join(outdir, n), "rb").read() for n in sorted(os.listdir(outdir))}


def flagged_frames(spec, rng):
    """Synthetic frames with a period-8 column gain and hot/cold pixels."""
    data = np.stack([synth.make_frame_data(spec, rng) for _ in range(spec.frames)]).astype(np.float64)
    gain = np.array([1.0, 1.0, 1.04, 0.985, 1.0, 1.01, 0.97, 1.0])[np.arange(spec.width) % 8]
    data = spec.black + (data - spec.black) * gain
    top = (1 << spec.bpp) - 1
    data[:, 20, 30] = 0  # cold
    data[:, 9, 14] = data[:, 13, 11] = top  # hot, in the dark top-left corner
    return np.clip(data, 0, top).astype(np.uint16)


def _convert_both(tmp_path, spec, cfg, frame_data=None):
    """Write the clip twice (each package keeps its own sidecars), convert
    with both packages, and return (ref dir, port dir, ref clip, port clip)."""
    if frame_data is None:
        frame_data = flagged_frames(spec, np.random.default_rng(spec.seed))
    clips = {}
    for name in ("ref", "port"):
        os.makedirs(tmp_path / f"{name}_clip")
        clips[name] = str(tmp_path / f"{name}_clip" / "C.MLV")
        synth.write_mlv(clips[name], spec, frame_data=frame_data)
    ref_convert(clips["ref"], str(tmp_path / "ref"), RefConfig(**cfg))
    port_convert(clips["port"], str(tmp_path / "port"), PortConfig(device="cpu", **cfg))
    return tmp_path / "ref", tmp_path / "port", clips["ref"], clips["port"]


CASES = {
    "cs2x2": dict(chroma_smooth=2),
    "cs3x3": dict(chroma_smooth=3),
    "cs5x5": dict(chroma_smooth=5),
    "deflicker": dict(deflicker=3000),
    "stripes": dict(fix_stripes=True),
    "bad_pix": dict(fix_bad_pixels=1),
    "really_bad_pix": dict(fix_bad_pixels=2),
    "all_flags": ALL_FLAGS,
    "all_flags_cs5x5_really_bad": dict(ALL_FLAGS, chroma_smooth=5, fix_bad_pixels=2),
    "all_flags_compress_dng": dict(ALL_FLAGS, compress="lj92"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flags_convert_matches_jax(case, tmp_path):
    """320x96 14-bit, 5 frames at batch 2: the last batch is a tail batch."""
    spec = synth.SynthSpec(width=320, height=96, frames=5)
    cfg = dict(batch_size=2, **CASES[case])
    ref_dir, port_dir, ref_clip, port_clip = _convert_both(tmp_path, spec, cfg)
    ref, port = _tree(ref_dir), _tree(port_dir)
    assert list(port) == list(ref) and len(port) == 5
    for name in ref:
        assert port[name] == ref[name], f"{name} differs"

    # the flags did their work, and both packages stored the same calibration
    port_convert(port_clip, str(tmp_path / "plain"), PortConfig(device="cpu", batch_size=2))
    assert _tree(tmp_path / "plain") != port
    if cfg.get("fix_stripes") or cfg.get("fix_bad_pixels"):
        with open(calibration.cal_path(ref_clip), "rb") as a, \
                open(calibration.cal_path(port_clip), "rb") as b:
            ref_cal = a.read()
            assert b.read() == ref_cal
        cal = json.loads(ref_cal)
        stripes = [v for k, v in cal.items() if k.endswith("/stripes")]
        badpix = [v for k, v in cal.items() if "/badpix/" in k]
        if cfg.get("fix_stripes"):
            assert stripes[0]["needed"]
        if cfg.get("fix_bad_pixels"):
            assert len(badpix[0]["pixels"]) >= 6  # 3 injected pixels, (x, y) each
    if cfg.get("deflicker"):
        assert port["C_000000.dng"][:65536] != _tree(tmp_path / "plain")["C_000000.dng"][:65536]


@pytest.mark.parametrize("variant", ["bpp12", "lzma"])
def test_flags_convert_variants_match_jax(variant, tmp_path):
    """A 12-bit clip at its own levels, and an LZMA clip, with every flag on."""
    kw = dict(bpp=12, black=512, white=3800) if variant == "bpp12" else dict(compression="lzma")
    spec = synth.SynthSpec(width=320, height=96, frames=3, **kw)
    ref_dir, port_dir, _, _ = _convert_both(tmp_path, spec, dict(batch_size=2, **ALL_FLAGS))
    assert _tree(port_dir) == _tree(ref_dir)


def test_flags_convert_eosm_bundled_fpm_matches_jax(tmp_path):
    """An EOS M clip at the odd height 1808x727 takes its bundled focus-pixel
    map, then bad pixels, chroma smoothing, stripes and deflicker."""
    spec = synth.SynthSpec(width=1808, height=727, frames=2, camera_model=0x80000331,
                           camera_name="Canon EOS M")
    ref_dir, port_dir, _, _ = _convert_both(tmp_path, spec, dict(batch_size=2, **ALL_FLAGS))
    assert _tree(port_dir) == _tree(ref_dir)


def test_cal_sidecar_round_trip_between_packages(tmp_path):
    """A .CAL written by one package drives the other: stripe gains and the
    bad-pixel list computed by the port give the reference its DNGs, and the
    other way round."""
    spec = synth.SynthSpec(width=320, height=96, frames=3)
    frames = flagged_frames(spec, np.random.default_rng(3))
    cfg = dict(batch_size=2, fix_stripes=True, fix_bad_pixels=1)
    ref_dir, port_dir, ref_clip, port_clip = _convert_both(tmp_path, spec, cfg, frames)
    assert _tree(port_dir) == _tree(ref_dir)

    # doctor each .CAL (different gains, one more bad pixel), swap them, and
    # reconvert: each package must follow the other's sidecar
    with open(calibration.cal_path(port_clip)) as f:
        cal = json.load(f)
    for key, value in cal.items():
        if key.endswith("/stripes"):
            value["gains"][3] += 900
        elif "/badpix/" in key:
            value["pixels"] += [101, 41]
    for clip in (ref_clip, port_clip):
        with open(calibration.cal_path(clip), "w") as f:
            json.dump(cal, f)
    shutil.rmtree(ref_dir)
    shutil.rmtree(port_dir)
    ref_convert(ref_clip, str(ref_dir), RefConfig(**cfg))
    port_convert(port_clip, str(port_dir), PortConfig(device="cpu", **cfg))
    redone = _tree(port_dir)
    assert redone == _tree(ref_dir)
    shutil.rmtree(port_dir)
    port_convert(port_clip, str(port_dir), PortConfig(device="cpu", use_sidecar_idx=False, **cfg))
    assert _tree(port_dir) != redone  # the doctored sidecar was used
