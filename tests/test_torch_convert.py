"""The port's default convert path (device="cpu") vs mlvfs_tpu on CPU JAX.

Every stage of the path is integer, so the DNG trees must be byte-identical:
same file names, same headers, same payloads. (The shared WAV emitter draws
a random BWF originator reference, so `random` is seeded before each
conversion.)
"""

import os
import random

import numpy as np
import pytest

from mlvfs_tpu.format import synth
from mlvfs_tpu.format.reader import MLVClip
from mlvfs_tpu.pipeline import calibration as ref_calibration
from mlvfs_tpu.pipeline import kernels as ref_kernels
from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu.pipeline.convert import convert_clip as ref_convert
from mlvfs_tpu_torch.pipeline import calibration as port_calibration
from mlvfs_tpu_torch.pipeline import kernels as port_kernels
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig as PortConfig
from mlvfs_tpu_torch.pipeline.convert import ClipConverter, convert_clip as port_convert


def _tree(outdir):
    out = {}
    for name in sorted(os.listdir(outdir)):
        with open(os.path.join(outdir, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_same_tree(ref_dir, port_dir):
    ref, port = _tree(ref_dir), _tree(port_dir)
    assert list(port) == list(ref)
    for name in ref:
        assert port[name] == ref[name], f"{name} differs"


def _write_fpm(dirpath, camera, w, h, rng):
    """A focus-pixel map with interior, edge and off-frame entries."""
    xs = np.concatenate([rng.integers(0, w + 16, 300), [0, 1, 2, w - 1, w + 5, -3]])
    ys = np.concatenate([rng.integers(0, h + 4, 300), [5, 0, h - 1, 9, 2, 7]])
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "%x_%ix%i.fpm" % (camera, w, h)), "w") as f:
        for x, y in zip(xs, ys):
            f.write(f"{x} \t {y}\n")


# (synth kwargs, shared config kwargs); 5 frames at batch 2 leaves a tail batch
CASES = {
    # 326x94: partial last block at 10/12/14 bpp, odd payload bytes at 10 bpp
    "bpp8": (dict(width=326, height=94, bpp=8), {}),
    "bpp10": (dict(width=326, height=94, bpp=10), {}),
    "bpp12": (dict(width=326, height=94, bpp=12), {}),
    "bpp14": (dict(width=326, height=94, bpp=14), {}),
    "lzma": (dict(compression="lzma"), {}),
    "lj92": (dict(compression="lj92"), {}),
    "chunks_out_of_order": (dict(chunks=3, out_of_order=True), {}),
    "fpm_with_pan": (dict(camera_model=0x80000331, pan_x=3, pan_y=1), dict(focus_pixel_dir="fpm")),
    "compress_dng": (dict(), dict(compress="lj92")),
    "resolve_naming": (dict(), dict(name_scheme=1)),
    "all_sidecars": (dict(audio=True, debug_log="dbg line\n"), dict(export_all=True)),
    "batch_one_prefetch_one": (dict(frames=3), dict(batch_size=1, prefetch=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_convert_matches_jax(case, tmp_path):
    synth_kw, cfg_kw = CASES[case]
    synth_kw = dict(dict(width=320, height=96, frames=5), **synth_kw)
    cfg_kw = dict(dict(batch_size=2), **cfg_kw)
    if "focus_pixel_dir" in cfg_kw:
        cfg_kw["focus_pixel_dir"] = str(tmp_path / "fpm")
        _write_fpm(cfg_kw["focus_pixel_dir"], synth_kw["camera_model"], synth_kw["width"],
                   synth_kw["height"], np.random.default_rng(5))
    src = str(tmp_path / "CLIP.MLV")
    synth.write_mlv(src, **synth_kw)
    random.seed(7)
    ref_paths = ref_convert(src, str(tmp_path / "ref"), RefConfig(**cfg_kw))
    random.seed(7)
    port_paths = port_convert(src, str(tmp_path / "port"), PortConfig(device="cpu", **cfg_kw))
    assert [os.path.basename(p) for p in port_paths] == [os.path.basename(p) for p in ref_paths]
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")


def test_convert_bundled_fpm_matches_jax(tmp_path):
    """An EOS M clip at 1808x727 takes the bundled 13k-entry focus-pixel map."""
    src = str(tmp_path / "EOSM.MLV")
    synth.write_mlv(src, width=1808, height=727, frames=2, camera_model=0x80000331,
                    camera_name="Canon EOS M")
    ref_convert(src, str(tmp_path / "ref"), RefConfig(batch_size=2))
    port_convert(src, str(tmp_path / "port"), PortConfig(device="cpu", batch_size=2))
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")
    raw = np.frombuffer(_tree(tmp_path / "port")["EOSM_000000.dng"], "<u2", offset=65536)
    spec = synth.SynthSpec(width=1808, height=727, camera_model=0x80000331)
    frame0 = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    assert (raw.reshape(727, 1808) != frame0).sum() > 10000  # the fix ran


def test_convert_resume_matches_jax(tmp_path):
    """--resume keeps existing DNGs untouched and fills in the rest."""
    src = str(tmp_path / "CLIP.MLV")
    synth.write_mlv(src, width=320, height=96, frames=6)
    for name, convert, config in [("ref", ref_convert, RefConfig), ("port", port_convert, PortConfig)]:
        kw = dict(device="cpu") if name == "port" else {}
        out = str(tmp_path / name)
        first = convert(src, out, config(batch_size=4, **kw), frames=range(1, 4))
        stamps = {p: os.stat(p).st_mtime_ns for p in first}
        paths = convert(src, out, config(batch_size=4, resume=True, **kw))
        assert len(paths) == 6
        for p in first:
            assert os.stat(p).st_mtime_ns == stamps[p]
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")


def test_cal_sidecar_interchange(tmp_path):
    """A .CAL written by either package is read by the other, and both write
    the same bytes for the same state."""
    gains = np.array([65536, 65000, 66000, 65536, 64000, 65536, 65100, 65536], np.int32)
    pixels = np.array([[10, 20], [30, 40], [55, 66]], np.int64)
    ref_cfg = RefConfig(fix_stripes=True, fix_bad_pixels=2)
    port_cfg = PortConfig(fix_stripes=True, fix_bad_pixels=2, device="cpu")

    def fill(cal):
        cal.stripes_gains, cal.stripes_needed, cal.stripes_done = gains, True, True
        cal.bad_pixel_list, cal.bad_pixels_done = pixels, True
        return cal

    a, b = str(tmp_path / "A.MLV"), str(tmp_path / "B.MLV")
    ref_calibration.save_from(fill(ref_kernels.ClipCalibration()), a, 0x1234, ref_cfg)
    port_calibration.save_from(fill(port_kernels.ClipCalibration()), b, 0x1234, port_cfg)
    with open(ref_calibration.cal_path(a), "rb") as fa, open(port_calibration.cal_path(b), "rb") as fb:
        assert fa.read() == fb.read()

    for writer_path, reader, cal, cfg in [
        (a, port_calibration, port_kernels.ClipCalibration(), port_cfg),
        (b, ref_calibration, ref_kernels.ClipCalibration(), ref_cfg),
    ]:
        reader.load_into(cal, writer_path, 0x1234, cfg)
        assert cal.stripes_done and cal.stripes_needed and cal.bad_pixels_done
        np.testing.assert_array_equal(cal.stripes_gains, gains)
        np.testing.assert_array_equal(cal.bad_pixel_list, pixels)


def test_calibration_from_reference_drives_the_port(tmp_path):
    """The JAX package's per-clip state, carried across, gives the port the
    same DNGs as the reference."""
    fpm = str(tmp_path / "fpm")
    _write_fpm(fpm, 0x80000331, 320, 96, np.random.default_rng(9))
    src = str(tmp_path / "CLIP.MLV")
    synth.write_mlv(src, width=320, height=96, frames=3, camera_model=0x80000331)
    ref_convert(src, str(tmp_path / "ref"), RefConfig(batch_size=2, focus_pixel_dir=fpm))

    with MLVClip(src) as clip:
        ref_cal = ref_kernels.calibrate_clip(clip.frame_headers(0), RefConfig(focus_pixel_dir=fpm))
        cal = port_kernels.calibration_from_reference(ref_cal)
        assert cal.focus_pixel_list is not ref_cal.focus_pixel_list
        np.testing.assert_array_equal(cal.focus_pixel_list, ref_cal.focus_pixel_list)
        assert cal.focus_done
        # no focus_pixel_dir here: the list comes only from the carried state
        conv = ClipConverter(clip, PortConfig(device="cpu", batch_size=2, use_sidecar_idx=False))
        try:
            conv._calibration = cal
            conv.convert(str(tmp_path / "port"))
        finally:
            conv.close()
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")


def test_cli_info_and_convert_match_jax(tmp_path, capsys):
    from mlvfs_tpu import cli as ref_cli
    from mlvfs_tpu_torch import cli as port_cli

    clips = tmp_path / "clips"
    clips.mkdir()
    for name, kw in [("A1.MLV", dict(audio=True)), ("A2.MLV", dict(bpp=12, chunks=2))]:
        synth.write_mlv(str(clips / name), width=128, height=32, frames=3, **kw)

    assert ref_cli.main(["info", str(clips)]) == 0
    ref_info = capsys.readouterr().out
    assert port_cli.main(["info", str(clips)]) == 0
    assert capsys.readouterr().out == ref_info
    assert "A2.MLV" in ref_info and "12bpp" in ref_info

    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    random.seed(7)
    assert ref_cli.main(["convert", f"--mlv-dir={clips}", "-o", ref_out, "--all"]) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    random.seed(7)
    assert port_cli.main(["convert", f"--mlv-dir={clips}", "-o", port_out, "--all",
                          "--device", "cpu", "-v"]) == 0
    port_lines = capsys.readouterr().out.replace(port_out, ref_out).splitlines()
    # same "converting" lines; the "done" line carries a wall time
    assert port_lines[: len(ref_lines) - 1] == ref_lines[:-1]
    assert port_lines[len(ref_lines) - 1].startswith("done: 6 frames in ")
    assert any("readback" in line for line in port_lines)
    for sub in ("A1", "A2"):
        _assert_same_tree(os.path.join(ref_out, sub), os.path.join(port_out, sub))
