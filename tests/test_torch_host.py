"""The port's own host layer (format, emit, codecs, .fpm maps, the EV tables
and the host dual-ISO analysis) gives the same bytes as the reference
package's modules it was copied from."""

import ast
import os
import random

import numpy as np
import pytest

from mlvfs_tpu import codecs as ref_codecs
from mlvfs_tpu.emit import dng as ref_dng
from mlvfs_tpu.emit import gif as ref_gif
from mlvfs_tpu.emit import wav as ref_wav
from mlvfs_tpu.format import reader as ref_reader
from mlvfs_tpu.format import synth as ref_synth
from mlvfs_tpu_torch import codecs as port_codecs
from mlvfs_tpu_torch.emit import dng as port_dng
from mlvfs_tpu_torch.emit import gif as port_gif
from mlvfs_tpu_torch.emit import wav as port_wav
from mlvfs_tpu_torch.format import reader as port_reader
from mlvfs_tpu_torch.format import synth as port_synth
from mlvfs_tpu_torch.ops import luts as port_luts
from mlvfs_tpu_torch.ops import pixels as port_pixels

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYNTH_CASES = {
    "plain": dict(),
    "bpp12_audio_log": dict(bpp=12, audio=True, debug_log="line one\nline two\n"),
    "lzma_chunks_out_of_order": dict(compression="lzma", chunks=3, out_of_order=True),
    "lj92_pan_extra_blocks": dict(compression="lj92", pan_x=3, pan_y=1, extra_blocks=True),
}


def _read_all(path):
    """Every file of a clip (all chunks), by name."""
    d = os.path.dirname(path)
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_synth_and_reader_match_reference(case, tmp_path):
    """The copied synth writes the same clip bytes, and the copied reader
    gives the same frame headers and payloads."""
    kw = dict(width=96, height=32, frames=4, **SYNTH_CASES[case])
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_path, port_path = str(tmp_path / "ref" / "C.MLV"), str(tmp_path / "port" / "C.MLV")
    ref_synth.write_mlv(ref_path, **kw)
    port_synth.write_mlv(port_path, **kw)
    assert _read_all(port_path) == _read_all(ref_path)

    with ref_reader.MLVClip(ref_path, use_sidecar=False) as a, \
            port_reader.MLVClip(ref_path, use_sidecar=False) as b:
        assert (b.frame_count, b.audio_frame_count, b.has_audio) == (
            a.frame_count, a.audio_frame_count, a.has_audio)
        assert b.debug_log() == a.debug_log()
        for i in range(a.frame_count):
            fa, fb = a.frame_headers(i), b.frame_headers(i)
            for block in ("expo", "lens", "wbal", "rtci", "idnt", "vidf", "rawi"):
                assert getattr(fb, block).tobytes() == getattr(fa, block).tobytes(), (i, block)
            assert bytes(b.frame_payload(i)) == bytes(a.frame_payload(i))


def test_dng_header_render_matches_reference(tmp_path):
    """Template renders with deflicker BaselineExposure and per-frame levels,
    and the full build, byte for byte; the Software tag stays "MLVFS"."""
    src = str(tmp_path / "C.MLV")
    ref_synth.write_mlv(src, width=128, height=48, frames=3)
    with port_reader.MLVClip(src) as clip:
        for compression, strip in (("none", None), ("lj92", 12345)):
            fh = clip.frame_headers(0)
            ref_tpl = ref_dng.DNGHeaderTemplate(fh, 23.976, "C", compression=compression,
                                                strip_byte_count=strip)
            port_tpl = port_dng.DNGHeaderTemplate(fh, 23.976, "C", compression=compression,
                                                  strip_byte_count=strip)
            for i in range(clip.frame_count):
                fh = clip.frame_headers(i)
                for kw in (dict(), dict(black_level=8192, white_level=60000,
                                        exposure_bias=(-3219, 10000), strip_byte_count=strip)):
                    assert port_tpl.render(fh, **kw) == ref_tpl.render(fh, **kw)
                assert port_dng.build_dng_header(fh, 0.0, "C") == ref_dng.build_dng_header(fh, 0.0, "C")
        header = port_dng.build_dng_header(clip.frame_headers(0), 0.0, "C")
        assert b"MLVFS\0" in header


def test_wav_and_gif_match_reference(tmp_path):
    src = str(tmp_path / "C.MLV")
    ref_synth.write_mlv(src, width=128, height=48, frames=5, audio=True)
    with port_reader.MLVClip(src) as clip:
        random.seed(11)
        want = ref_wav.build_wav(clip)
        random.seed(11)
        assert port_wav.build_wav(clip) == want
        assert port_wav.wav_size(clip) == ref_wav.wav_size(clip) == len(want)

        rng = np.random.default_rng(2)
        frames = {i: rng.integers(0, 1 << 14, (48, 128)).astype(np.uint16)
                  for i in port_gif.gif_frame_ids(clip.frame_count)}
        assert port_gif.gif_frame_ids(clip.frame_count) == ref_gif.gif_frame_ids(clip.frame_count)
        gif = port_gif.build_gif(clip, decode_fn=frames.__getitem__)
        assert gif == ref_gif.build_gif(clip, decode_fn=frames.__getitem__)
        assert len(gif) == port_gif.gif_size(128, 48)


def test_lj92_codec_matches_reference():
    """The port's own build of the codec encodes and decodes a seeded batch
    to the same bytes and samples as the reference's."""
    rng = np.random.default_rng(92)
    imgs = rng.integers(0, 1 << 14, (3, 24, 40)).astype(np.uint16)
    strips = port_codecs.lj92.encode_batch(imgs, ncomp=2, bits=16)
    assert strips == ref_codecs.lj92.encode_batch(imgs, ncomp=2, bits=16)
    assert port_codecs.lj92.encode(imgs[0], ncomp=2, bits=16) == strips[0]
    samples, rcs = port_codecs.lj92.decode_batch(strips, 24 * 40)
    ref_samples, ref_rcs = ref_codecs.lj92.decode_batch(strips, 24 * 40)
    np.testing.assert_array_equal(rcs, ref_rcs)
    np.testing.assert_array_equal(samples, ref_samples)
    np.testing.assert_array_equal(samples.reshape(imgs.shape), imgs)
    # built inside the port's own build directory, never beside the reference
    lib = port_codecs.lj92._LIB
    assert os.path.isfile(lib)
    assert os.path.dirname(lib) == os.path.join(_REPO, "mlvfs_tpu_torch", "build")


def test_bundled_fpm_maps_are_the_reference_maps():
    ref_dir = os.path.join(_REPO, "mlvfs_tpu", "data")
    names = sorted(n for n in os.listdir(ref_dir) if n.endswith(".fpm"))
    assert len(names) == 16
    assert sorted(n for n in os.listdir(port_pixels._DATA_DIR) if n.endswith(".fpm")) == names
    for n in names:
        with open(os.path.join(ref_dir, n), "rb") as a, \
                open(os.path.join(port_pixels._DATA_DIR, n), "rb") as b:
            assert a.read() == b.read(), n


@pytest.mark.parametrize("black, white", [(2048 * 64, 15000 * 64), (2047 * 64, 10000 * 64)])
def test_20bit_tables_are_the_reference_tables(black, white):
    """The 20-bit raw↔EV tables and the fullres curve, byte for byte."""
    from mlvfs_tpu.ops import luts as ref_luts

    for name in ("raw2ev_lut20", "ev2raw_lut20"):
        got, want = getattr(port_luts, name)(black, white), getattr(ref_luts, name)(black, white)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    assert port_luts.fullres_curve(black).tobytes() == ref_luts.fullres_curve(black).tobytes()


def test_host_dual_iso_analysis_is_a_copy():
    """mlvfs_tpu_torch/ops/dualiso_analysis.py is the reference's module but
    for its docstring: the same code, statement for statement."""

    def body(path):
        tree = ast.parse(open(path, encoding="utf-8").read())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(os.path.join(_REPO, "mlvfs_tpu_torch", "ops", "dualiso_analysis.py")) == \
        body(os.path.join(_REPO, "mlvfs_tpu", "ops", "dualiso_analysis.py"))
