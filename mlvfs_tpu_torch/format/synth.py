"""Synthetic MLV clip generator.

The reference ships no test fixtures (SURVEY.md section 4); this generator is
the foundation of our verification harness. It writes structurally valid MLV
clips — multi-chunk spills, out-of-order blocks, every bit depth, LZMA
compression, audio, dual-ISO interlacing at any phase — so every layer of the
framework can be tested hermetically and compared against the compiled
reference oracle.
"""

from __future__ import annotations

import dataclasses
import lzma
import numpy as np

from . import mlv
from .bits import pack_bits_np


@dataclasses.dataclass
class SynthSpec:
    width: int = 320
    height: int = 96
    frames: int = 4
    bpp: int = 14
    black: int = 2048
    white: int = 15000
    fps_nom: int = 24000
    fps_denom: int = 1001
    camera_name: str = "Canon EOS 5D Mark III"
    camera_model: int = 0x80000285
    camera_serial: str = "123456789012"
    lens_name: str = "EF50mm f/1.8 II"
    iso: int = 400
    shutter_us: int = 20000
    aperture: int = 180  # f-number * 100
    focal_length: int = 50
    wb_mode: int = mlv.WB_KELVIN
    kelvin: int = 5600
    guid: int = 0xDEADBEEF12345678
    compression: str = "none"  # none | lzma | lj92
    chunks: int = 1  # split VIDFs across .MLV + .M00.. files
    audio: bool = False
    audio_rate: int = 48000
    out_of_order: bool = False  # shuffle block emission order (exercises xref sort)
    dual_iso: int = 0  # 0=off, else EV offset applied to bright rows
    dual_iso_phase: int = 0  # first dark row index (0..3)
    gbrg: bool = False  # shift Bayer phase (exercises identify_rggb_or_gbrg)
    pan_x: int = 0
    pan_y: int = 0
    active_area: tuple = None  # default: full frame
    debug_log: str = ""
    extra_blocks: bool = False  # emit INFO/MARK/STYL/ELVL metadata blocks
    seed: int = 1234


def make_frame_data(spec: SynthSpec, rng: np.random.Generator) -> np.ndarray:
    """Plausible Bayer mosaic test pattern (gradients + shot noise + detail)."""
    h, w = spec.height, spec.width
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    signal = (
        0.45 * (x / w)
        + 0.35 * (y / h)
        + 0.20 * (0.5 + 0.5 * np.sin(x / 7.3) * np.cos(y / 5.1))
    )
    # Bayer channel gains (greens brighter, as in real sensors)
    gains = np.array([[0.8, 1.0], [1.0, 0.6]])
    if spec.gbrg:
        gains = np.array([[1.0, 0.6], [0.8, 1.0]])
    signal = signal * gains[y.astype(int) % 2, x.astype(int) % 2]
    span = spec.white - spec.black
    # dual-ISO clips: scale the scene down so the amplified (bright) rows
    # mostly stay below white — the realistic exposure for interlaced ISO
    scene_scale = 0.9 / (2.0 ** spec.dual_iso) if spec.dual_iso else 0.9
    data = spec.black + signal * span * scene_scale
    data += rng.normal(0, 8, size=data.shape)
    if spec.dual_iso:
        bright = ((y.astype(int) - spec.dual_iso_phase) % 4) >= 2
        data = np.where(
            bright,
            spec.black + (data - spec.black) * (2.0 ** spec.dual_iso),
            data,
        )
    return np.clip(data, 0, (1 << spec.bpp) - 1).astype(np.uint16)


def _lzma_compress_payload(raw_bytes: bytes) -> bytes:
    """VIDF payload for LZMA clips: u32 out_size + 5 props bytes + raw stream.

    Layout per get_image_data (main.c:598-607): LzmaUncompress receives
    props at buf[4:9] and data at buf[9:]. Props = lc/lp/pb byte + u32 dict size.
    """
    lc, lp, pb, dict_size = 3, 0, 2, 1 << 16
    filt = [{"id": lzma.FILTER_LZMA1, "preset": 6, "dict_size": dict_size}]
    comp = lzma.LZMACompressor(format=lzma.FORMAT_ALONE, filters=filt)
    alone = comp.compress(raw_bytes) + comp.flush()
    # FORMAT_ALONE = 5 props bytes + 8-byte uncompressed size + LZMA stream
    props, stream = alone[:5], alone[13:]
    return (
        np.uint32(len(raw_bytes)).tobytes() + props + stream
    )


def write_mlv(path: str, spec: SynthSpec = None, frame_data=None, **kw) -> SynthSpec:
    """Write a synthetic clip. Returns the spec used.

    ``frame_data``: optional (F, H, W) uint16 array; generated if omitted.
    """
    if spec is None:
        spec = SynthSpec(**kw)
    rng = np.random.default_rng(spec.seed)
    if frame_data is None:
        if spec.frames == 0:
            frame_data = np.zeros((0, spec.height, spec.width), np.uint16)
        else:
            frame_data = np.stack([make_frame_data(spec, rng) for _ in range(spec.frames)])
    f, h, w = frame_data.shape

    mlvi = mlv.new_block(mlv.MLVI, b"MLVI")
    mlvi["versionString"] = b"v2.0"
    mlvi["fileGuid"] = spec.guid
    mlvi["fileNum"] = 0
    mlvi["fileCount"] = spec.chunks
    mlvi["videoClass"] = mlv.MLV_VIDEO_CLASS_RAW | (
        mlv.MLV_VIDEO_CLASS_FLAG_LZMA
        if spec.compression == "lzma"
        else mlv.MLV_VIDEO_CLASS_FLAG_LJ92
        if spec.compression == "lj92"
        else 0
    )
    mlvi["audioClass"] = 1 if spec.audio else 0
    mlvi["videoFrameCount"] = f
    mlvi["audioFrameCount"] = f if spec.audio else 0
    mlvi["sourceFpsNom"] = spec.fps_nom
    mlvi["sourceFpsDenom"] = spec.fps_denom

    rawi = mlv.new_block(mlv.RAWI, b"RAWI")
    rawi["xRes"], rawi["yRes"] = w, h
    aa = spec.active_area or (0, 0, h, w)
    ri = mlv.RawInfo(
        width=w,
        height=h,
        pitch=w * spec.bpp // 8,
        frame_size=w * h * spec.bpp // 8,
        bits_per_pixel=spec.bpp,
        black_level=spec.black,
        white_level=spec.white,
        crop_origin=(0, 0),
        crop_size=(w, h),
        active_area=aa,
        dynamic_range=1100,
    )
    rawi["raw_info"] = ri.to_record()

    idnt = mlv.new_block(mlv.IDNT, b"IDNT")
    idnt["cameraName"] = spec.camera_name.encode()
    idnt["cameraModel"] = spec.camera_model
    idnt["cameraSerial"] = spec.camera_serial.encode()

    expo = mlv.new_block(mlv.EXPO, b"EXPO")
    expo["isoMode"], expo["isoValue"], expo["isoAnalog"] = 0, spec.iso, spec.iso
    expo["digitalGain"], expo["shutterValue"] = 0, spec.shutter_us

    lens = mlv.new_block(mlv.LENS, b"LENS")
    lens["focalLength"], lens["focalDist"] = spec.focal_length, 65535
    lens["aperture"] = spec.aperture
    lens["lensName"] = spec.lens_name.encode()
    lens["lensSerial"] = b"0000000000"

    rtci = mlv.new_block(mlv.RTCI, b"RTCI")
    rtci["tm_sec"], rtci["tm_min"], rtci["tm_hour"] = 30, 15, 12
    rtci["tm_mday"], rtci["tm_mon"], rtci["tm_year"] = 15, 5, 115
    rtci["tm_wday"], rtci["tm_yday"] = 1, 165
    rtci["tm_zone"] = b"UTC"

    wbal = mlv.new_block(mlv.WBAL, b"WBAL")
    wbal["wb_mode"], wbal["kelvin"] = spec.wb_mode, spec.kelvin
    wbal["wbgain_r"], wbal["wbgain_g"], wbal["wbgain_b"] = 1024, 1024, 1024

    ts = 1000
    meta_blocks = [rawi, idnt, expo, lens, rtci, wbal]
    if spec.audio:
        wavi = mlv.new_block(mlv.WAVI, b"WAVI")
        wavi["format"], wavi["channels"] = 1, 2
        wavi["samplingRate"] = spec.audio_rate
        wavi["bytesPerSecond"] = spec.audio_rate * 2 * 2
        wavi["blockAlign"], wavi["bitsPerSample"] = 4, 16
        meta_blocks.append(wavi)
    if spec.dual_iso:
        diso = mlv.new_block(mlv.DISO, b"DISO")
        diso["dualMode"], diso["isoValue"] = 1, spec.iso * (1 << spec.dual_iso)
        meta_blocks.append(diso)
    if spec.extra_blocks:
        # auxiliary metadata the reference indexes but does not consume
        # (mlv.h:175-215): exercises skip-unknown paths in index/reader
        info_text = b"synthetic clip\0\0"
        info = mlv.new_block(mlv.INFO, b"INFO")
        info["blockSize"] = mlv.INFO.itemsize + len(info_text)
        mark = mlv.new_block(mlv.MARK, b"MARK")
        mark["type"] = 1
        styl = mlv.new_block(mlv.STYL, b"STYL")
        styl["picStyleId"], styl["picStyleName"] = 1, b"Standard"
        elvl = mlv.new_block(mlv.ELVL, b"ELVL")
        elvl["roll"], elvl["pitch"] = 450, 900
        meta_blocks.extend([(info, info_text), mark, styl, elvl])
    for blk in meta_blocks:
        rec = blk[0] if isinstance(blk, tuple) else blk
        rec["timestamp"] = ts
        ts += 10

    if spec.debug_log:
        text = spec.debug_log.encode()
        pad = (-len(text)) % 4
        debg = mlv.new_block(mlv.DEBG, b"DEBG")
        debg["timestamp"] = ts
        ts += 10
        debg["type"] = 0
        debg["length"] = len(text)
        debg["blockSize"] = mlv.DEBG.itemsize + len(text) + pad
        meta_blocks.append((debg, text + b"\0" * pad))

    # Build per-frame blocks (VIDF, optional AUDF)
    frame_blocks = []  # (timestamp, bytes)
    frame_ts = 100000
    fps = spec.fps_nom / spec.fps_denom
    frame_interval = int(1e6 / fps)
    audio_bytes_per_frame = (spec.audio_rate * 2 * 2 * spec.fps_denom) // spec.fps_nom
    audio_rng = np.random.default_rng(spec.seed + 1)
    for i in range(f):
        pixels = frame_data[i].ravel()
        if spec.compression == "lzma":
            # real LZMA MLVs compress the *packed* bpp bitstream; the reader
            # decompresses then bit-unpacks (main.c:605-611 → dng_get_image_data)
            packed = pack_bits_np(pixels, spec.bpp).astype("<u2").tobytes()
            payload = _lzma_compress_payload(packed)
        elif spec.compression == "lj92":
            # real LJ92 MLV streams store the frame 2D-tiled; the reader
            # undoes it after decode (main.c:652-668)
            from ..codecs import lj92 as lj92_codec

            fr = frame_data[i]
            hh, ww = fr.shape
            fy = (2 * np.arange(hh)) % hh + (2 * np.arange(hh)) // hh
            fx = (2 * np.arange(ww)) % ww + (2 * np.arange(ww)) // ww
            tiled = fr[fy][:, fx]
            stream = lj92_codec.encode(tiled, ncomp=1, bits=spec.bpp)
            payload = np.uint32(hh * ww * 2).tobytes() + stream
        else:
            payload = pack_bits_np(pixels, spec.bpp).astype("<u2").tobytes()
        vidf = mlv.new_block(mlv.VIDF, b"VIDF")
        vidf["timestamp"] = frame_ts + i * frame_interval
        vidf["frameNumber"] = i
        vidf["panPosX"], vidf["panPosY"] = spec.pan_x, spec.pan_y
        vidf["cropPosX"], vidf["cropPosY"] = spec.pan_x & ~7, spec.pan_y & ~1
        vidf["frameSpace"] = 0
        vidf["blockSize"] = mlv.VIDF.itemsize + len(payload)
        frame_blocks.append((int(vidf["timestamp"]), vidf.tobytes() + payload))
        if spec.audio:
            samples = (audio_rng.normal(0, 2000, audio_bytes_per_frame // 2)).astype("<i2")
            audf = mlv.new_block(mlv.AUDF, b"AUDF")
            audf["timestamp"] = frame_ts + i * frame_interval + 1
            audf["frameNumber"] = i
            audf["frameSpace"] = 0
            audf["blockSize"] = mlv.AUDF.itemsize + samples.nbytes
            frame_blocks.append((int(audf["timestamp"]), audf.tobytes() + samples.tobytes()))

    meta_bytes = []
    for blk in meta_blocks:
        if isinstance(blk, tuple):
            rec, extra = blk
            meta_bytes.append((int(rec["timestamp"]), rec.tobytes() + extra))
        else:
            meta_bytes.append((int(blk["timestamp"]), blk.tobytes()))

    if spec.out_of_order:
        order_rng = np.random.default_rng(spec.seed + 2)
        order_rng.shuffle(frame_blocks)

    # split across chunks: meta + first part of frames in .MLV, rest in .M00..
    per_chunk = max(1, (len(frame_blocks) + spec.chunks - 1) // spec.chunks)
    chunk_paths = [path] + [f"{path[:-2]}{i:02d}" for i in range(spec.chunks - 1)]
    for ci, cpath in enumerate(chunk_paths):
        hdr = mlvi.copy()
        hdr["fileNum"] = ci
        with open(cpath, "wb") as out:
            out.write(hdr.tobytes())
            if ci == 0:
                for _, b in meta_bytes:
                    out.write(b)
            for _, b in frame_blocks[ci * per_chunk : (ci + 1) * per_chunk]:
                out.write(b)
    return spec
