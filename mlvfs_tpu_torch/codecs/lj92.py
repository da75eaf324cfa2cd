"""ctypes bindings for the native LJ92 codec (mlvfs_tpu_torch/csrc/lj92.cpp).

Builds the shared library with g++ on first use, into the package's
git-ignored ``build/`` directory. The
decoder serves LJ92-compressed MLV frames (MLV_VIDEO_CLASS_FLAG_LJ92,
mlv.h:30; decode call site main.c:617-681); the encoder produces
lossless-compressed CinemaDNG strips (the reference ships an encoder it
never calls — lj92.c:1104 — which the compressed-DNG output config needs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "lj92.cpp")
_LIB = os.path.join(_PKG_DIR, "build", "liblj92.so")
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17", "-pthread", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _LIB)  # atomic: a concurrent build never loads a partial file
        lib = ctypes.CDLL(_LIB)
        lib.lj92_decode_buf.restype = ctypes.c_int
        lib.lj92_decode_buf.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        lib.lj92_decode_batch_buf.restype = ctypes.c_int
        lib.lj92_decode_batch_buf.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_void_p,  # offsets u64[n]
            ctypes.c_void_p,  # lens u64[n]
            ctypes.c_int,     # n_frames
            ctypes.c_void_p,  # out u16[n*frame_samples]
            ctypes.c_uint64,  # frame_samples
            ctypes.c_void_p,  # dims i32[4]
            ctypes.c_void_p,  # rcs i32[n]
            ctypes.c_int,     # n_threads (0 = hw concurrency)
        ]
        lib.lj92_encode_batch_buf.restype = ctypes.c_int
        lib.lj92_encode_batch_buf.argtypes = [
            ctypes.c_void_p,  # imgs u16[n*frame_px]
            ctypes.c_int,     # n_frames
            ctypes.c_int,     # width
            ctypes.c_int,     # height
            ctypes.c_int,     # ncomp
            ctypes.c_int,     # bits
            ctypes.c_void_p,  # out u8[n*per_cap]
            ctypes.c_uint64,  # per_cap
            ctypes.c_void_p,  # lens i64[n]
            ctypes.c_int,     # n_threads (0 = hw concurrency)
        ]
        lib.lj92_encode_buf.restype = ctypes.c_long
        lib.lj92_encode_buf.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def decode(data: bytes, max_pixels: int = 1 << 26):
    """Decode an LJ92 stream → (samples uint16 [h, w*ncomp], width, height,
    bits, ncomp). Raises ValueError on corrupt streams."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(max_pixels, np.uint16)
    dims = (ctypes.c_int * 4)()
    rc = lib.lj92_decode_buf(
        buf.ctypes.data_as(ctypes.c_void_p),
        len(buf),
        out.ctypes.data_as(ctypes.c_void_p),
        max_pixels,
        dims,
    )
    if rc != 0:
        raise ValueError(f"LJ92 decode failed ({rc})")
    w, h, bits, ncomp = dims[0], dims[1], dims[2], dims[3]
    return out[: w * h * ncomp].reshape(h, w * ncomp).copy(), w, h, bits, ncomp


def decode_batch(streams, frame_samples: int, n_threads: int = 0):
    """Decode N LJ92 streams in one native call, fanned over hardware threads.

    ``streams``: sequence of bytes-like objects. Returns (out, rcs) where
    ``out`` is (N, frame_samples) uint16 (bad frames zeroed) and ``rcs`` the
    per-frame status codes (0 = ok). One ctypes round-trip per batch; within
    a stream Huffman decode is sequential, so parallelism is across frames.
    """
    lib = _load()
    n = len(streams)
    out = np.zeros((max(n, 1), frame_samples), np.uint16)
    rcs = np.full(max(n, 1), -99, np.int32)
    if n == 0:
        return out[:0], rcs[:0]
    lens = np.array([len(s) for s in streams], np.uint64)
    offsets = np.zeros(n, np.uint64)
    np.cumsum(lens[:-1], out=offsets[1:])
    blob = np.empty(int(lens.sum()), np.uint8)
    for i, s in enumerate(streams):
        blob[int(offsets[i]) : int(offsets[i] + lens[i])] = np.frombuffer(s, np.uint8)
    dims = (ctypes.c_int * 4)()
    lib.lj92_decode_batch_buf(
        blob.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        n,
        out.ctypes.data_as(ctypes.c_void_p),
        frame_samples,
        dims,
        rcs.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    return out, rcs


def encode(samples: np.ndarray, ncomp: int = 1, bits: int = 16) -> bytes:
    """Encode (h, w*ncomp) uint16 samples as SOF3 predictor-1 lossless JPEG."""
    samples = np.ascontiguousarray(samples, np.uint16)
    h, row = samples.shape
    assert row % ncomp == 0
    w = row // ncomp
    lib = _load()
    cap = samples.size * 3 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.lj92_encode_buf(
        samples.ctypes.data_as(ctypes.c_void_p),
        w,
        h,
        ncomp,
        bits,
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if n < 0:
        raise ValueError(f"LJ92 encode failed ({n})")
    return out[:n].tobytes()


def encode_batch(imgs: np.ndarray, ncomp: int = 1, bits: int = 16,
                 n_threads: int = 0):
    """Encode N same-shaped (H, W*ncomp) u16 frames in one native call,
    fanned over hardware threads. Returns a list of per-frame streams,
    byte-identical to per-frame encode() (each frame gets its own optimal
    Huffman table). Raises ValueError if any frame fails."""
    imgs = np.ascontiguousarray(imgs, np.uint16)
    n, h, row = imgs.shape
    assert row % ncomp == 0
    w = row // ncomp
    if n == 0:
        return []
    lib = _load()
    per_cap = h * row * 3 + 4096
    out = np.empty((n, per_cap), np.uint8)
    lens = np.zeros(n, np.int64)
    lib.lj92_encode_batch_buf(
        imgs.ctypes.data_as(ctypes.c_void_p),
        n, w, h, ncomp, bits,
        out.ctypes.data_as(ctypes.c_void_p),
        per_cap,
        lens.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if (lens < 0).any():
        raise ValueError(f"LJ92 batch encode failed: {lens.tolist()}")
    return [out[i, : lens[i]].tobytes() for i in range(n)]


def encode_bayer_dng_strip(img: np.ndarray, bits: int = 16) -> bytes:
    """Encode a Bayer mosaic (H, W) as the 2-component interleaved layout
    DNG writers use (each component one CFA column parity, predictor 1)."""
    return encode(img, ncomp=2, bits=bits)
