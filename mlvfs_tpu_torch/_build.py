"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` (plus its own
``EXTRA_FLAGS``) into a shared library with a plain C entry point and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``mlvfs_tpu_torch/build/``
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt at its next use and a stale library is never loaded.

Nothing is built at import: the first call of :func:`library` builds (or
finds) the library. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Sources whose float arithmetic must round as their plain twins do: nvcc
# contracts a multiply feeding an add into an FMA unless told not to, and
# these fuse (``__fmaf_rn``) only where their twins fuse.
EXTRA_FLAGS = {
    "amaze": ("-fmad=false",),
    "amaze_scans": ("-fmad=false",),
}


def flags(name: str) -> tuple:
    """nvcc flags of csrc/<name>.cu."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

# C signatures of the entry points, per source file
_SIGNATURES = {
    "unpack": {
        "mlvfs_unpack": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # words u16 (batch, n_words)
                ctypes.c_void_p,  # out u16 (batch, n_pixels)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # n_words
                ctypes.c_longlong,  # n_pixels
                ctypes.c_int,  # bpp
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "chroma": {
        "mlvfs_chroma_smooth": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # imgs u16 (batch, height, width)
                ctypes.c_void_p,  # out u16 (batch, height, width)
                ctypes.c_void_p,  # raw2ev int32[65536]
                ctypes.c_void_p,  # ev2raw int32[14 * 32768]
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height
                ctypes.c_longlong,  # width
                ctypes.c_int,  # method (2, 3 or 5)
                ctypes.c_int,  # black
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "patternnoise": {
        "mlvfs_pn_blur_interleaved": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # img int32 (batch, height, width)
                ctypes.c_void_p,  # out int32 (batch, height, width)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height (even)
                ctypes.c_longlong,  # width (even)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_pn_blur_split": (
            ctypes.c_int,
            [
                *[ctypes.c_void_p] * 4,  # r, g1, g2, b int32 (batch, height/2, width/2)
                *[ctypes.c_void_p] * 4,  # their smoothed outputs, same shape
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height of the Bayer frame (even)
                ctypes.c_longlong,  # width of the Bayer frame (even)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "dualiso_preview": {
        "mlvfs_dualiso_preview": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # imgs u16 (batch, height, width)
                ctypes.c_void_p,  # out u16 (batch, height, width)
                ctypes.c_void_p,  # a float32 (batch,)
                ctypes.c_void_p,  # b float32 (batch,)
                ctypes.c_void_p,  # shadow float32 (batch,)
                ctypes.c_void_p,  # dark_row_start int32 (batch,)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height
                ctypes.c_longlong,  # width
                ctypes.c_int,  # black
                ctypes.c_int,  # white
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "amaze": {
        "mlvfs_amaze_stage": (
            ctypes.c_int,
            [
                ctypes.c_int,  # stage group 1..5
                ctypes.c_void_p,  # workspace float32 (N_PLANES, batch, hp, wp)
                *[ctypes.c_void_p] * 3,  # red, green, blue float32 (batch, hp - 32, wp - 32)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # hp (padded height)
                ctypes.c_longlong,  # wp (padded width, even)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "amaze_scans": {
        **{fn: (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # in (batch, hp, wp), float32 or int32 (dilate)
                ctypes.c_void_p,  # out, the same
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # hp
                ctypes.c_longlong,  # wp (even)
                ctypes.c_longlong,  # tiles of the 160/128 grid
                ctypes.c_void_p,  # cudaStream_t
            ],
        ) for fn in ("mlvfs_amaze_refine", "mlvfs_amaze_dilate")},
        "mlvfs_amaze_chroma": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # in float32 (batch, hp, wp)
                ctypes.c_void_p,  # out float32 (batch, hp, wp)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # hp
                ctypes.c_longlong,  # wp (even)
                ctypes.c_longlong,  # tiles of the 160/128 grid
                ctypes.c_int,  # the parity of the rows it updates
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "amaze_edge": {
        "mlvfs_amaze_edge_pick": (
            ctypes.c_int,
            [
                *[ctypes.c_void_p] * 3,  # evgray, EW_a, EW_b int32 (batch, height, width)
                ctypes.c_void_p,  # row signs int32 (batch, height)
                ctypes.c_void_p,  # restricted bool (batch, height, width)
                ctypes.c_void_p,  # out int32 (batch, height, width)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height
                ctypes.c_longlong,  # width
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "alias": {
        "mlvfs_alias_filter": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # alias int32 (batch, height, width), rows contiguous
                ctypes.c_void_p,  # skip bool (batch, height, width), rows contiguous
                ctypes.c_void_p,  # out int32 (batch, height, width)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # height
                ctypes.c_longlong,  # width
                ctypes.c_longlong,  # alias frame stride (elements)
                ctypes.c_longlong,  # skip frame stride (elements)
                ctypes.c_longlong,  # out frame stride (elements)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
}

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); cannot build CUDA kernels")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    with open(os.path.join(SRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile(name: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags(name), "-o", tmp, os.path.join(SRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name}.cu (rc={proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file


def build_all() -> None:
    """Build every kernel source that has no library yet, one nvcc process
    per source, all started together, and bind them all."""
    missing = [n for n in _SIGNATURES if not os.path.isfile(library_path(n))]
    if missing:
        with concurrent.futures.ThreadPoolExecutor(len(missing)) as pool:
            list(pool.map(lambda n: _compile(n, library_path(n)), missing))
    for name in _SIGNATURES:
        library(name)


def library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.isfile(path):
            _compile(name, path)
        lib = ctypes.CDLL(path)
        for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
        return lib
