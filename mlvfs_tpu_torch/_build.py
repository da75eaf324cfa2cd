"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` (plus its own
``EXTRA_FLAGS``) into a shared library with a plain C entry point and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``mlvfs_tpu_torch/build/``
under a name that carries a hash of the source, of the ``csrc/`` headers it
includes (``#include "x.cuh"``, followed through the headers) and of the
flags, so an edited source or header is rebuilt at its next use and a stale
library is never loaded.

Nothing is built at import: the first call of :func:`library` builds (or
finds) the library. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers and spills, kept beside the library
)
# Sources whose float arithmetic must round as their plain twins do: nvcc
# contracts a multiply feeding an add into an FMA unless told not to, and
# these fuse (``__fmaf_rn``) only where their twins fuse.
EXTRA_FLAGS = {
    "amaze": ("-fmad=false",),
    "amaze_scans": ("-fmad=false",),
    "amaze_mega": ("-fmad=false",),
    "dualiso_preview_fit": ("-fmad=false",),
    "evmath": ("-fmad=false",),
    "dualiso_recon": ("-fmad=false",),
    "dualiso_scores": ("-fmad=false",),
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
                ctypes.c_void_p,  # ev2raw packed uint16[8192] (chroma_smooth.ev2raw_octave)
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
        "mlvfs_pn_blur_ops": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # img int32 (batch, height, width)
                ctypes.c_void_p,  # out int32 (batch, height, width)
                ctypes.c_void_p,  # uint64 operation count, added to
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
    "dualiso_preview_fit": {
        "mlvfs_preview_fit": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # sorted samples int32 (batch, 4, length), padded with white + 1
                ctypes.c_void_p,  # cdf scratch int32 (batch, length)
                ctypes.c_void_p,  # ok bool (batch,)
                ctypes.c_void_p,  # a float32 (batch,)
                ctypes.c_void_p,  # b float32 (batch,)
                ctypes.c_void_p,  # shadow int32 (batch,)
                ctypes.c_void_p,  # dark_row_start int32 (batch,)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # length
                *[ctypes.c_int] * 4,  # each phase's median rank
                *[ctypes.c_int] * 4,  # each phase's real sample count
                ctypes.c_int,  # black
                ctypes.c_int,  # white
                ctypes.c_longlong,  # total (phase 0's stored count)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    # a probe beside the fit kernel, on no convert path: the L2 latency of
    # a dependent load, for the fit walk's chain bound in chip_smoke.py
    "l2_chase_probe": {
        "mlvfs_l2_chase": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # ring int32 (n,): next index of each entry
                ctypes.c_longlong,  # hops
                ctypes.c_void_p,  # out int32 (1,)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "amaze": {
        "mlvfs_amaze_stage": (
            ctypes.c_int,
            [
                ctypes.c_int,  # stage group 1..5
                ctypes.c_void_p,  # workspace float32 (N_SPLIT, batch, hp, wp), enum SplitSlot
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
        "mlvfs_amaze_chroma2": (
            ctypes.c_int,
            [
                *[ctypes.c_void_p] * 2,  # in0 (G-R), in1 (G-B) float32 (batch, hp, wp)
                *[ctypes.c_void_p] * 2,  # out0 (rows of parity 1 updated), out1 (parity 0)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # hp
                ctypes.c_longlong,  # wp (even)
                ctypes.c_longlong,  # tiles of the 160/128 grid
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "amaze_mega": {
        "mlvfs_amaze_mega": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # raw float32 (batch, h, w), 0..65535 scale
                ctypes.c_void_p,  # workspace float32 (N_SPLIT, batch, h + 32, w + 32), enum SplitSlot
                *[ctypes.c_void_p] * 3,  # red, green, blue float32 (batch, h, w)
                ctypes.c_longlong,  # batch
                ctypes.c_longlong,  # h
                ctypes.c_longlong,  # w (even)
                ctypes.c_longlong,  # tiles of the 160/128 grid of the padded height
                ctypes.c_float,  # float32(1 / 65535)
                ctypes.c_void_p,  # int64 step stamps on the device, or None
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_amaze_mega_plan": (
            ctypes.c_int,
            [
                ctypes.c_longlong,  # h
                ctypes.c_longlong,  # w (even)
                ctypes.c_void_p,  # int64[6] out, on the host
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
                ctypes.c_int,  # direct_per_row: a tile's form threshold
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "evmath": {
        # out, element count, then (d1, d2) of the merged dimensions and each
        # operand as (pointer or NULL, kind, value, three strides), ops/evmath.py:
        # plan_operands
        "mlvfs_ev_fma": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # out float32
                *[ctypes.c_longlong] * 3,  # n, d1, d2
                *[ctypes.c_void_p, ctypes.c_int, ctypes.c_float, *[ctypes.c_longlong] * 3] * 3,  # x, y, z
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_ev_log2_add": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # out float32
                *[ctypes.c_longlong] * 3,  # n, d1, d2
                ctypes.c_void_p,  # x float32, the result's shape, contiguous
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float, *[ctypes.c_longlong] * 3,  # c
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        **{"mlvfs_ev_" + fn: (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # out, contiguous: float32 (int32 for raw2ev20, ev2raw20)
                ctypes.c_longlong,  # n
                ctypes.c_void_p,  # x, contiguous: float32 (int32 for the 20-bit transforms)
                *[ctypes.c_int] * levels,  # black20 (ev2raw20: black20, white20, white_ev, zero_ev)
                ctypes.c_void_p,  # cudaStream_t
            ],
        ) for fn, levels in (("log_f32", 0), ("log2_f32", 0), ("exp2_f32", 0), ("raw2ev20", 1),
                             ("fullres_weight", 1), ("ev2raw20", 4))},
    },
    "dualiso_recon": {
        "mlvfs_recon_match": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # out int32 (batch, hh, w), contiguous
                ctypes.c_void_p,  # imgs int16 (batch, hh, w), rows contiguous
                ctypes.c_longlong,  # imgs frame stride (elements)
                ctypes.c_longlong,  # imgs row stride (elements)
                ctypes.c_void_p,  # row_bright bool (batch, hh), contiguous
                ctypes.c_void_p,  # a float32 (batch,)
                ctypes.c_void_p,  # b20 float32 (batch,)
                *[ctypes.c_longlong] * 3,  # batch, hh, w
                ctypes.c_int,  # black20
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_recon_blend": (
            ctypes.c_int,
            [
                *[ctypes.c_void_p] * 3,  # out fullres, halfres int32 (NULL with planes), over bool
                *[ctypes.c_void_p] * 5,  # out planes: f float32, hs_ev, fs_ev, alias int32, skip bool
                                         # (NULL without planes; alias and skip NULL without the alias map)
                *[ctypes.c_void_p] * 2,  # bright, dark int32 (batch, hh, w), contiguous
                ctypes.c_void_p,  # row_bright bool (batch, hh), contiguous
                *[ctypes.c_void_p] * 3,  # white_darkened int32, corr_ev, overlap float32 (batch,)
                *[ctypes.c_longlong] * 3,  # batch, hh, w
                *[ctypes.c_int] * 4,  # black20, white20, white_ev, zero_ev
                ctypes.c_float,  # max_ev
                ctypes.c_int,  # use_fullres
                ctypes.c_int,  # planes
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_recon_alias_planes": (
            ctypes.c_int,
            [
                *[ctypes.c_void_p] * 6,  # out f float32, hs_ev, fs_ev, f_ev (or NULL), alias int32, skip bool
                                         # (alias and skip NULL without the alias map)
                *[ctypes.c_void_p] * 4,  # bright, fullres_smooth, halfres_smooth, fullres (or NULL) int32
                ctypes.c_longlong,  # n
                ctypes.c_int,  # black20
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
        "mlvfs_recon_final": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # out int16 (batch, hh, w)
                *[ctypes.c_void_p] * 4,  # hs_ev, fs_ev, f_ev (or NULL) int32, f float32
                ctypes.c_void_p,  # alias int32 (or NULL without the alias map)
                ctypes.c_void_p,  # over bool
                *[ctypes.c_void_p] * 2,  # dark, bright int32
                *[ctypes.c_longlong] * 3,  # batch, hh, w
                *[ctypes.c_int] * 4,  # black20, white20, white_ev, zero_ev
                ctypes.c_void_p,  # cudaStream_t
            ],
        ),
    },
    "dualiso_scores": {
        "mlvfs_fit_scores": (
            ctypes.c_int,
            [
                ctypes.c_void_p,  # scores int64 (batch, n_cand)
                *[ctypes.c_void_p] * 2,  # hb, hd float32 (batch, n), contiguous
                ctypes.c_void_p,  # valid bool (batch, n)
                ctypes.c_void_p,  # a float32 (n_cand,)
                ctypes.c_void_p,  # b float32 (batch, n_cand)
                *[ctypes.c_longlong] * 3,  # batch, n_cand, n
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """csrc/<name>.cu and the csrc/ headers it includes, directly or through
    another header, in the order first reached."""
    found = [name + ".cu"]
    for rel in found:
        with open(os.path.join(SRC_DIR, rel), "rb") as f:
            for header in _INCLUDE.findall(f.read()):
                if header.decode() not in found:
                    found.append(header.decode())
    return found


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    digest = hashlib.sha256(" ".join(flags(name)).encode())
    for rel in sources(name):
        with open(os.path.join(SRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags(name), "-o", tmp, os.path.join(SRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name}.cu (rc={proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    with open(tmp + ".ptxas", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp + ".ptxas", _ptxas_path(out))
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file


def _ptxas_path(lib: str) -> str:
    return lib[: -len(".so")] + ".ptxas.txt"


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_PTXAS_PROPERTIES = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc's ``-Xptxas -v`` report: each entry
    function's "Used N registers" line, and the stack and spill line that
    follows its own "Function properties" line (not a callee's)."""
    found, entry, props = {}, None, None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            found[entry] = {}
            continue
        m = _PTXAS_PROPERTIES.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PTXAS_SPILLS.search(line)
        if m and props in found:
            found[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m and entry is not None:
            found[entry]["registers"] = int(m.group(1))
    return found


def resource_usage(name: str) -> dict:
    """:func:`parse_ptxas` of csrc/<name>.cu's build (built on first use)."""
    library(name)
    with open(_ptxas_path(library_path(name))) as f:
        return parse_ptxas(f.read())


def build_all() -> None:
    """Build every kernel source that has no library yet, one nvcc process
    per source, all started together, and bind them all."""
    missing = [n for n in _SIGNATURES if not os.path.isfile(library_path(n))]
    if missing:
        with concurrent.futures.ThreadPoolExecutor(len(missing)) as pool:
            list(pool.map(lambda n: _compile(n, library_path(n)), missing))
    for name in _SIGNATURES:
        library(name)


@functools.lru_cache(maxsize=None)
def entry(name: str, fn: str):
    """The bound C entry ``fn`` of csrc/<name>.cu, looked up once."""
    return getattr(library(name), fn)


def on_current_stream(device, launch):
    """``launch(stream)`` with the CUDA ``device`` (a torch.device) current
    and ``stream`` the raw handle of its current stream. The device is
    entered only when another one is current: switching, and a Stream
    object for the handle, cost microseconds a call, as much as some
    kernels take."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index == torch.cuda.current_device():
        return launch(raw(device.index))
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream(device).cuda_stream)


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
