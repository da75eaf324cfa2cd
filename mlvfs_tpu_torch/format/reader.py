"""Clip reader: chunk discovery, metadata gathering, frame payload access.

Replaces the reference's per-read chunk fopen + xref walk
(main.c:429-558 mlv_get_frame_headers, resource_manager.c:229-317) with a
single pass that snapshots the metadata state at every VIDF/AUDF, backed by
memory-mapped chunks. All frame payloads are then zero-copy slices, which is
what lets the pipeline DMA packed bytes straight to the device.
"""

from __future__ import annotations

import mmap as _mmap
import os

import numpy as np

from . import mlv
from .index import get_index

_META_TYPES = {
    b"MLVI": ("mlvi", mlv.MLVI),
    b"RTCI": ("rtci", mlv.RTCI),
    b"IDNT": ("idnt", mlv.IDNT),
    b"RAWI": ("rawi", mlv.RAWI),
    b"EXPO": ("expo", mlv.EXPO),
    b"LENS": ("lens", mlv.LENS),
    b"WBAL": ("wbal", mlv.WBAL),
    b"WAVI": ("wavi", mlv.WAVI),
    b"DISO": ("diso", mlv.DISO),
}


def discover_chunks(mlv_path: str):
    """Return [path.MLV, path.M00, path.M01, ...] for all existing spill chunks.

    Mirrors load_chunks (index.c:368-423): sequential .M00..M99 probing that
    stops at the first missing file.
    """
    paths = [mlv_path]
    base = mlv_path[:-2]  # strip the last two chars of the extension
    for seq in range(100):
        candidate = f"{base}{seq:02d}"
        if os.path.isfile(candidate):
            paths.append(candidate)
        else:
            break
    return paths


def is_mlv_name(name: str) -> bool:
    return name.upper().endswith(".MLV")


class MLVClip:
    """One MLV clip (main file + spill chunks), indexed and memory-mapped."""

    def __init__(self, path: str, use_sidecar: bool = True, populate: bool = False):
        self.path = path
        self.chunk_paths = discover_chunks(path)
        self.chunks = [self._map_chunk(p, populate) for p in self.chunk_paths]
        self.xref = get_index(path, self.chunks, use_sidecar=use_sidecar)
        self._scan_metadata()

    @staticmethod
    def _map_chunk(path: str, populate: bool) -> np.ndarray:
        """Read-only byte map of one chunk file.

        ``populate=True`` maps with MAP_POPULATE: the kernel prefaults the
        whole mapping in one pass, so the per-batch payload copies run at
        warm-memcpy speed instead of paying a minor fault per 4 KiB page
        (~0.2 ms/frame at 1080p — measured against preadv and madvise
        alternatives, which were both slower on this rig). Only batch
        conversions that will read every frame anyway opt in; the mount's
        demand paging keeps lazy mapping so opening a clip stays O(1) in
        clip size.
        """
        if populate and hasattr(_mmap, "MAP_POPULATE"):
            fd = os.open(path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                if size == 0:
                    return np.empty(0, np.uint8)
                m = _mmap.mmap(
                    fd,
                    size,
                    flags=_mmap.MAP_SHARED | _mmap.MAP_POPULATE,
                    prot=_mmap.PROT_READ,
                )
                return np.frombuffer(m, np.uint8)
            finally:
                os.close(fd)
        return np.memmap(path, np.uint8, "r")

    # -- metadata -----------------------------------------------------------

    def _scan_metadata(self):
        """Walk the xref once, snapshotting metadata at each VIDF/AUDF."""
        state = {name: mlv.new_block(dt, key) for key, (name, dt) in _META_TYPES.items()}
        state["mlvi"] = mlv.new_block(mlv.MLVI, b"MLVI")
        self._vidf = []  # (file_number, position, snapshot_dict)
        self._audf = []
        self._debg = []  # (file_number, position)
        snap_dirty = True
        snap = None
        for entry in self.xref:
            fno = int(entry["fileNumber"])
            pos = int(entry["frameOffset"])
            ftype = int(entry["frameType"])
            buf = self.chunks[fno]
            if ftype == mlv.FRAME_VIDF:
                if snap_dirty:
                    snap = dict(state)
                    snap_dirty = False
                self._vidf.append((fno, pos, snap))
            elif ftype == mlv.FRAME_AUDF:
                self._audf.append((fno, pos))
            else:
                btype = bytes(buf[pos : pos + 4])
                if btype in _META_TYPES:
                    name, dt = _META_TYPES[btype]
                    state[name] = mlv.parse_block(buf, pos, dt)
                    snap_dirty = True
                elif btype == b"DEBG":
                    self._debg.append((fno, pos))

    @property
    def frame_count(self) -> int:
        return len(self._vidf)

    @property
    def audio_frame_count(self) -> int:
        return len(self._audf)

    @property
    def main_header(self):
        if self._vidf:
            return self._vidf[0][2]["mlvi"]
        return mlv.parse_block(self.chunks[0], 0, mlv.MLVI)

    @property
    def has_audio(self) -> bool:
        # has_audio (wav.c:173-187): audioClass == 1 in the main header
        return int(self.main_header["audioClass"]) == 1

    @property
    def guid(self) -> int:
        return int(self.main_header["fileGuid"])

    def frame_headers(self, i: int) -> mlv.FrameHeaders:
        """Metadata snapshot for video frame ``i`` (by sequence, like readdir)."""
        fno, pos, snap = self._vidf[i]
        vidf = mlv.parse_block(self.chunks[fno], pos, mlv.VIDF)

        # Return writable copies: snapshots are shared between frames and may
        # be zero-copy views into read-only memmaps, while callers (deflicker,
        # dual-ISO) mutate header fields before building the DNG.
        def cp(rec):
            return np.array(rec, rec.dtype).reshape(()).copy()[()]

        return mlv.FrameHeaders(
            file_number=fno,
            position=pos,
            vidf=cp(vidf),
            mlvi=cp(snap["mlvi"]),
            rtci=cp(snap["rtci"]),
            idnt=cp(snap["idnt"]),
            rawi=cp(snap["rawi"]),
            expo=cp(snap["expo"]),
            lens=cp(snap["lens"]),
            wbal=cp(snap["wbal"]),
        )

    def frame_headers_shared(self, i: int) -> mlv.FrameHeaders:
        """READ-ONLY FrameHeaders for emit-side consumers (header rendering).

        Copies only the per-frame VIDF; the metadata blocks are writable
        copies CACHED per snapshot and shared between frames — ~10x cheaper
        than frame_headers() on the per-frame DNG write path. Callers must
        not mutate the shared blocks (the converter's header templates and
        render() only read them)."""
        fno, pos, snap = self._vidf[i]
        vidf = mlv.parse_block(self.chunks[fno], pos, mlv.VIDF)
        cached = getattr(self, "_snap_copies", None)
        if cached is None:
            cached = self._snap_copies = {}
        key = id(snap)
        blocks = cached.get(key)
        if blocks is None:

            def cp(rec):
                return np.array(rec, rec.dtype).reshape(()).copy()[()]

            blocks = {k: cp(snap[k]) for k in
                      ("mlvi", "rtci", "idnt", "rawi", "expo", "lens", "wbal")}
            cached[key] = blocks
        return mlv.FrameHeaders(
            file_number=fno,
            position=pos,
            vidf=np.array(vidf, vidf.dtype).reshape(()).copy()[()],
            **blocks,
        )

    # -- payload access ------------------------------------------------------

    def frame_payload(self, i: int) -> np.ndarray:
        """Raw VIDF payload bytes for frame ``i`` (zero-copy memmap slice).

        For uncompressed clips this is the packed Bayer bitstream; for
        LJ92/LZMA clips it starts with the 4-byte uncompressed size followed by
        the compressed stream (get_image_data, main.c:582-607).
        """
        fno, pos, _ = self._vidf[i]
        buf = self.chunks[fno]
        vidf = mlv.parse_block(buf, pos, mlv.VIDF)
        start = pos + mlv.VIDF.itemsize + int(vidf["frameSpace"])
        end = pos + int(vidf["blockSize"])
        return buf[start:end]

    def audio_payloads(self):
        """Yield AUDF payload slices in xref order (wav.c:301-338)."""
        for fno, pos in self._audf:
            buf = self.chunks[fno]
            audf = mlv.parse_block(buf, pos, mlv.AUDF)
            start = pos + mlv.AUDF.itemsize + int(audf["frameSpace"])
            end = pos + int(audf["blockSize"])
            yield buf[start:end]

    def meta_block(self, key: bytes) -> np.void:
        """First snapshot of metadata block ``key`` (e.g. b"RTCI", b"IDNT").

        Frame 0's snapshot when video frames exist; otherwise a direct block
        scan, like the reference's WAV header gather which never needs a
        VIDF (wav_get_headers, wav.c:102-171). Empty block if absent.
        """
        name, dt = _META_TYPES[key]
        if self._vidf:
            return self._vidf[0][2][name]
        for fno, pos in self._iter_blocks(key):
            return mlv.parse_block(self.chunks[fno], pos, dt)
        return mlv.new_block(dt, key)

    @property
    def wavi(self):
        return self.meta_block(b"WAVI")

    def _iter_blocks(self, wanted: bytes):
        for entry in self.xref:
            if int(entry["frameType"]) != mlv.FRAME_UNSPECIFIED:
                continue
            fno = int(entry["fileNumber"])
            pos = int(entry["frameOffset"])
            if bytes(self.chunks[fno][pos : pos + 4]) == wanted:
                yield fno, pos

    def debug_log(self) -> str:
        """Concatenated DEBG text (mlv_read_debug_log, main.c:333-420)."""
        parts = []
        for fno, pos in self._debg:
            hdr = mlv.parse_block(self.chunks[fno], pos, mlv.DEBG)
            start = pos + mlv.DEBG.itemsize
            length = int(hdr["length"])
            data = bytes(self.chunks[fno][start : start + length])
            parts.append(data.rstrip(b"\0").decode("ascii", "replace"))
        return "".join(parts)

    def close(self):
        # memmaps are closed by GC; keep explicit hook for the resource manager
        self.chunks = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
