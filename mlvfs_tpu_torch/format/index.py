"""XREF index build / ``.IDX`` sidecar persistence.

The index is a timestamp-sorted table of (fileNumber, frameType, frameOffset)
for every block across all chunks of a clip. It is the checkpoint that makes
conversion restartable: built once by a full block scan, persisted as an
``.IDX`` sidecar next to the ``.MLV``, loaded on subsequent runs.

Sidecar format is byte-compatible with the reference (index.c:100-214): an
MLVI header (with fileNum = chunk_count + 1, frame counts zeroed) followed by
one XREF block. Reference scan loop: index.c:216-341.
"""

from __future__ import annotations

import os
import numpy as np

from . import mlv

# Sanity bound on block sizes, same as index.c:248
_MAX_BLOCK_SIZE = 1024 * 1024 * 1024


class IndexError_(ValueError):
    pass


def scan_blocks(chunk_buf, chunk_number):
    """Scan one chunk buffer; yield (timestamp, offset, block_type) tuples.

    Mirrors the per-chunk walk of make_index (index.c:229-312): MLVI blocks
    get timestamp 0, NULL blocks are skipped, scanning stops at a corrupt
    header. Returns (entries, mlvi_record_or_None).
    """
    n = len(chunk_buf)
    pos = 0
    out = []
    mlvi = None
    while pos + mlv.HDR.itemsize <= n:
        hdr = np.frombuffer(chunk_buf, mlv.HDR, 1, pos)[0]
        size = int(hdr["blockSize"])
        if size < mlv.HDR.itemsize or size > _MAX_BLOCK_SIZE:
            break
        btype = bytes(hdr["blockType"])
        if btype == b"MLVI":
            mlvi = mlv.parse_block(chunk_buf, pos, mlv.MLVI)
            ts = 0
        else:
            ts = int(hdr["timestamp"])
        if btype != b"NULL":
            out.append((ts, pos, chunk_number, btype))
        pos += size
    return out, mlvi


def build_xref(chunk_bufs):
    """Build the sorted xref table for a list of chunk buffers.

    Returns a structured array of mlv.XREF_ENTRY plus the main MLVI header.
    Sorting is stable on timestamp (the reference's bubble sort, index.c:78-98,
    is stable), preserving scan order for equal timestamps.
    """
    entries = []
    main_mlvi = None
    for chunk_no, buf in enumerate(chunk_bufs):
        scanned, mlvi = scan_blocks(buf, chunk_no)
        if mlvi is not None:
            if int(mlvi["fileNum"]) == 0:
                main_mlvi = mlvi
            elif main_mlvi is not None and int(mlvi["fileGuid"]) != int(main_mlvi["fileGuid"]):
                # GUID mismatch across chunks: stop indexing this chunk
                # (index.c:277-282 breaks out of the scan loop)
                continue
        entries.extend(scanned)

    if not entries:
        return np.zeros(0, mlv.XREF_ENTRY), main_mlvi

    ts = np.array([e[0] for e in entries], np.uint64)
    order = np.argsort(ts, kind="stable")

    table = np.zeros(len(entries), mlv.XREF_ENTRY)
    for out_i, src_i in enumerate(order):
        _, offset, chunk_no, btype = entries[src_i]
        table[out_i]["fileNumber"] = chunk_no
        table[out_i]["frameOffset"] = offset
        table[out_i]["frameType"] = (
            mlv.FRAME_VIDF if btype == b"VIDF" else mlv.FRAME_AUDF if btype == b"AUDF" else mlv.FRAME_UNSPECIFIED
        )
    return table, main_mlvi


def idx_path(mlv_path: str) -> str:
    """Sidecar path: replace the last 3 characters of the extension with IDX."""
    return mlv_path[:-3] + "IDX"


def save_idx(mlv_path: str, main_mlvi, chunk_count: int, xref_table) -> None:
    """Persist the sidecar (format of save_index, index.c:175-214)."""
    file_hdr = np.array(main_mlvi, mlv.MLVI).reshape(()).copy()
    file_hdr["blockSize"] = mlv.MLVI.itemsize
    file_hdr["videoFrameCount"] = 0
    file_hdr["audioFrameCount"] = 0
    file_hdr["fileNum"] = chunk_count + 1

    xref_hdr = mlv.new_block(mlv.XREF, b"XREF")
    xref_hdr["blockSize"] = mlv.XREF.itemsize + xref_table.nbytes
    xref_hdr["entryCount"] = len(xref_table)

    tmp = idx_path(mlv_path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(file_hdr.tobytes())
        f.write(xref_hdr.tobytes())
        f.write(xref_table.tobytes())
    os.replace(tmp, idx_path(mlv_path))


def load_idx(mlv_path: str):
    """Load the xref table from the sidecar, or None (load_index, index.c:100-173)."""
    path = idx_path(mlv_path)
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    pos = 0
    n = len(buf)
    while pos + mlv.HDR.itemsize <= n:
        hdr = np.frombuffer(buf, mlv.HDR, 1, pos)[0]
        size = int(hdr["blockSize"])
        if size <= 0:
            return None
        if bytes(hdr["blockType"]) == b"XREF":
            xref_hdr = np.frombuffer(buf, mlv.XREF, 1, pos)[0]
            count = int(xref_hdr["entryCount"])
            start = pos + mlv.XREF.itemsize
            if start + count * mlv.XREF_ENTRY.itemsize > n:
                return None
            return np.frombuffer(buf, mlv.XREF_ENTRY, count, start).copy()
        pos += size
    return None


def get_index(mlv_path: str, chunk_bufs, use_sidecar: bool = True):
    """Load-or-build the index (get_index, index.c:458-470).

    Also applies the stale-IDX fallback of mlv_get_frame_count
    (index.c:506-522): if a loaded index contains no VIDF entries the index
    is rebuilt from scratch.
    """
    table = load_idx(mlv_path) if use_sidecar else None
    if table is not None and (table["frameType"] == mlv.FRAME_VIDF).any():
        return table
    table, main_mlvi = build_xref(chunk_bufs)
    if use_sidecar and main_mlvi is not None:
        try:
            save_idx(mlv_path, main_mlvi, len(chunk_bufs), table)
        except OSError:
            pass  # read-only source dir: keep the in-memory index
    return table
