"""Batch MLV → DNG conversion engine on a torch device.

Counterpart of ``mlvfs_tpu/pipeline/convert.py``, the replacement for the
reference's FUSE read path (main.c:1410-1576, 908-1005): batches of packed
frames stream to the device, the processing pipeline runs per batch, and
DNGs are written out. The container reader, the LJ92 codec and the DNG/WAV/GIF
emitters are the port's own copies of the reference's host modules.

Pipeline stages (overlapped via the prefetch ring in ``stream.py``):
  host (prefetch threads): gather packed payloads / LZMA or LJ92 decode into
      a pinned staging ring, non-blocking H2D copy on a side stream
  device (main thread, its current stream): unpack kernel → the processing
      pipeline (``kernels.run_pipeline``: deflicker median, pattern-noise
      kernel, dual-ISO preview kernel, focus/bad-pixel fix, chroma-smoothing
      kernel, stripe correction)
  host (write pool): D2H readback into pinned memory on a side stream (the
      frames and, with --deflicker, the batch's medians), 64 KiB CDNG header
      render with the per-frame levels and BaselineExposure, one writev per DNG

CUDA ordering, made explicit rather than left to stream defaults:
  - a staging buffer is refilled only after the event recorded behind its
    last H2D copy has completed;
  - the compute stream waits on that copy's event, and the uploaded tensor is
    ``record_stream``-ed onto the compute stream for the allocator;
  - the readback stream waits on an event recorded after the batch's
    compute on the main thread before it reads the batch back.

Unlike the XLA engine, batches are not padded to a fixed shape: eager
PyTorch compiles nothing per shape, and a tail batch simply has fewer frames.
"""

from __future__ import annotations

import collections
import concurrent.futures as _futures
import lzma
import os
import threading

import numpy as np
import torch

from ..emit import dng as dng_emit
from ..format.reader import MLVClip
from ..ops import unpack as unpack_ops
from ..utils import metrics
from . import kernels
from .config import ProcessingConfig

# write-pool tasks in flight before the main loop waits for the oldest: each
# holds its batch on the device until written, so the bound caps device memory
_MAX_PENDING_WRITES = 8


def _mlv_basename(path: str) -> str:
    base = os.path.basename(path)
    return base[:-4] if base.upper().endswith(".MLV") else base


def dng_frame_name(basename: str, frame: int) -> str:
    """Virtual DNG naming (main.c:1308 '%s_%06d.dng')."""
    return f"{basename}_{frame:06d}.dng"


def resolve_basename(path: str, fh) -> str:
    """DaVinci Resolve naming scheme (get_mlv_basename, main.c:724-728):
    <name><EXT>_1_YYYY-MM-DD_0001_C0000 derived from the RTCI date."""
    base, ext = os.path.splitext(os.path.basename(path))
    rtci = fh.rtci
    return "%s%s_1_%d-%02d-%02d_%04d_C%04d" % (
        base,
        ext[1:],
        1900 + int(rtci["tm_year"]),
        int(rtci["tm_mon"]) + 1,
        int(rtci["tm_mday"]),
        1,
        0,
    )


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; a CUDA device without a usable card raises
    (the pipeline never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda[:N] or cpu)")
    return dev


class ClipConverter:
    """Converts one clip; owns the per-clip calibration state and the
    host/device staging resources."""

    def __init__(self, clip: MLVClip, config: ProcessingConfig = None):
        self.clip = clip
        self.config = config or ProcessingConfig()
        self.device = resolve_device(self.config.device)
        self._cuda = self.device.type == "cuda"
        self.fh0 = clip.frame_headers(0) if clip.frame_count else None
        self._write_pool = _futures.ThreadPoolExecutor(max_workers=4)
        ncpu = os.cpu_count() or 1
        self._decode_pool = (
            _futures.ThreadPoolExecutor(max_workers=min(8, ncpu)) if ncpu > 1 else None
        )
        self._calibration = None
        self._templates = {}
        self._buf_ring = {}
        self._buf_turn = 0
        self._buf_lock = threading.Lock()
        # H2D copies (prefetch threads) and D2H readbacks (write pool) each run
        # on a side stream; compute runs on the main thread's current stream
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._readback_stream = torch.cuda.Stream(self.device) if self._cuda else None

    # ------------------------------------------------------------------ #
    # host side (prefetch threads)

    def _staging(self, shape):
        """A reusable host buffer from a small ring: ``[int16 tensor, event]``.

        Pinned for CUDA, so the H2D copy is asynchronous. The ring is one
        deeper than the prefetch depth, and the turn is taken under a lock,
        so concurrent fetches get distinct buffers. ``event`` marks the end
        of the last H2D copy out of the buffer; it is waited on before the
        buffer is refilled."""
        depth = max(2, int(self.config.prefetch) + 1)
        with self._buf_lock:
            self._buf_turn = (self._buf_turn + 1) % depth
            key = (shape, self._buf_turn)
            entry = self._buf_ring.get(key)
            if entry is None:
                buf = torch.empty(shape, dtype=torch.int16, pin_memory=self._cuda)
                entry = self._buf_ring[key] = [buf, None]
        if entry[1] is not None:
            entry[1].synchronize()
        return entry

    def _n_words(self) -> int:
        fh = self.fh0
        return unpack_ops.words_for_pixels(fh.yres * fh.xres, fh.raw_info.bits_per_pixel)

    def _gather_packed_batch(self, indices):
        """Packed word streams of a batch of uncompressed frames, copied from
        the chunk memmaps into a staging buffer. Short/corrupt frames are
        blanked past their end."""
        n_words = self._n_words()
        entry = self._staging((len(indices), n_words))
        out = entry[0].numpy().view("<u2")
        for bi, i in enumerate(indices):
            payload = np.asarray(self.clip.frame_payload(i))
            words = unpack_ops.bytes_to_words_np(payload)
            n = min(n_words, len(words))
            out[bi, :n] = words[:n]
            if n < n_words:  # short/corrupt frame: blank the tail
                out[bi, n:] = 0
        return entry

    def _lzma_batch_host(self, indices):
        """Host LZMA decompress → packed word streams (B, n_words).

        The decompressed bytes are the *packed* bpp bitstream (main.c:605-611),
        which then takes the same device unpack as uncompressed clips.
        """
        from ..utils import log

        n_words = self._n_words()
        entry = self._staging((len(indices), n_words))
        out = entry[0].numpy().view("<u2")

        def decode_one(bi, i):
            payload = np.asarray(self.clip.frame_payload(i))
            try:
                out_size = int(payload[:4].view("<u4")[0])
                props = payload[4:9].tobytes()
                body = payload[9:].tobytes()
                # FORMAT_ALONE header: props + uncompressed size (-1 = unknown)
                dec = lzma.LZMADecompressor(format=lzma.FORMAT_ALONE)
                packed = dec.decompress(props + b"\xff" * 8 + body, max_length=out_size)
                words = np.frombuffer(packed, "<u2", len(packed) // 2)
                n = min(n_words, len(words))
                out[bi, :n] = words[:n]
                out[bi, n:] = 0
            except Exception as e:  # corrupt stream: drop the frame, keep going
                log.error("lzma decode failed for frame %d: %s", i, e)
                out[bi] = 0

        # liblzma releases the GIL: decode the batch across cores
        pool = self._decode_pool
        if pool is None or len(indices) == 1:
            for bi, i in enumerate(indices):
                decode_one(bi, i)
        else:
            list(pool.map(lambda a: decode_one(*a), list(enumerate(indices))))
        return entry

    def _lj92_batch_host(self, indices):
        """Host decode of LJ92 clips → (B, H*W) tiled samples (de-tiled on the
        device). One native call decodes the whole batch across hardware
        threads; a corrupt frame stays blank (main.c:598-681)."""
        from ..codecs import lj92 as lj92_codec
        from ..utils import log

        fh = self.fh0
        n_px = fh.yres * fh.xres
        streams = [np.asarray(self.clip.frame_payload(i))[4:].tobytes() for i in indices]
        samples, rcs = lj92_codec.decode_batch(streams, n_px)
        for bi, rc in enumerate(rcs):
            if rc != 0:  # corrupt stream: frame stays blank, keep going
                log.error("lj92 decode failed for frame %d (rc=%d)", indices[bi], rc)
        entry = self._staging((len(indices), n_px))
        entry[0].numpy().view("<u2")[:] = samples
        return entry

    def _upload(self, entry):
        """Stage a filled buffer on the device → (tensor, copy event or None)."""
        buf = entry[0]
        if not self._cuda:
            return buf, None
        with torch.cuda.stream(self._copy_stream):
            dev = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        entry[1] = event
        return dev, event

    def fetch_batch(self, indices):
        """Host side of decode: gather/decode + async device transfer.
        Runs on the prefetch thread (stream.BatchPrefetcher)."""
        comp = self.fh0.compression
        with metrics.span("fetch", batch=indices[0]):
            if comp == "none":
                return self._upload(self._gather_packed_batch(indices))
            if comp == "lzma":
                return self._upload(self._lzma_batch_host(indices))
            if comp == "lj92":
                return self._upload(self._lj92_batch_host(indices))
        raise ValueError(f"unknown compression {comp}")

    # ------------------------------------------------------------------ #
    # device side (main thread)

    def decode_batch(self, indices, fetched=None) -> torch.Tensor:
        """Decode frames → device tensor (B, H, W) int16 u16 bits (pre-processing)."""
        if fetched is None:
            fetched = self.fetch_batch(indices)
        data, copied = fetched
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            data.record_stream(stream)
        fh = self.fh0
        if fh.compression in ("none", "lzma"):
            # both carry the packed bpp bitstream → device bit-unpack
            return unpack_ops.unpack_batch(data, fh.raw_info.bits_per_pixel, fh.yres, fh.xres)
        # lj92: host entropy decode produced tiled samples; de-tile on device
        return unpack_ops.lj92_detile(data.reshape(len(indices), fh.yres, fh.xres))

    def process_batch(self, imgs: torch.Tensor, indices):
        """Run the configured processing pipeline on a decoded batch.

        Returns (imgs, per_frame_info); the info carries header mutations.
        """
        ri = self.fh0.raw_info
        info = {"black_level": ri.black_level, "white_level": ri.white_level}
        return kernels.run_pipeline(imgs, self.fh0, self.config, self._get_calibration(), info)

    def _get_calibration(self):
        """Per-clip calibration state, restored from the `.CAL` sidecar when
        present."""
        if self._calibration is None:
            from . import calibration

            self._calibration = kernels.calibrate_clip(self.fh0, self.config)
            if self.config.use_sidecar_idx:
                calibration.load_into(
                    self._calibration, self.clip.path, self.clip.guid, self.config
                )
        return self._calibration

    def _computed(self):
        """Event behind the work enqueued so far on this thread's stream (None
        on the CPU), for the thread that reads the result back."""
        if not self._cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _to_host(self, tensors, computed):
        """Device tensors → host numpy arrays of the same dtypes, on any thread.

        On CUDA the readback stream first waits on ``computed`` (from
        :meth:`_computed` on the thread that ran the batch), then copies into
        pinned memory: a pageable destination makes CUDA stage the copy
        through a bounce buffer, measured about 25x slower on an H100 80GB
        HBM3 (700 W) host.
        The pinned blocks return to PyTorch's host-allocator cache when the
        arrays are dropped. The tensors stay referenced by the caller until
        the copies have completed, so their device memory is not reused
        early."""
        if not self._cuda:
            return [t.contiguous().numpy() for t in tensors]
        stream = self._readback_stream
        with torch.cuda.stream(stream):
            stream.wait_event(computed)
            hosts = []
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            copied = torch.cuda.Event()
            copied.record(stream)
        copied.synchronize()
        return [h.numpy() for h in hosts]

    # ------------------------------------------------------------------ #

    def convert(self, outdir: str, frames=None, progress=None):
        """Convert frames to DNG files in ``outdir``. Returns written paths."""
        os.makedirs(outdir, exist_ok=True)
        clip = self.clip
        cfg = self.config
        if clip.frame_count == 0:
            # no video frames: still export the virtual-directory sidecars
            # (main.c:1306-1320)
            if cfg.export_all:
                return sorted(self.write_sidecars(outdir, _mlv_basename(clip.path)))
            return []
        if cfg.name_scheme == 1:
            basename = resolve_basename(clip.path, self.fh0)
        else:
            basename = _mlv_basename(clip.path)
        frames = list(range(clip.frame_count)) if frames is None else list(frames)
        paths = []
        from .stream import BatchPrefetcher

        if cfg.resume:
            # restartable conversion: skip frames whose DNG is already on disk
            todo = []
            for i in frames:
                path = os.path.join(outdir, dng_frame_name(basename, i))
                if os.path.isfile(path) and os.path.getsize(path) > dng_emit.HEADER_SIZE:
                    paths.append(path)
                else:
                    todo.append(i)
            metrics.count("frames_resumed", len(frames) - len(todo))
            frames = todo

        batches = [frames[i : i + cfg.batch_size] for i in range(0, len(frames), cfg.batch_size)]
        prefetcher = BatchPrefetcher(self.fetch_batch, batches, depth=max(1, cfg.prefetch))
        pending = collections.deque()
        done = 0
        for indices, fetched in prefetcher:
            with metrics.span("decode", metrics.DEVICE, batch=indices[0]):
                imgs = self.decode_batch(indices, fetched)
            with metrics.span("process", metrics.DEVICE, batch=indices[0]):
                imgs, info = self.process_batch(imgs, indices)
            metrics.settle()
            computed = self._computed()
            # readback + header synthesis + file IO run on the write pool so
            # the device->host transfer of batch N overlaps batch N+1's
            # decode/process
            if len(pending) >= _MAX_PENDING_WRITES:
                with metrics.span("wait.writes", metrics.SYNC):
                    pending.popleft().result()
            pending.append(
                self._write_pool.submit(
                    self._finish_batch, outdir, basename, indices, imgs, info, computed
                )
            )
            for i in indices:
                paths.append(
                    os.path.join(outdir, dng_frame_name(basename, i))
                )
            done += len(indices)
            if progress:
                progress(done, len(frames))
        with metrics.span("take.drain", metrics.SYNC):
            while pending:
                pending.popleft().result()
        if self._calibration is not None and cfg.use_sidecar_idx:
            from . import calibration

            with metrics.span("take.save_cal"):
                calibration.save_from(self._calibration, clip.path, clip.guid, cfg)
        if cfg.export_all:
            paths.extend(self.write_sidecars(outdir, basename))
        return sorted(paths)

    def write_sidecars(self, outdir: str, basename: str):
        """Write the clip's non-DNG virtual-directory entries next to the DNGs
        (main.c:1308-1320): <base>.wav when the clip has audio, <base>.log
        (camera debug log, may be empty), <base>_PREVIEW.gif."""
        from ..emit.gif import build_gif, gif_frame_ids
        from ..emit.wav import build_wav

        clip = self.clip
        written = []
        if clip.has_audio:
            p = os.path.join(outdir, basename + ".wav")
            with open(p, "wb") as f:
                f.write(build_wav(clip))
            written.append(p)
        p = os.path.join(outdir, basename + ".log")
        with open(p, "w") as f:
            f.write(clip.debug_log())
        written.append(p)
        if clip.frame_count:
            frame_ids = gif_frame_ids(clip.frame_count)
            imgs = self.decode_batch(frame_ids)
            with metrics.sync("gif"):
                (batch,) = self._to_host([imgs], self._computed())
            batch = batch.view("<u2")
            decoded = {i: batch[bi] for bi, i in enumerate(frame_ids)}
            gif_bytes = build_gif(clip, decode_fn=decoded.__getitem__)
        else:
            gif_bytes = build_gif(clip, decode_fn=lambda i: None)  # empty preview
        p = os.path.join(outdir, basename + "_PREVIEW.gif")
        with open(p, "wb") as f:
            f.write(gif_bytes)
        written.append(p)
        return written

    def _finish_batch(self, outdir, basename, indices, imgs, info, computed):
        """Write-pool task: pull the batch to host and write its DNGs through
        the per-clip header template."""
        with metrics.span("finish", batch=indices[0]):
            cfg = self.config
            medians = info.pop("deflicker_medians", None)
            with metrics.span("finish.readback", metrics.SYNC):
                host = self._to_host([imgs] if medians is None else [imgs, medians], computed)
            imgs_np = host[0].view("<u2")
            if medians is not None:
                info["exposure_bias"] = kernels.exposure_bias(
                    host[1], cfg.deflicker, self.fh0.raw_info.black_level
                )
            metrics.count("frames", len(indices))
            metrics.count("bytes_out", int(imgs_np.nbytes))
            with metrics.span("finish.render"):
                dngs = self._render_batch(outdir, basename, indices, imgs_np, info)
            with metrics.span("finish.write"):
                for path, header, payload in dngs:
                    self._write_dng(path, header, payload)

    def _render_batch(self, outdir, basename, indices, imgs_np, info):
        """[(path, header, payload)] of a batch read back: the headers from
        the per-clip template, the payloads LJ92-encoded with --compress-dng."""
        strips = None
        if self.config.compress == "lj92":
            # one native call per batch, frames fanned over hardware threads
            from ..codecs import lj92 as lj92_codec

            with metrics.span("finish.encode"):
                strips = lj92_codec.encode_batch(imgs_np, ncomp=2, bits=16)
        compression = "lj92" if strips is not None else "none"
        tpl = None
        tpl_ident = None
        dngs = []
        for bi, i in enumerate(indices):
            fh = self.clip.frame_headers_shared(i)
            # template reuse by block identity: frame_headers_shared hands out
            # the SAME metadata objects while the clip's snapshot is unchanged
            ident = (id(fh.expo), id(fh.lens), id(fh.wbal), id(fh.rtci))
            if ident != tpl_ident:
                tpl = self._header_template(fh, basename, compression=compression)
                tpl_ident = ident
            black, white, bias = self._info_fields(info, bi)
            path = os.path.join(outdir, dng_frame_name(basename, i))
            if strips is not None:
                header = tpl.render(
                    fh, black_level=black, white_level=white, exposure_bias=bias,
                    strip_byte_count=len(strips[bi]),
                )
                dngs.append((path, header, np.frombuffer(strips[bi], np.uint8)))
            else:
                header = tpl.render(
                    fh, black_level=black, white_level=white, exposure_bias=bias
                )
                dngs.append((path, header, imgs_np[bi]))
        return dngs

    @staticmethod
    def _info_fields(info, bi):
        """Per-frame header mutations from the processed-batch info dict:
        the frame's levels (per frame after a dual-ISO conversion) and its
        BaselineExposure."""
        levels = info.get("levels")
        if levels is not None:
            black, white = int(levels[bi][0]), int(levels[bi][1])
        else:
            black, white = info["black_level"], info["white_level"]
        eb = info.get("exposure_bias")
        bias = (int(eb[bi][0]), int(eb[bi][1])) if eb is not None else None
        return black, white, bias

    def _header_template(self, fh, basename, compression="none"):
        """Template cache keyed on the metadata blocks that feed the header
        (EXPO/LENS/WBAL/RTCI can change mid-clip; MLVI/RAWI/IDNT are static)."""
        key = (
            compression,
            fh.expo.tobytes(),
            fh.lens.tobytes(),
            fh.wbal.tobytes(),
            fh.rtci.tobytes(),
        )
        tpl = self._templates.get(key)
        if tpl is None:
            tpl = dng_emit.DNGHeaderTemplate(
                fh, self.config.fps, basename, compression=compression,
                strip_byte_count=0 if compression == "lj92" else None,
            )
            self._templates[key] = tpl
        return tpl

    @staticmethod
    def _write_dng(path: str, header: bytes, img: np.ndarray):
        # one writev syscall, no stdio buffer and no tobytes() copy of the
        # 2·W·H image payload
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.writev(fd, [header, memoryview(img).cast("B")])
        finally:
            os.close(fd)
        os.replace(tmp, path)

    def close(self):
        self._write_pool.shutdown(wait=True)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)


def convert_clip(mlv_path: str, outdir: str, config: ProcessingConfig = None, **kw):
    """One-shot conversion of a single clip."""
    config = config or ProcessingConfig()
    with metrics.take():
        # populate=True: a full conversion reads every frame, so prefault the
        # chunk mappings in one kernel pass (MAP_POPULATE)
        with metrics.span("take.open"):
            clip = MLVClip(mlv_path, use_sidecar=config.use_sidecar_idx, populate=True)
        conv = None
        try:
            with metrics.span("take.setup"):
                conv = ClipConverter(clip, config)
            return conv.convert(outdir, **kw)
        finally:
            with metrics.span("take.close"):
                if conv is not None:
                    conv.close()
                clip.close()
                # the take's mappings go with the last view into them, which
                # the converter and the clip hold: release them here
                del conv, clip
