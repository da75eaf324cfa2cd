"""One run of one cell: set-up, the measured window, the check.

Set-up loads the program's kernel libraries, makes the cell's take on the
card from the seed and writes it, and converts a two-batch take of the same
configuration with the same flags, so that every shape and lazy table of
the window is built before it opens. The window converts the take through
``mlvfs_tpu_torch.pipeline.convert.convert_clip`` back to back, as a user
converting a card's folder of takes does, each pass a fresh take: its
``.IDX`` and ``.CAL`` sidecars are removed first, so every pass indexes the
take and calibrates it again. Once ``--seconds`` have passed, the take in
progress stops at its next batch boundary, and the window closes when the
last DNG of the batches already handed out is written: every frame of the
window was written inside it, and the rate is taken over whole batches and
the whole time they took (a window closed at a fixed time would count
whole batches only, a step of 1/29 in a dual-ISO cell's rate). After the
window the program's state is freed and the plain reference
(``reference/``) recomputes a sample of the batches; the DNGs are compared
with it.

Each run also logs a ``host`` line on standard error (``host_record``):
every take pass's length, the longest gap between batches and the CPU the
process used; it is not part of the result.

The take and the DNGs live in a directory of the machine's shared memory,
named from the checkout's path (fixed for a checkout, different for two
checkouts) and removed when the run ends: a window writes gigabytes of
DNGs, which the disk under the checkout should not take.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import random
import shutil
import sys
import time

import catalog
import dngcheck
import spans as spans_mod
import take as take_mod

TAKE_NAME = "TAKE"
WARM_NAME = "WARM"
SIDECARS = (".IDX", ".CAL")
# host spans every run records: the batches' read and write ends
CORE_SPANS = {
    "fetch": "mlvfs_tpu_torch.pipeline.convert:ClipConverter.fetch_batch",
    "finish": "mlvfs_tpu_torch.pipeline.convert:ClipConverter._finish_batch",
}
# main-thread spans of the traced run, which name the device's idle gaps
LABEL_SPANS = {
    "decode": "mlvfs_tpu_torch.pipeline.convert:ClipConverter.decode_batch",
    "process": "mlvfs_tpu_torch.pipeline.convert:ClipConverter.process_batch",
}
FORBIDDEN = ("jax", "jaxlib", "mlvfs_tpu")


class NoChip(RuntimeError):
    pass


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def workdir_for(root: str) -> str:
    digest = hashlib.sha1(os.path.abspath(root).encode()).hexdigest()[:16]
    return os.path.join("/dev/shm", f"mlvfs-bench-{digest}")


def program_config(flags: list, device: str):
    """The program's ProcessingConfig for the traffic's flags, as its CLI
    builds it for ``convert``."""
    from mlvfs_tpu_torch import cli

    parser = argparse.ArgumentParser()
    cli._add_processing_flags(parser)
    args = parser.parse_args([*flags, "--device", device])
    return cli.config_from_args(args)


def reference_settings(flags: list, batch: int):
    """The reference's settings for the traffic's flags (its own reading of
    the flags the reference carries; any other flag is refused)."""
    from reference.pipeline import Settings

    p = argparse.ArgumentParser(prog="reference", add_help=False)
    p.add_argument("--deflicker", type=int, default=0)
    for f in ("--cs2x2", "--cs3x3", "--cs5x5", "--bad-pix", "--really-bad-pix", "--stripes",
              "--stripes-batch-cal", "--dual-iso", "--mean23", "--no-alias-map", "--no-fullres"):
        p.add_argument(f, action="store_true")
    a = p.parse_args(flags)
    return Settings(
        deflicker=a.deflicker,
        chroma_smooth=5 if a.cs5x5 else 3 if a.cs3x3 else 2 if a.cs2x2 else 0,
        fix_bad_pixels=2 if a.really_bad_pix else 1 if a.bad_pix else 0,
        fix_stripes=a.stripes, stripes_batch_cal=a.stripes_batch_cal,
        dual_iso=2 if a.dual_iso else 0, hdr_interpolation_method=1 if a.mean23 else 0,
        hdr_no_fullres=a.no_fullres, hdr_no_alias_map=a.no_alias_map, batch_size=batch,
    )


def camera_of(take):
    from reference.pipeline import Camera

    cam = take.config["camera"]
    return Camera(width=take.width, height=take.height, bits=cam["bits_per_pixel"],
                  black=cam["black_level"], white=cam["white_level"])


def _remove_sidecars(path: str):
    base = os.path.splitext(path)[0]
    for ext in SIDECARS:
        try:
            os.unlink(base + ext)
        except FileNotFoundError:
            pass


def _stoppable(base, should_stop, waits):
    """A BatchPrefetcher that, once ``should_stop()`` holds, ends its take
    after the batch just handed out, and waits for its running fetches, so
    that no thread reads the take after the converter closes it; each wait
    of the main thread for a batch lands in ``waits``."""

    class Stoppable(base):
        def __iter__(self):
            inner = base.__iter__(self)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(inner)
                    except StopIteration:
                        return
                    waits.append((t0, time.perf_counter()))
                    yield item
                    if should_stop():
                        return
            finally:
                inner.close()
                pool = getattr(self, "_pool", None)
                if pool is not None:
                    pool.shutdown(wait=True)

    return Stoppable


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    seconds: float  # the window's length
    setup_s: float
    frames: int
    batches: list  # the window's batches: dicts of pass, first, n, fetch and finish (t0, t1)
    recorder: object
    trace: dict = None  # devtrace.summarize's, in the traced run

    def spans(self, name: str) -> list:
        return self.recorder.host_spans(name)

    def device_ms(self, name: str) -> list:
        return self.recorder.device_ms(name)

    @property
    def taps(self) -> dict:
        return self.recorder.taps


def _window_batches(rec, t_close):
    fetch = {(p, b[0]): (t0, t1) for _, p, b, _, t0, t1 in rec.host_spans("fetch") if b}
    out = []
    for _, p, b, _, t0, t1 in rec.host_spans("finish"):
        if b and t1 <= t_close:
            out.append({"pass": p, "first": b[0], "n": b[1], "fetch": fetch.get((p, b[0])),
                        "finish": (t0, t1)})
    return out


def _install_metric_spans(recorder, modules, traced: bool):
    """The spans the run's metric readers declare: host spans always,
    device spans and taps in the traced run only."""
    for module in modules:
        for name, target in getattr(module, "HOST_SPANS", {}).items():
            recorder.install(name, target, "host")
        if traced:
            for name, target in getattr(module, "DEVICE_SPANS", {}).items():
                recorder.install(name, target, "device")
            for name, (target, reader) in getattr(module, "TAPS", {}).items():
                recorder.install(name, target, "tap", reader)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, *, t_start: float,
             device: str = "cuda", workdir: str = None, size: tuple = None,
             take_frames: int = None, require_chip: bool = True, log=None) -> dict:
    """Run ``cell_name`` once. Returns the result object of the contract
    plus ``check``: {name: {"value", "limit"}} of every number compared."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = catalog.cell(cell_name)
    cfg = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    chips = next((w.get("chips", 1) for w in catalog.manifest()["workloads"]
                  if w["name"] == cell_name), 1)

    import torch

    if require_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise NoChip(f"cell {cell_name} needs {chips} CUDA device(s); "
                     f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                     f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    for key, value in mix.get("env", {}).items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)

    from mlvfs_tpu_torch import _build
    from mlvfs_tpu_torch.pipeline import convert, stream

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _build.build_all()
        log(f"kernel libraries ready in {time.perf_counter() - t:.3f} s")
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the benchmark loaded {loaded[:5]}: it may import neither jax nor mlvfs_tpu")

    batch = int(mix["batch"])
    frames = int(take_frames or mix["take_frames"])
    flags = list(mix["flags"])
    config = program_config(flags, device)
    if config.batch_size != batch:
        raise ValueError(f"traffic batch {batch} differs from the flags' batch {config.batch_size}")
    workdir = workdir or workdir_for(catalog.ROOT)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t = time.perf_counter()
        take = take_mod.write(os.path.join(workdir, TAKE_NAME + ".MLV"), cfg, frames, seed, batch, dev,
                              size)
        warm = take_mod.write(os.path.join(workdir, WARM_NAME + ".MLV"), cfg, 2 * batch,
                              seed ^ 0x5A5A5A5A, batch, dev, size)
        log(f"takes written in {time.perf_counter() - t:.3f} s ({take.frames} frames, "
            f"{take.width}x{take.height})")
        outdir = os.path.join(workdir, "dng")
        t = time.perf_counter()
        _remove_sidecars(warm.path)
        convert.convert_clip(warm.path, os.path.join(workdir, "warm"), config)
        shutil.rmtree(os.path.join(workdir, "warm"))
        if cuda:
            torch.cuda.synchronize()
        log(f"warm-up convert in {time.perf_counter() - t:.3f} s")

        modules = {name: catalog.metric(name) for name in catalog.metrics_of(cell_name, traced)}
        recorder = spans_mod.Recorder(cuda)
        for name, target in {**CORE_SPANS, **(LABEL_SPANS if traced else {})}.items():
            recorder.install(name, target)
        _install_metric_spans(recorder, modules.values(), traced)
        waits, takes = [], []
        deadline = [float("inf")]
        base_prefetcher = stream.BatchPrefetcher
        stream.BatchPrefetcher = _stoppable(base_prefetcher,
                                            lambda: time.perf_counter() >= deadline[0], waits)
        window = None
        try:
            if traced and cuda:
                import devtrace

                window = devtrace.DeviceWindow()
                window.start()
            cpu0 = _cpu_s()
            t0 = time.perf_counter()
            deadline[0] = t0 + seconds
            setup_s = t0 - t_start
            n_pass = 0
            while time.perf_counter() < deadline[0]:
                p0 = time.perf_counter()
                _remove_sidecars(take.path)
                recorder.take_pass = n_pass
                convert.convert_clip(take.path, outdir, config)
                takes.append((n_pass, p0, time.perf_counter()))
                n_pass += 1
            if window is not None:
                window.stop()
            elif cuda:
                torch.cuda.synchronize()
            cpu1 = _cpu_s()
        finally:
            stream.BatchPrefetcher = base_prefetcher
            recorder.uninstall()
        t_close = max(t1 for *_, t1 in recorder.host_spans("finish"))
        batches = _window_batches(recorder, t_close)
        n_frames = sum(b["n"] for b in batches)
        log(f"window: {n_pass} take passes, {len(batches)} batches and {n_frames} frames in "
            f"{t_close - t0:.3f} s, its last DNG {t_close - deadline[0]:.3f} s after --seconds")
        lengths = sorted(b - a for _, a, b in takes)
        log(f"take passes: shortest {lengths[0]:.3f} s, median {lengths[len(lengths) // 2]:.3f} s, "
            f"longest {lengths[-1]:.3f} s")
        log("host " + json.dumps(host_record(n_frames / (t_close - t0), takes, batches, waits, t0,
                                             cpu0, cpu1, t_close - t0)))
        trace = None
        if window is not None:
            import devtrace

            t = time.perf_counter()
            labels = _labels(recorder, waits, takes)
            trace = devtrace.summarize(window.device_spans(), window.t0, window.t1, labels)
            log(f"trace read in {time.perf_counter() - t:.3f} s")
        rec = Record(seconds=t_close - t0, setup_s=setup_s, frames=n_frames, batches=batches,
                     recorder=recorder, trace=trace)
        metrics = {}
        for name, module in modules.items():
            value = module.read(rec)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": module.UNIT}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                       "count": chips if cuda else 0,
                       "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
        if trace is not None:
            device_info["busy_s"] = trace["busy_s"]
            device_info["window_s"] = trace["window_s"]
        converted = sorted({b[0] for _, _, b, _, _, t1 in recorder.host_spans("finish") if b})
        del recorder, rec, modules
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t = time.perf_counter()
        check, failed = check_take(take, cell, mix, seed, outdir, dev, converted, log)
        log(f"check in {time.perf_counter() - t:.3f} s")
        result = {
            "correct": all(c["value"] <= c["limit"] for c in check.values()),
            "attempted": n_frames,
            "failed": failed,
            "metrics": metrics,
            "device": device_info,
        }
        if trace is not None:
            result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in trace["device_ops"]],
                                   "idle_gaps": trace["idle_gaps"]}
        result["check"] = check
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _cpu_s() -> tuple:
    """CPU seconds of the process (all its threads, ended ones included)
    and of the calling thread. Call it on the main thread."""
    times = os.times()
    return times.user + times.system, time.thread_time()


def host_record(rate, takes, batches, waits, t0, cpu0, cpu1, seconds) -> dict:
    """One run's host-side record for standard error: the rate, every take
    pass's length, the longest gap between two batches' last DNGs (the
    first from the window's start), the longest wait of the main thread
    for a batch's read, and the CPU over the window (``_cpu_s`` at its
    start and end): the process's in cores, the main thread's in % of the
    window."""
    ends = sorted(b["finish"][1] for b in batches)
    gaps = [b - a for a, b in zip([t0] + ends, ends)]
    return {"rate": round(rate, 4), "passes_s": [round(b - a, 3) for _, a, b in takes],
            "longest_batch_gap_s": round(max(gaps, default=0.0), 3),
            "longest_fetch_wait_s": round(max((b - a for a, b in waits), default=0.0), 3),
            "process_cores": round((cpu1[0] - cpu0[0]) / seconds, 3),
            "main_on_cpu_pct": round(100.0 * (cpu1[1] - cpu0[1]) / seconds, 2)}


def _labels(recorder, waits, takes) -> list:
    """Main-thread host spans, most specific first, naming the idle gaps."""
    labels = [(name, t0, t1) for name, _, _, thread, t0, t1 in recorder.host
              if thread == "MainThread" and name not in CORE_SPANS]
    labels += [("waiting for the next batch's read", a, b) for a, b in waits]
    labels += [("take pass: open, index, drain writes", a, b) for _, a, b in takes]
    return labels


def sample_batches(converted: list, k, seed: int) -> list:
    """The batches the check compares: all of ``converted`` for ``"all"``,
    else batch 0 (which every later batch's clip state comes from) and
    ``k`` others drawn from the seed."""
    if k == "all":
        return list(converted)
    rest = [b for b in converted if b != 0]
    picked = random.Random(int(seed) ^ 0x2545F491).sample(rest, min(int(k), len(rest)))
    return sorted(([0] if 0 in converted else []) + picked)


def frame_faults(tags, payload, expected, levels, bias, take, dual_iso: bool):
    """(differing pixels, header faults, not converted) of one frame."""
    black, white = take.config["camera"]["black_level"], take.config["camera"]["white_level"]
    d = int((payload != expected).sum())
    h = len(dngcheck.header_faults(tags, take.width, take.height, levels, bias))
    u = int(dual_iso and (tags.get(dngcheck.BLACK_LEVEL), tags.get(dngcheck.WHITE_LEVEL))
            != ((black * 4,), (white * 4,)))
    return d, h, u


def dng_frames(take, first: int, n: int, outdir: str):
    """(tags, payload) of the DNGs of frames [first, first + n), None for
    one that is missing or short."""
    return [dngcheck.read(os.path.join(outdir, f"{TAKE_NAME}_{first + k:06d}.dng")) for k in range(n)]


def compare(got, expected, levels, bias, take, dual_iso: bool) -> dict:
    """Totals of one batch's faults: ``got`` holds each frame's (tags,
    payload) or None."""
    t = {"px_diff": 0, "hdr_diff": 0, "missing": 0, "unconverted": 0, "bad": 0}
    for k, frame in enumerate(got):
        if frame is None:
            t["missing"] += 1
            t["bad"] += 1
            continue
        d, h, u = frame_faults(*frame, expected[k], levels[k], None if bias is None else bias[k],
                               take, dual_iso)
        t["px_diff"] += d
        t["hdr_diff"] += h
        t["unconverted"] += u
        t["bad"] += bool(d or h or u)
    return t


def reference_outputs(take, settings, batches, device, *, control=None):
    """Yield (first, expected (B, H, W) uint16 numpy, levels, bias) for
    ``batches`` in order, running the reference from batch 0 on so that the
    clip state (calibration, Bayer order, white level) is the take's.
    ``control``: ``"float32"`` runs every fused product in plain float32,
    ``"12bit"`` drops each sample's two low bits first."""
    import contextlib

    import torch

    from reference import pipeline as ref

    cam = camera_of(take)
    state = ref.ClipState()
    ctx = ref.float32_products() if control == "float32" else contextlib.nullcontext()
    with ctx, torch.no_grad():
        for first in sorted(set(batches) | {0}):
            frames = take_mod.make_frames(take, first, device)
            if control == "12bit":
                frames = frames & ~3
            out, levels, bias = ref.run_batch(frames.to(torch.int16), cam, settings, state)
            if first in batches:
                yield first, out.cpu().numpy().view("<u2"), levels, bias
            del out, frames


def check_take(take, cell, mix, seed, outdir, device, converted, log):
    """Compare the DNGs of the sampled batches with the reference. Returns
    ({name: {"value", "limit"}}, frames at fault)."""
    settings = reference_settings(list(mix["flags"]), take.batch)
    batches = sample_batches(converted, mix["check_batches"], seed)
    dual = settings.dual_iso == 2
    totals = {"px_diff": 0, "hdr_diff": 0, "missing": 0, "unconverted": 0, "bad": 0}
    for first, expected, levels, bias in reference_outputs(take, settings, batches, device):
        got = dng_frames(take, first, expected.shape[0], outdir)
        for key, value in compare(got, expected, levels, bias, take, dual).items():
            totals[key] += value
    limits = cell["limits"]
    check = {name: {"value": totals[name], "limit": limit} for name, limit in limits.items()}
    log(f"checked {sum(min(take.batch, take.frames - b) for b in batches)} frames, batches {batches}")
    return check, totals["bad"]
