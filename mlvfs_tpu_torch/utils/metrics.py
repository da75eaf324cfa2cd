"""Observability: structured logs, per-stage counters, profiler hook.

Counterpart of ``mlvfs_tpu/utils/metrics.py`` with the same API:

  - `log` — a standard logger ("mlvfs_tpu_torch"), level from MLVFS_TPU_LOG;
  - `metrics` — process-wide per-stage wall time + frame/byte counters,
    reported by the CLI after conversion;
  - `trace` — context manager that records a region with torch.profiler
    (CPU and, when present, CUDA activity) and writes a Chrome trace into
    the directory named by MLVFS_TPU_PROFILE, when that is set.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

log = logging.getLogger("mlvfs_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("MLVFS_TPU_LOG", "WARNING").upper())


class _Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.stage_seconds = {}
        self.counters = {}

    def add_time(self, stage: str, seconds: float):
        with self._lock:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + seconds

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "stage_seconds": dict(self.stage_seconds),
                "counters": dict(self.counters),
            }

    def reset(self):
        with self._lock:
            self.stage_seconds.clear()
            self.counters.clear()

    def report(self) -> str:
        snap = self.snapshot()
        # stages run concurrently (readback/write overlap the next batch's
        # decode/process), so stage times do not sum to wall-clock
        lines = ["  (stages overlap; columns do not sum to wall time)"]
        frames = snap["counters"].get("frames", 0)
        for stage, secs in sorted(snap["stage_seconds"].items()):
            per = f" ({frames / secs:.1f} fps)" if frames and secs > 0 else ""
            lines.append(f"  {stage:<12} {secs:8.3f}s{per}")
        for name, value in sorted(snap["counters"].items()):
            lines.append(f"  {name:<12} {value}")
        return "\n".join(lines)


metrics = _Metrics()


class StageTimer:
    """with StageTimer('decode'): ... — accumulates host wall time into `metrics`.

    Device work is asynchronous: a stage that only enqueues kernels is charged
    the enqueue, and the wait lands in whichever stage synchronizes next
    (the readback)."""

    def __init__(self, stage: str):
        self.stage = stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        metrics.add_time(self.stage, time.perf_counter() - self.t0)
        return False


@contextlib.contextmanager
def trace(name: str):
    """torch.profiler trace of the region when MLVFS_TPU_PROFILE is set."""
    profile_dir = os.environ.get("MLVFS_TPU_PROFILE")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.{os.getpid()}.json"))
