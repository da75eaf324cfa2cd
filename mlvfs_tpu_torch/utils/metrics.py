"""Observability: structured logs, the program's tracer and counters, the
profiler hook.

  - `log` — a standard logger ("mlvfs_tpu_torch"), level from MLVFS_TPU_LOG;
  - spans — `span(name, kind)` (a context manager), `traced(name, kind)`
    (a decorator) and `take()` (one take's conversion). A span records its
    name, its kind (`HOST`, `DEVICE`, or `SYNC`: the thread waits), start
    and end on the host's ``time.perf_counter_ns`` clock, the thread, the
    span open below it on the same thread (its parent), the take and the
    batch, ``(take, first frame)``, which every span of a batch shares on
    any thread. A device span also records a CUDA event before and after,
    on the current stream of the traced device (none while the stream
    captures a CUDA graph: such a span keeps its host times only); the
    events are placed on the host clock through an anchor (an event whose
    host time is known), taken when tracing is switched on and again at
    each take's start.
    They are read, and dropped, by `settle()`, which the converting thread
    calls once it has enqueued a batch (so the reading overlaps the
    device's work, and never falls in a take boundary), and by `spans()`;
  - counters — `count(name, n)`, kept whether or not tracing is on;
  - `trace` — a context manager that records a region with torch.profiler
    (CPU and, when present, CUDA activity) and writes a Chrome trace into
    the directory named by MLVFS_TPU_PROFILE, when that is set. Inside it
    every span, on any thread, also opens a ``record_function`` range of
    its name, so the trace shows the program's layers over the kernels.
    Profilers started elsewhere get no ranges.

Tracing is off by default: a span site then tests one flag and returns a
shared no-op context (the decorator calls straight through), and nothing
is recorded. `enable(device)` switches it on, `disable()` off; `spans()`
returns the records, `reset()` clears them and the counters, `report()`
sums them per span name (what ``convert -v`` prints).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
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

HOST, DEVICE, SYNC = "host", "device", "sync"

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_reading = threading.Lock()  # one thread reads events at a time
_local = threading.local()
_ids = itertools.count(1)
_active = False  # a span site does anything: recording, or the ranges inside trace()
_recording = False
_device = None  # the CUDA device whose current stream device spans record events on
_ranges = False  # inside trace(): spans open record_function ranges
_records = []
_unresolved = []  # device spans whose events are not read yet
_counters = {}
_take = 0
_anchor = None  # (CUDA event, its host time in ns)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span. ``t0``/``t1`` are host ns; ``dev_t0``/``dev_t1`` the device
    span's start and end on the same clock (None for other kinds, on the
    CPU, or until read)."""

    __slots__ = ("id", "name", "kind", "thread", "parent", "take", "batch", "t0", "t1",
                 "dev_t0", "dev_t1", "_events", "_range")

    def __init__(self, name: str, kind: str = HOST, first=None):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.name = name
        self.kind = kind
        self.thread = threading.current_thread().name
        self.parent = parent.id if parent is not None else None
        self.take = parent.take if parent is not None else _take
        if first is not None:
            self.batch = (self.take, int(first))
        else:
            self.batch = parent.batch if parent is not None else None
        self.t0 = self.t1 = self.dev_t0 = self.dev_t1 = None
        self._events = self._range = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def device_ms(self):
        return None if self.dev_t0 is None else (self.dev_t1 - self.dev_t0) / 1e6

    def __enter__(self):
        if _ranges:
            from torch.autograd.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        if self.kind == DEVICE and _device is not None:
            import torch

            if not torch.cuda.is_current_stream_capturing():
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(_device))
                self._events = (start, _anchor)
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        if self._events is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(_device))
            self._events += (end,)
        if _recording:
            with _lock:
                _records.append(self)
                if self._events is not None:
                    _unresolved.append(self)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, kind: str = HOST, batch=None):
    """``with span("decode", DEVICE, batch=indices[0]):`` — ``batch`` (the
    batch's first frame) is inherited from the parent span when omitted."""
    return Span(name, kind, batch) if _active else _NOOP


def traced(name: str, kind: str = HOST, *, outermost: bool = False):
    """Decorator: each call is a span ``name``. With ``outermost`` a call
    made inside an open span of the same name on its thread records
    nothing."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _active or (outermost and any(s.name == name for s in _stack())):
                return fn(*args, **kwargs)
            with Span(name, kind):
                return fn(*args, **kwargs)

        return wrapper

    return wrap


def sync(what: str):
    """A device→host read on the converting thread: counted as ``syncs``,
    and a ``sync.<what>`` span."""
    count("syncs")
    return span("sync." + what, SYNC)


@contextlib.contextmanager
def take():
    """The ``take`` span around one take's conversion: a new take id and a
    new anchor (the compute stream is idle here: the last take's writes
    were drained)."""
    global _take, _anchor
    if not _active:
        yield
        return
    with _lock:
        _take += 1
    if _recording and _device is not None:
        _anchor = _new_anchor()
    with Span("take"):
        yield


def _new_anchor():
    import torch

    stream = torch.cuda.current_stream(_device)
    stream.synchronize()
    event = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter_ns()
    event.record(stream)
    event.synchronize()
    return event, t


def _resolve(wait: bool):
    """Device spans' events → times on the host clock; the events are
    dropped. Without ``wait`` only the spans whose work has finished, in
    the order their end events were recorded on the one stream, stopping
    at the first unfinished one."""
    with _reading:
        with _lock:
            todo = list(_unresolved)
        done = 0
        for s in todo:
            start, (anchor, anchor_ns), end = s._events
            if wait:
                end.synchronize()
            elif not end.query():
                break
            s.dev_t0 = anchor_ns + round(anchor.elapsed_time(start) * 1e6)
            s.dev_t1 = s.dev_t0 + round(start.elapsed_time(end) * 1e6)
            s._events = None
            done += 1
        with _lock:
            del _unresolved[:done]


def settle():
    """Read the device spans whose work has finished, without waiting. The
    converting thread calls it after enqueueing each batch, while the
    device has that batch's work ahead of it."""
    if _unresolved:
        _resolve(wait=False)


def enable(device=False):
    """Switch tracing on. ``device``: the CUDA device (a ``torch.device``
    or its name) whose current stream device spans record events on;
    True for the current CUDA device; False, or a CPU device, for host
    times only (so too without a card). Idempotent."""
    global _recording, _device, _active, _anchor
    dev = None
    if device is not False and device is not None:
        import torch

        if torch.cuda.is_available():
            dev = torch.device("cuda") if device is True else torch.device(device)
            if dev.type != "cuda":
                dev = None
            elif dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
    if _recording and _device == dev:
        return
    _device = dev
    if dev is not None:
        _anchor = _new_anchor()
    _recording = _active = True


def disable():
    global _recording, _device, _active
    _recording = False
    _device = None
    _active = _ranges


def spans() -> list:
    """The finished spans, device times read."""
    _resolve(wait=True)
    with _lock:
        return list(_records)


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset():
    with _lock:
        _records.clear()
        _unresolved.clear()
        _counters.clear()


def totals(records=None) -> dict:
    """{span name: {"count", "host_ms", "self_ms", "device_ms"}} over
    ``records`` (default: `spans()`); self time is the span's host time
    minus its children's, device_ms None where no span of the name has one."""
    records = spans() if records is None else records
    children = {}
    for s in records:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.host_ms
    out = {}
    for s in records:
        t = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None})
        t["count"] += 1
        t["host_ms"] += s.host_ms
        t["self_ms"] += s.host_ms - children.get(s.id, 0.0)
        if s.device_ms is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + s.device_ms
    return out


def report() -> str:
    # spans run concurrently (readback and writes overlap the next batch's
    # decode and process), so host times do not sum to wall time
    lines = ["  (spans overlap across threads; columns do not sum to wall time)",
             f"  {'span':<24} {'count':>6} {'host ms':>11} {'self ms':>11} {'device ms':>11}"]
    for name, t in sorted(totals().items()):
        dev = "-" if t["device_ms"] is None else f"{t['device_ms']:11.3f}"
        lines.append(f"  {name:<24} {t['count']:>6} {t['host_ms']:11.3f} {t['self_ms']:11.3f} "
                     f"{dev:>11}")
    for name, value in sorted(counters().items()):
        lines.append(f"  {name:<24} {value}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str):
    """torch.profiler trace of the region when MLVFS_TPU_PROFILE is set."""
    global _ranges, _active
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
        _ranges = _active = True
        try:
            with record_function(name):
                yield
        finally:
            _ranges = False
            _active = _recording
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.{os.getpid()}.json"))
