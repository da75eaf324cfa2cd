"""Spans around the program's functions, recorded from the benchmark's side.

A target is ``"module:Qualified.name"``. The recorder replaces the
function with a wrapper for the window and puts it back afterwards; it
edits no file of the program. Each call gives one span: its name, the take
pass it ran in, its batch (the first frame of an ``indices`` argument, if
the function has one: (first frame, frames)), the thread, and its start
and end on the host's ``perf_counter`` clock. A device span records a CUDA event on the calling
thread's current stream before and after the call; the events are read
only after the window. A tap calls a reader on each call's arguments and
result and sums what it returns: device tensors on the device, numbers on
the host.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import threading
import time


def resolve(target: str):
    """(owner object, attribute name, the function) of ``module:Qual.name``."""
    module_name, qual = target.split(":")
    owner = importlib.import_module(module_name)
    parts = qual.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1], getattr(owner, parts[-1])


class Recorder:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.take_pass = -1
        self.host = []  # (name, pass, batch or None, thread name, t0, t1)
        self.device = []  # (name, pass, batch or None, start event, end event)
        self.taps = {}  # name -> summed value (device tensor or number)
        self._restore = []
        self._names = set()
        self._lock = threading.Lock()

    def install(self, name: str, target: str, kind: str = "host", reader=None):
        """Wrap ``target`` for the span ``name`` (a name already installed is
        left as it is)."""
        if name in self._names:
            return
        self._names.add(name)
        owner, attr, fn = resolve(target)
        first_of = _first_frame_of(fn)
        rec = self

        if kind == "host":
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter()
                    with rec._lock:
                        rec.host.append((name, rec.take_pass, first_of(args, kwargs),
                                         threading.current_thread().name, t0, t1))
        elif kind == "device":
            import torch

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not rec.cuda:
                    return fn(*args, **kwargs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                with rec._lock:
                    rec.device.append((name, rec.take_pass, first_of(args, kwargs), start, end))
                return out
        elif kind == "tap":
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                for key, value in reader(args, kwargs, out).items():
                    with rec._lock:
                        rec.taps[key] = rec.taps[key] + value if key in rec.taps else value
                return out
        else:
            raise ValueError(f"unknown span kind {kind!r}")
        self._restore.append((owner, attr, fn))
        setattr(owner, attr, wrapper)

    def uninstall(self):
        while self._restore:
            owner, attr, fn = self._restore.pop()
            setattr(owner, attr, fn)
        self._names.clear()

    def host_spans(self, name: str) -> list:
        return [s for s in self.host if s[0] == name]

    def device_ms(self, name: str) -> list:
        """[(pass, batch, ms)] of a device span, after the window."""
        return [(p, f, a.elapsed_time(b)) for n, p, f, a, b in self.device if n == name]


def _first_frame_of(fn):
    """A function of (args, kwargs) giving the call's batch, (first frame,
    frames) of its ``indices`` argument, or None when it has none."""
    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        params = []
    if "indices" not in params:
        return lambda args, kwargs: None
    pos = params.index("indices")

    def first(args, kwargs):
        indices = kwargs["indices"] if "indices" in kwargs else args[pos] if pos < len(args) else None
        return (int(indices[0]), len(indices)) if indices is not None and len(indices) else None

    return first
