"""The traced run's device window: torch.profiler over the window, reduced
to what the metrics read.

Only CUDA activity is recorded (kernels, copies and sets on the card), so
that a window of hundreds of thousands of launches stays cheap to record
and to read. The device's busy time is the union of those spans, the
arithmetic of ``chip_smoke.py`` ``profiled_convert``. The profiler's clock
is tied to the host's ``perf_counter`` by a marker: with the card idle,
the host notes the time and launches one small operation, the first the
trace holds; idle gaps are then named by the host span that covers them.
"""

from __future__ import annotations

import time


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit
    (``chip_smoke.py`` ``profiled_convert``)."""
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


class DeviceWindow:
    """torch.profiler with CUDA activity from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.marker_host_ns = None
        self.t0 = self.t1 = None

    def start(self):
        torch = self._torch
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # the marker: the trace's first device span
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def device_spans(self):
        """[(name, start_s, end_s)] on the host's perf_counter clock, the
        marker dropped, in start order."""
        torch = self._torch
        evs = [e for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in evs)
        if not spans:
            return []
        offset = spans[0][0] - self.marker_host_ns  # trace clock minus host clock
        return [(name, (s - offset) / 1e9, (e - offset) / 1e9) for s, e, name in spans[1:]]


def summarize(spans, t0: float, t1: float, host_spans, top: int = 10) -> dict:
    """Busy time, kernel time by name, and the longest idle gaps of the
    device spans inside [t0, t1], each gap named by the host span that
    covers its midpoint (``host_spans``: [(label, start, end)], the first
    match wins)."""
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in spans if e > t0 and s < t1]
    busy = busy_union((s, e) for _, s, e in inside)
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, end = [], t0
    for _, s, e in sorted(inside, key=lambda x: x[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(mid):
        for name, s, e in host_spans:
            if s <= mid <= e:
                return name
        return "host: other"

    return {
        "busy_s": busy,
        "window_s": t1 - t0,
        "kernel_s": by_name,
        "device_ops": sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": [[label((a + b) / 2), b - a] for a, b in gaps[:top]],
    }
