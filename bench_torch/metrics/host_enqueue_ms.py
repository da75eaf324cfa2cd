"""The main thread's issue a batch: the host ms of the program's ``decode``
and ``process`` spans (``pipeline/convert.py`` ``ClipConverter.convert``)
less the host ms of the ``sync`` spans under them (each device-to-host
read the thread waits on: the analysis' readback, the Bayer order, the
levels), the mean over the traced window's batches. Since the device waits
for the main thread in the dual-ISO cells, this is the work that sets their
pace. The program's tracer is switched on when this reader is loaded (the
traced run only, after the warm-up). Nothing from a run whose spans have
no device times (the CPU), or from a program without the tracer. Logs on
standard error the ``decode`` + ``process`` host ms a batch it starts
from, which the reading lies below."""

import importlib
import sys

SOURCE = "program_span"
UNIT = "ms"
ISSUE = ("decode", "process")

_tracer = importlib.import_module("mlvfs_tpu_torch.utils.metrics")
if hasattr(_tracer, "enable"):
    _tracer.enable(device=True)


def _issue_span(span, by_id):
    """The ``decode`` or ``process`` span that ``span`` runs under, or None;
    also None for a sync span under another sync span (counted once)."""
    p = span.parent
    while p is not None and p in by_id:
        up = by_id[p]
        if up.kind == "sync":
            return None
        if up.name in ISSUE:
            return up
        p = up.parent
    return None


def read(rec):
    if not hasattr(_tracer, "spans"):
        return None
    spans = _tracer.spans()
    by_id = {s.id: s for s in spans}
    issue = {}
    for s in spans:
        if s.name in ISSUE and s.dev_t0 is not None:
            issue[s.batch] = issue.get(s.batch, 0.0) + s.host_ms
    if not issue:
        return None
    gross = sum(issue.values()) / len(issue)
    for s in spans:
        if s.kind == "sync":
            up = _issue_span(s, by_id)
            if up is not None and up.dev_t0 is not None:
                issue[up.batch] -= s.host_ms
    net = sum(issue.values()) / len(issue)
    print(f"host_enqueue_ms: decode + process {gross:.4f} ms a batch, less their sync spans "
          f"{net:.4f}, over {len(issue)} batches", file=sys.stderr, flush=True)
    return net
