"""Device time of the dual-ISO reconstruction's EV transforms a batch: the
program's own ``ev`` spans (``ops/evmath.py``, the outermost call of a
transform only) under each ``recon`` span (``ops/dualiso_full.py``
``reconstruct_batch``), summed; the mean over the traced window's ``recon``
spans. The program's tracer (``mlvfs_tpu_torch.utils.metrics``) is switched
on when this reader is loaded, which the harness does in the traced run
only, after the warm-up: every span it holds is the window's. A program
without the tracer gives nothing."""

import importlib

SOURCE = "program_span"
UNIT = "ms"

_tracer = importlib.import_module("mlvfs_tpu_torch.utils.metrics")
if hasattr(_tracer, "enable"):
    _tracer.enable(device=True)


def _under(span, names, by_id):
    """The id of the nearest ancestor of ``span`` named in ``names``, or None."""
    p = span.parent
    while p is not None and p in by_id:
        if by_id[p].name in names:
            return p
        p = by_id[p].parent
    return None


def read(rec):
    if not hasattr(_tracer, "spans"):
        return None
    spans = _tracer.spans()
    by_id = {s.id: s for s in spans}
    recon = {s.id: 0.0 for s in spans if s.name == "recon" and s.device_ms is not None}
    for s in spans:
        if s.name == "ev" and s.device_ms is not None:
            r = _under(s, ("recon",), by_id)
            if r in recon:
                recon[r] += s.device_ms
    return sum(recon.values()) / len(recon) if recon else None
