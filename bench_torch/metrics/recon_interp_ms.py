"""Device time a batch of the dual-ISO reconstruction's interpolation: the
program's own ``recon.interp`` span (``ops/dualiso_full.py``
``reconstruct_batch``: amaze-edge with kernels #8, #10 and #6, or mean23,
with the EV transforms inside it and the border interpolation); the mean
over the traced window's spans. The program's tracer is switched on when
this reader is loaded (the traced run only, after the warm-up). A program
without the tracer gives nothing."""

import importlib

SOURCE = "program_span"
UNIT = "ms"

_tracer = importlib.import_module("mlvfs_tpu_torch.utils.metrics")
if hasattr(_tracer, "enable"):
    _tracer.enable(device=True)


def read(rec):
    if not hasattr(_tracer, "spans"):
        return None
    ms = [s.device_ms for s in _tracer.spans() if s.name == "recon.interp" and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
