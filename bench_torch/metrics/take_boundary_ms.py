"""The compute stream's idle across a take boundary: the start of take
k+1's first ``decode`` device span less the end of take k's last
``process`` device span, both on the host's clock (the program's tracer
places its CUDA events there through an anchor taken at each take's
start; ``pipeline/convert.py`` ``convert_clip``); the mean over the
traced window's boundaries. The program's tracer is switched on when this
reader is loaded (the traced run only, after the warm-up). Nothing from a
window of one take, on the CPU, or from a program without the tracer."""

import importlib

SOURCE = "program_span"
UNIT = "ms"

_tracer = importlib.import_module("mlvfs_tpu_torch.utils.metrics")
if hasattr(_tracer, "enable"):
    _tracer.enable(device=True)


def gaps_ms(spans) -> list:
    """Each boundary's idle, in take order."""
    first, last = {}, {}
    for s in spans:
        if s.dev_t0 is None:
            continue
        if s.name == "decode":
            first[s.take] = min(first.get(s.take, s.dev_t0), s.dev_t0)
        elif s.name == "process":
            last[s.take] = max(last.get(s.take, s.dev_t1), s.dev_t1)
    return [(first[k + 1] - last[k]) / 1e6 for k in sorted(last) if k + 1 in first]


def read(rec):
    if not hasattr(_tracer, "spans"):
        return None
    gaps = gaps_ms(_tracer.spans())
    return sum(gaps) / len(gaps) if gaps else None
