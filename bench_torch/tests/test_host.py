"""The host side of a run: the ``host`` record of standard error, and the
``host_enqueue_ms`` reader on hand-made spans. No card needed."""

import importlib.util
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402

MS = 1_000_000  # ns


def test_host_record():
    """Three batches over two passes: the longest gap is the window's
    start to the first batch's last DNG; CPU readings over a 2-s window."""
    batches = [{"finish": (0.5, t)} for t in (10.4, 10.9, 11.2)]
    r = harness.host_record(24.0, [(0, 10.0, 11.0), (1, 11.0, 11.25)], batches,
                            [(10.0, 10.1), (10.5, 10.75)], 10.0, (3.0, 1.0), (7.0, 2.5), 2.0)
    assert r["rate"] == 24.0 and r["passes_s"] == [1.0, 0.25]
    assert r["longest_batch_gap_s"] == 0.5 and r["longest_fetch_wait_s"] == 0.25
    assert r["process_cores"] == 2.0 and r["main_on_cpu_pct"] == 75.0


def _reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"test_reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(id, name, kind="device", parent=None, take=1, first=0, t=(0, 1), dev=None):
    return types.SimpleNamespace(id=id, name=name, kind=kind, parent=parent, take=take,
                                 batch=(take, first), t0=t[0], t1=t[1], host_ms=(t[1] - t[0]) / 1e6,
                                 dev_t0=None if dev is None else dev[0],
                                 dev_t1=None if dev is None else dev[1])


def _batches(device=True):
    """Three batches over two takes: decode 5 ms, process 40 ms with a
    20-ms sync under it (and a sync nested in that one), an EV span, and a
    wait for the read outside both."""
    out = []
    for k, (take, first, t) in enumerate([(1, 0, 0), (1, 16, 1000), (2, 0, 3000)]):
        b = 100 * k
        dev = (lambda a, z: ((t + a) * MS, (t + z) * MS)) if device else (lambda a, z: None)
        out += [
            _span(b + 1, "decode", take=take, first=first, t=(t * MS, (t + 5) * MS), dev=dev(0, 2)),
            _span(b + 2, "process", take=take, first=first, t=((t + 5) * MS, (t + 45) * MS),
                  dev=dev(6, 900)),
            _span(b + 3, "recon", parent=b + 2, take=take, first=first, dev=dev(50, 850)),
            _span(b + 4, "sync.analysis", kind="sync", parent=b + 3, take=take, first=first,
                  t=((t + 10) * MS, (t + 30) * MS)),
            _span(b + 5, "sync.inner", kind="sync", parent=b + 4, take=take, first=first,
                  t=((t + 12) * MS, (t + 14) * MS)),
            _span(b + 6, "ev", parent=b + 2, take=take, first=first, dev=dev(7, 9)),
            _span(b + 7, "wait.fetch", kind="sync", take=take, first=first, t=((t - 3) * MS, t * MS)),
        ]
    return out


def test_host_enqueue_ms(monkeypatch, capsys):
    reader = _reader("host_enqueue_ms")
    assert reader.SOURCE == "program_span" and reader.UNIT == "ms"
    reader._tracer.disable()  # the reader switched tracing on when loaded
    spans = _batches()
    monkeypatch.setattr(reader._tracer, "spans", lambda: spans)
    assert reader.read(None) == pytest.approx(5 + 40 - 20)
    assert "decode + process 45.0000 ms a batch, less their sync spans 25.0000, over 3 batches" in \
        capsys.readouterr().err
    cpu = _batches(device=False)
    monkeypatch.setattr(reader._tracer, "spans", lambda: cpu)
    assert reader.read(None) is None
    monkeypatch.setattr(reader._tracer, "spans", lambda: [])
    assert reader.read(None) is None
