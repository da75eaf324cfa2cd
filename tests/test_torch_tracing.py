"""The port's tracer (``mlvfs_tpu_torch/utils/metrics.py``): spans, their
parents and batch ids, the outermost-only EV transform spans, tracing off,
when device times are read, a traced dual-ISO conversion, and the
benchmark's three readers of the spans on hand-made span lists (CPU)."""

import importlib.util
import os
import threading
import time
import types

import pytest
import torch

from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.ops import evmath
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip
from mlvfs_tpu_torch.utils import metrics

READERS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch",
                       "metrics")


@pytest.fixture(autouse=True)
def tracer():
    metrics.reset()
    yield metrics
    metrics.disable()
    metrics.reset()


def test_nesting_parents_and_host_times():
    metrics.enable()
    before = time.perf_counter_ns()
    with metrics.span("outer", batch=32) as outer:
        with metrics.span("inner", metrics.SYNC) as inner:
            pass
    after = time.perf_counter_ns()
    spans = {s.name: s for s in metrics.spans()}
    assert spans == {"outer": outer, "inner": inner}
    assert outer.parent is None and inner.parent == outer.id
    assert inner.batch == outer.batch == (outer.take, 32)
    assert inner.kind == metrics.SYNC and outer.kind == metrics.HOST
    assert before <= outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= after
    assert outer.thread == inner.thread == threading.current_thread().name
    assert outer.device_ms is None  # no CUDA events on the CPU
    totals = metrics.totals()
    assert totals["outer"]["self_ms"] == pytest.approx(outer.host_ms - inner.host_ms)


def test_ev_spans_are_outermost_only():
    metrics.enable()
    x = torch.linspace(1.0, 100.0, 64)
    evmath.fullres_weight(torch.arange(0, 1 << 20, 4099, dtype=torch.int32), 2048 * 64)  # cos_f32 inside
    evmath.fma(x, 2.0, 1.0)
    ev = [s for s in metrics.spans() if s.name == "ev"]
    assert len(ev) == 2 and all(s.parent is None and s.kind == metrics.DEVICE for s in ev)


def test_tracing_off_records_nothing():
    obj = object()
    ident = metrics.traced("ident")(lambda v: v)
    assert ident(obj) is obj
    assert metrics.span("off") is metrics.span("other")  # the shared no-op
    with metrics.span("off"):
        ident(obj)
    evmath.fma(torch.ones(4), 2.0, 1.0)
    with metrics.sync("read"):
        pass
    assert metrics.spans() == [] and metrics.counters() == {"syncs": 1}
    metrics.enable()
    assert ident(obj) is obj
    metrics.disable()
    ident(obj)
    assert [s.name for s in metrics.spans()] == ["ident"]


class _Event:
    """Stands in for a CUDA event recorded at ``at`` ms on the device's
    clock; ``done`` says whether the device has reached it."""

    def __init__(self, at, done=True):
        self.at, self.done, self.waited = at, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, other):
        return other.at - self.at


def _pending(name, anchor, start, end, done):
    """A finished device span whose events await reading."""
    s = metrics.Span(name, metrics.DEVICE)
    s.t0 = s.t1 = 0
    s._events = (_Event(start), (anchor, 1_000 * MS), _Event(end, done))
    metrics._records.append(s)
    metrics._unresolved.append(s)
    return s


def test_settle_reads_finished_spans_without_waiting():
    """`settle` reads spans in the order their end events were recorded and
    stops at the first the device has not reached; `spans` waits for the
    rest. Times land on the host clock through the span's anchor."""
    metrics.enable()
    anchor = _Event(10.0)
    a = _pending("a", anchor, 12.0, 15.5, True)
    b = _pending("b", anchor, 16.0, 20.0, False)
    c = _pending("c", anchor, 17.0, 18.0, True)  # finished, but recorded after b
    metrics.settle()
    assert (a.dev_t0, a.dev_t1) == (1_002 * MS, 1_005_500_000) and a.device_ms == pytest.approx(3.5)
    assert b.dev_t0 is None and c.dev_t0 is None and metrics._unresolved == [b, c]
    assert not b._events[2].waited
    assert metrics.spans() == [a, b, c]
    assert b._events is None and b.device_ms == pytest.approx(4.0) and c.dev_t0 == 1_007 * MS
    assert metrics._unresolved == []


def test_take_end_reads_no_events():
    """The end of a take reads nothing: its device spans stay unread until
    the next `settle` or `spans`, so reading never falls in a boundary."""
    metrics.enable()
    with metrics.take():
        s = _pending("process", _Event(0.0), 1.0, 2.0, True)
    assert metrics._unresolved == [s] and s.dev_t0 is None
    metrics.settle()
    assert metrics._unresolved == [] and s.device_ms == pytest.approx(1.0)


@pytest.mark.parametrize("device", [False, True, "cpu", "cuda:1", torch.device("cpu")])
def test_enable_without_a_card_keeps_host_times(device):
    """Without a card every form of ``device`` traces host times only, and
    so do the CPU's forms on any machine: device spans get no events and
    no device time."""
    if device in (True, "cuda:1") and torch.cuda.is_available():
        pytest.skip("a card is present: device spans record events on it")
    metrics.enable(device=device)
    with metrics.span("process", metrics.DEVICE, batch=0) as s:
        pass
    assert metrics._device is None and s._events is None
    assert metrics.spans() == [s] and s.device_ms is None and s.host_ms >= 0


def test_compressed_dng_encode_span(tmp_path):
    """With LJ92 output each batch's encode is a `finish.encode` span inside
    its `finish.render`."""
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=32, frames=4)
    metrics.enable()
    convert_clip(src, str(tmp_path / "out"), ProcessingConfig(device="cpu", batch_size=2,
                                                              compress="lj92"))
    spans = metrics.spans()
    by_id = {s.id: s for s in spans}
    encode = [s for s in spans if s.name == "finish.encode"]
    assert sorted(s.batch[1] for s in encode) == [0, 2]
    assert all(by_id[s.parent].name == "finish.render" for s in encode)


def _dual_iso_clip(tmp_path):
    path = str(tmp_path / "DI.MLV")
    synth.write_mlv(path, width=128, height=96, frames=6, dual_iso=3, dual_iso_phase=0)
    return path


def _convert(src, outdir):
    cfg = ProcessingConfig(device="cpu", dual_iso=2, hdr_interpolation_method=1, batch_size=2)
    paths = convert_clip(src, outdir, cfg)
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


def test_traced_dual_iso_convert(tmp_path):
    """Every batch has its fetch, decode, process and finish on three
    threads under one batch id; the take has its five children; every EV
    transform of the reconstruction lies inside a recon span; the DNGs
    are the untraced conversion's, byte for byte."""
    src = _dual_iso_clip(tmp_path)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the machine's cores
    try:
        untraced = _convert(src, str(tmp_path / "off"))
        metrics.reset()  # the counters count with tracing off too
        metrics.enable(device=True)
        traced = _convert(src, str(tmp_path / "on"))
    finally:
        torch.set_num_threads(n_threads)
    assert traced == untraced and len(traced) == 6

    spans = metrics.spans()
    by_id = {s.id: s for s in spans}
    (take,) = [s for s in spans if s.name == "take"]
    children = sorted(s.name for s in spans if s.parent == take.id and s.name.startswith("take."))
    assert children == ["take.close", "take.drain", "take.open", "take.save_cal", "take.setup"]
    batches = {(take.take, f) for f in (0, 2, 4)}
    threads = {}
    for name in ("fetch", "decode", "process", "finish"):
        named = [s for s in spans if s.name == name]
        assert {s.batch for s in named} == batches and len(named) == 3, name
        threads[name] = {s.thread for s in named}
    main = threading.current_thread().name
    assert threads["decode"] == threads["process"] == {main}
    assert main not in threads["fetch"] | threads["finish"]
    assert not threads["fetch"] & threads["finish"]

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s

    recon = [s for s in spans if s.name == "recon"]
    assert len(recon) == 3 and all(r.batch in batches for r in recon)
    for r in recon:
        kids = [s for s in spans if s.parent == r.id]
        assert sorted(s.name for s in kids) == sorted(
            ["recon.match", "recon.interp", "recon.blend", "recon.chroma20", "recon.alias", "recon.final"])
    ev = [s for s in spans if s.name == "ev" and s.thread == main
          and any(r.t0 <= s.t0 and s.t1 <= r.t1 for r in recon)]
    assert ev
    for s in ev:
        up = list(ancestors(s))
        assert any(a.name == "recon" for a in up) and not any(a.name == "ev" for a in up)
    counters = metrics.counters()
    assert counters["frames"] == 6 and counters["dualiso.frames_seen"] == 6
    assert 0 < counters["dualiso.frames_converted"] <= 6
    assert counters["syncs"] >= 3  # the analysis readback a batch, the Bayer order once
    assert "recon.interp" in metrics.report()


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", os.path.join(READERS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(id, name, kind="device", parent=None, take=1, first=0, t=(0, 1), dev=None):
    ms = None if dev is None else (dev[1] - dev[0]) / 1e6
    return types.SimpleNamespace(id=id, name=name, kind=kind, parent=parent, take=take,
                                 batch=(take, first), t0=t[0], t1=t[1], host_ms=(t[1] - t[0]) / 1e6,
                                 dev_t0=None if dev is None else dev[0],
                                 dev_t1=None if dev is None else dev[1], device_ms=ms)


MS = 1_000_000  # ns


def _spans_of_two_batches():
    """Two batches of one take and the first of the next: decode, process
    with a recon (its interp, EV spans inside and outside the interp, a
    sync nested in process), and an EV span outside any recon."""
    out = []
    for k, (take, first, t) in enumerate([(1, 0, 0), (1, 16, 1000), (2, 0, 3000)]):
        b = 100 * k
        out += [
            _span(b + 1, "decode", take=take, first=first, t=(t * MS, (t + 5) * MS),
                  dev=(t * MS, (t + 2) * MS)),
            _span(b + 2, "process", take=take, first=first, t=((t + 5) * MS, (t + 45) * MS),
                  dev=((t + 6) * MS, (t + 900) * MS)),
            _span(b + 3, "recon", parent=b + 2, take=take, first=first, dev=((t + 50) * MS, (t + 850) * MS)),
            _span(b + 4, "recon.interp", parent=b + 3, take=take, first=first,
                  dev=((t + 60) * MS, (t + 360) * MS)),
            _span(b + 5, "ev", parent=b + 4, take=take, first=first, dev=((t + 70) * MS, (t + 170) * MS)),
            _span(b + 6, "ev", parent=b + 3, take=take, first=first, dev=((t + 400) * MS, (t + 450) * MS)),
            _span(b + 7, "sync.analysis", kind="sync", parent=b + 2, take=take, first=first,
                  t=((t + 10) * MS, (t + 30) * MS)),
            _span(b + 8, "ev", parent=b + 2, take=take, first=first, dev=((t + 7) * MS, (t + 9) * MS)),
            _span(b + 9, "wait.fetch", kind="sync", take=take, first=first, t=((t - 3) * MS, t * MS)),
        ]
    return out


@pytest.mark.parametrize("name, expected", [
    ("recon_ev_ms", 150.0),  # 100 + 50 under each recon; the EV span outside recon not counted
    ("recon_interp_ms", 300.0),
    ("take_boundary_ms", 1100.0),  # take 2's first decode (3000) - take 1's last process (1000 + 900)
])
def test_readers_on_hand_made_spans(name, expected, monkeypatch):
    reader = _reader(name)
    assert reader.SOURCE == "program_span" and reader.UNIT == "ms"
    metrics.disable()  # the reader switched tracing on when loaded
    spans = _spans_of_two_batches()
    monkeypatch.setattr(metrics, "spans", lambda: spans)
    assert reader.read(None) == pytest.approx(expected)
    monkeypatch.setattr(metrics, "spans", lambda: [])
    assert reader.read(None) is None


def test_readers_give_nothing_on_the_cpu(monkeypatch):
    """Spans without device times (a CPU run) give no reading."""
    spans = [_span(1, "decode", t=(0, 5 * MS)), _span(2, "process", t=(5 * MS, 9 * MS)),
             _span(3, "recon", parent=2), _span(4, "recon.interp", parent=3), _span(5, "ev", parent=4)]
    monkeypatch.setattr(metrics, "spans", lambda: spans)
    for name in ("recon_ev_ms", "recon_interp_ms", "take_boundary_ms"):
        assert _reader(name).read(None) is None, name


def test_profile_trace_holds_the_spans(tmp_path, monkeypatch):
    """Under MLVFS_TPU_PROFILE the tracer's spans are profiler
    ranges, with tracing off."""
    from mlvfs_tpu_torch import cli

    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=2)
    monkeypatch.setenv("MLVFS_TPU_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["convert", src, "-o", str(tmp_path / "out"), "--device", "cpu"]) == 0
    (name,) = os.listdir(tmp_path / "prof")
    text = (tmp_path / "prof" / name).read_text()
    for span in ("take", "take.open", "wait.fetch", "decode", "process", "take.drain"):
        assert f'"name": "{span}"' in text, span
    assert metrics.spans() == []
