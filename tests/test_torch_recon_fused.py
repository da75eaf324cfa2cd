"""The dual-ISO reconstruction's fused float stages (``ops/dualiso_recon.py``,
``csrc/dualiso_recon.cu``) and the analysis' CUDA graphs
(``ops/dualiso_analysis_dev.py``).

On the CPU: the stage twins, composed as ``reconstruct_batch`` composes
them, give the earlier composition's output bit for bit (the benchmark's
plain reference, ``bench_torch/reference/dualiso_full.py``, a copy of it);
the graph cache's rule with a stand-in capture. Marked ``cuda``: each
kernel against its twin on the card, and a replayed analysis against the
eager one. This file imports torch and the port only (no jax), so the GPU
machine runs it on its own:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_recon_fused.py
"""

import contextlib
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.ops import alias, dualiso_analysis_dev, dualiso_full, dualiso_recon, evmath
from mlvfs_tpu_torch.utils import metrics

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch"))
from reference import dualiso_full as before  # noqa: E402

BLACK, WHITE = 2048, 15000
BLACK20, WHITE20 = BLACK * 64, WHITE * 64
CSRC = os.path.join(os.path.dirname(dualiso_recon.__file__), "..", "csrc", "dualiso_recon.cu")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _rows(phase, hh):
    """row_bright and s of a frame whose dark rows start at ``phase``."""
    ib = np.array([((q - phase) % 4) >= 2 for q in range(4)])
    ys = np.arange(hh)
    return ib[ys % 4], np.where(ib[ys % 4] == ib[(ys + 1) % 4], -1, 1).astype(np.int32)


def _batch(b=2, h=64, w=96, seed=5):
    """Interlaced 14-bit frames (B, H, W) int16 with raw-0, white-clipped and
    overexposed pixels, and per-frame scalars as the analysis gives them
    for a 3-EV dual-ISO pair."""
    rng = np.random.default_rng(seed)
    frames, rbs, ss = [], [], []
    for i in range(b):
        phase = 2 * (i % 2)
        spec = synth.SynthSpec(width=w, height=h, frames=1, dual_iso=3, dual_iso_phase=phase)
        f = synth.make_frame_data(spec, rng).astype(np.int64)
        f[rng.random((h, w)) < 0.02] = 0  # dead pixels: raw 0
        f[rng.random((h, w)) < 0.03] = 16383  # clipped past the white level
        f[h // 3 : h // 3 + 9, w // 4 : w // 4 + 13] = 15500  # an overexposed patch, bright and dark rows
        frames.append(f)
        rb, s = _rows(phase, h)
        rbs.append(rb)
        ss.append(s)
    imgs = torch.from_numpy(np.stack(frames).astype(np.uint16).view(np.int16))
    a = torch.tensor([0.125, 0.1251] * b, dtype=torch.float32)[:b]
    b20 = torch.tensor([-640.0, 912.0] * b, dtype=torch.float32)[:b]
    wd = evmath.fma((WHITE20 - BLACK20) + b20, a, float(BLACK20)).to(torch.int32)
    ce = torch.tensor([3.0, 2.9985] * b, dtype=torch.float32)[:b]
    ov = torch.tensor([3.25, 3.5] * b, dtype=torch.float32)[:b]
    return (imgs, torch.from_numpy(np.stack(rbs)), torch.from_numpy(np.stack(ss)), a, b20, wd, ce, ov)


# ------------------------------------------------------ the twins (CPU)


@pytest.mark.parametrize("interp_method, use_fullres, use_alias, cs_method", [
    (1, True, True, 0), (1, False, True, 0), (1, True, False, 0), (1, True, True, 2), (1, False, False, 3),
    (0, True, True, 0), (0, False, False, 3)])  # amaze-edge's twin takes ~2 s a case here
def test_stages_compose_as_before(interp_method, use_fullres, use_alias, cs_method):
    """The reconstruction, now the stage twins composed around the
    interpolation, the smoothing and #7, equals the earlier composition on
    the CPU bit for bit, in both interpolations and the options' cases."""
    args = _batch()
    kw = dict(black20=BLACK20, white20=WHITE20, interp_method=interp_method, use_fullres=use_fullres,
              use_alias=use_alias, cs_method=cs_method, exact_luts=False)
    launches = dualiso_recon.KERNEL_LAUNCHES
    got = dualiso_full.reconstruct_batch(*args, **kw)
    assert dualiso_recon.KERNEL_LAUNCHES == launches  # the CPU runs the twins
    want = before.reconstruct_batch(*args, **kw)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    # the frames converted at all: most pixels moved off their input
    assert (got != args[0]).float().mean() > 0.5


def test_stages_with_the_tables_compose_as_before():
    """``exact_luts`` keeps the twins over the tables."""
    args = _batch(seed=6)
    kw = dict(black20=BLACK20, white20=WHITE20, interp_method=1, use_fullres=True, use_alias=True,
              cs_method=0, exact_luts=True)
    assert torch.equal(dualiso_full.reconstruct_batch(*args, **kw), before.reconstruct_batch(*args, **kw))


def test_blend_with_planes_is_blend_then_planes():
    """The public blend with ``planes`` gives the twins' blend followed by
    the alias planes of its own full-res and half-res, the full-res EV
    plane shared."""
    imgs, rb, s, a, b20, wd, ce, ov = _batch(seed=7)
    raw = dualiso_recon.match(imgs, rb, a, b20, black20=BLACK20)
    dark, bright = raw, torch.clamp(raw * 7 // 3, max=(1 << 20) - 1)
    levels = dict(black20=BLACK20, white20=WHITE20)
    fullres, halfres, over, none = dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=True,
                                                       planes=False, use_alias=True, **levels)
    *nones, over2, planes = dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=True, planes=True,
                                                use_alias=True, **levels)
    assert none is None and nones == [None, None]
    want = dualiso_recon.alias_planes(bright, fullres, halfres, None, use_alias=True, **levels)
    assert torch.equal(over, over2) and planes[3] is planes[2]
    for g, w in zip(planes, want):
        assert torch.equal(g, w)
    assert over.any() and not over.all()


def test_kernel_constants_are_the_twins():
    """csrc/dualiso_recon.cu's float32 literals are the values PyTorch
    multiplies by on the card (the reciprocal of a Python divisor, as
    float32) and the twins' constants."""
    src = open(CSRC).read()

    def literal(name):
        return float.fromhex(re.search(rf"constexpr float {name} = (0x[0-9a-fp.+-]+)f;", src).group(1))

    one = np.float32(1.0)
    assert literal("INV_200") == float(one / np.float32(200.0))
    assert literal("INV_ALIAS_MAX") == float(one / np.float32(dualiso_recon.ALIAS_MAP_MAX))
    assert literal("PI_F32") == float(np.float32(math.pi))
    assert literal("SIG_SCALE") == 1 / (4 * dualiso_recon.DARK_NOISE20)
    assert f"constexpr float FULLRES_THR = {dualiso_recon.FULLRES_THR}f;" in src
    assert f"constexpr int E_LIN_NOISE = {int(dualiso_recon.DARK_NOISE20) * 3 // 2};" in src


def test_stages_refuse_another_device():
    imgs, rb, s, a, b20, wd, ce, ov = _batch(b=1)
    with pytest.raises(ValueError, match="unsupported device"):
        dualiso_recon.match(imgs.to("meta"), rb.to("meta"), a.to("meta"), b20.to("meta"), black20=BLACK20)


# -------------------------------------------- the analysis' graphs (CPU)


def _stub_cache(size=2):
    """A GraphCache whose capture is a stand-in: it logs the capture and
    returns a replay that runs the function."""
    log = []

    def capture(fn, inputs):
        log.append(("capture", inputs[0]))

        def replay(*args):
            log.append(("replay", args[0]))
            return fn(*args)

        return replay

    return dualiso_analysis_dev.GraphCache("t.graph", size, capture), log


def test_graph_cache_eager_then_capture_then_replay():
    """A key runs eagerly, captures on its second call, then replays; a
    key of None (the CPU) always runs eagerly; the counters follow."""
    metrics.reset()
    cache, log = _stub_cache()
    fn = lambda x: x + 1  # noqa: E731
    assert [cache("k", fn, i) for i in (1, 2, 3)] == [2, 3, 4]
    assert log == [("capture", 2), ("replay", 2), ("replay", 3)]
    assert cache(None, fn, 7) == 8 and cache(None, fn, 7) == 8 and len(log) == 3
    assert cache.keys() == ["k"]
    c = metrics.counters()
    assert c["t.graph_captures"] == 1 and c["t.graph_replays"] == 2
    metrics.reset()


def test_graph_cache_tail_batch_second_key_and_eviction():
    """A tail batch's shape is a key of its own, eager on its one call; a
    second key captures on its own second call; past ``size`` keys the
    least recently used goes, and runs eagerly again when it comes back."""
    cache, log = _stub_cache(size=2)
    fn = lambda x: x * 2  # noqa: E731
    full, tail, other = ("cuda:0", (16, 1080, 1920)), ("cuda:0", (5, 1080, 1920)), ("cuda:0", (16, 1600, 3840))
    for x in (1, 2, 3):
        cache(full, fn, x)
    cache(tail, fn, 4)  # the take's last, short batch
    assert [e for e, _ in log] == ["capture", "replay", "replay"] and cache.keys() == [full, tail]
    cache(full, fn, 5)  # replays; tail is now the least recent
    cache(other, fn, 6)
    assert cache.keys() == [full, other]  # tail dropped
    cache(other, fn, 7)
    assert log[-2:] == [("capture", 7), ("replay", 7)]
    cache(tail, fn, 8)  # back, as new: eager; full, least recent, goes
    assert log[-1] == ("replay", 7) and cache.keys() == [other, tail]
    cache(full, fn, 9)
    assert log[-1] == ("replay", 7) and cache.keys() == [tail, full]


def test_capture_counts_launches_on_replay(monkeypatch):
    """The kernels that a capture records launch on each replay, not in the
    capture: the launch counters (the scoring kernel's, the EV kernels' and
    ``ev.launches``) stay put through the capture and grow by what it
    recorded at each replay. A stand-in graph on the CPU."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(dualiso_analysis_dev, "KERNEL_LAUNCHES", 5)
    monkeypatch.setattr(evmath, "KERNEL_LAUNCHES", 7)

    def fn(x):  # records one scoring launch and two EV launches
        dualiso_analysis_dev.KERNEL_LAUNCHES += 1
        evmath.KERNEL_LAUNCHES += 2
        metrics.count("ev.launches", 2)
        return (x + 1,)

    metrics.reset()
    replay = dualiso_analysis_dev._capture(fn, [torch.zeros(3)])
    assert (dualiso_analysis_dev.KERNEL_LAUNCHES, evmath.KERNEL_LAUNCHES) == (5, 7)
    assert metrics.counters().get("ev.launches", 0) == 0
    for k in (1, 2):
        (out,) = replay(torch.ones(3))
        assert (dualiso_analysis_dev.KERNEL_LAUNCHES, evmath.KERNEL_LAUNCHES) == (5 + k, 7 + 2 * k)
        assert metrics.counters()["ev.launches"] == 2 * k
    assert len(replays) == 2 and torch.equal(out, torch.ones(3))  # the capture's outputs: the stand-in computes none
    metrics.reset()


def test_analysis_key_off_the_card():
    """The CPU runs the analysis eagerly (no key), and ``--exact-luts``
    analyses on the host: analyze_batch is not called."""
    imgs = torch.zeros((2, 8, 8), dtype=torch.int16)
    assert dualiso_analysis_dev.analysis_key(imgs, 0, 8, BLACK) is None
    assert dualiso_analysis_dev.analysis_key(imgs.to("meta"), 1, 7, BLACK) is None


def test_exact_luts_never_analyses_on_the_device(tmp_path, monkeypatch):
    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    def refuse(*a, **k):
        raise AssertionError("the exact_luts mode analysed on the device")

    monkeypatch.setattr(dualiso_analysis_dev, "analyze_batch", refuse)
    src = str(tmp_path / "D.MLV")
    synth.write_mlv(src, width=256, height=192, frames=1, dual_iso=3)
    paths = convert_clip(src, str(tmp_path / "out"), ProcessingConfig(
        device="cpu", dual_iso=2, hdr_interpolation_method=1, exact_luts=True, use_sidecar_idx=False))
    assert len(paths) == 1


def test_analysis_through_the_cache_is_the_eager_analysis(monkeypatch):
    """analyze_batch through the cache (a stand-in capture, keys given on
    the CPU) returns the eager analysis' values on every call."""
    cache, log = _stub_cache(size=4)
    monkeypatch.setattr(dualiso_analysis_dev, "ANALYSIS_GRAPHS", cache)
    monkeypatch.setattr(dualiso_analysis_dev, "analysis_key", lambda imgs, *a: (tuple(imgs.shape), *a))
    spec = synth.SynthSpec(width=256, height=192, frames=2, dual_iso=3)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(np.stack([synth.make_frame_data(spec, rng) for _ in range(2)]).view(np.int16))
    is_hdr = torch.ones(2, dtype=torch.bool)
    want = dualiso_analysis_dev._analyze(frames, is_hdr, dualiso_analysis_dev.candidate_gains(frames.device),
                                         y_off=0, hh=192, black=BLACK)
    assert bool(want[0].all())  # both frames convert
    for _ in range(3):
        got = dualiso_analysis_dev.analyze_batch(frames, is_hdr, 0, 192, BLACK)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [e for e, _ in log] == ["capture", "replay", "replay"]


def test_reconstruction_is_enqueued_before_the_readback_wait(tmp_path, monkeypatch):
    """A clip's first converted batch waits for the analysis' readback (it
    fixes the clip's white level) before its reconstruction; every later
    batch enqueues its reconstruction first and then waits, so the device
    has work queued meanwhile. The DNGs are those of a convert without the
    order's record."""
    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    src = str(tmp_path / "D.MLV")
    synth.write_mlv(src, width=256, height=192, frames=6, dual_iso=3)
    cfg = ProcessingConfig(device="cpu", batch_size=2, dual_iso=2, hdr_interpolation_method=1,
                           use_sidecar_idx=False)
    plain = [open(p, "rb").read() for p in sorted(convert_clip(src, str(tmp_path / "a"), cfg))]
    order = []
    recon, sync = dualiso_full.reconstruct_batch, metrics.sync

    def recording_recon(*a, **k):
        order.append("recon")
        return recon(*a, **k)

    def recording_sync(what):
        order.append(what)
        return sync(what)

    monkeypatch.setattr(dualiso_full, "reconstruct_batch", recording_recon)
    monkeypatch.setattr(metrics, "sync", recording_sync)
    got = [open(p, "rb").read() for p in sorted(convert_clip(src, str(tmp_path / "b"), cfg))]
    assert got == plain
    assert [e for e in order if e in ("recon", "analysis")] == ["analysis", "recon"] + ["recon", "analysis"] * 2


# ------------------------------------------------------ the card (cuda)


def _card_planes(b, h, w, seed):
    """Random 20-bit bright/dark planes on the card (every range: below
    black, past the darkened white and past white), their row masks and
    per-frame scalars in the analysis' ranges."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    def floats(lo, hi, shape):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    dark = ints(0, 1 << 20, (b, h, w))
    bright = torch.where(ints(0, 8, (b, h, w)) == 0, ints(0, 1 << 20, (b, h, w)),
                         torch.clamp(dark * 8 - 7 * BLACK20, 0, (1 << 20) - 1))
    rb = ints(0, 2, (b, h)).bool()
    a = floats(0.1, 0.9, (b,))
    b20 = floats(-2000.0, 2000.0, (b,))
    wd = evmath.fma((WHITE20 - BLACK20) + b20, a, float(BLACK20)).to(torch.int32)
    return bright, dark, rb, a, b20, wd, floats(0.5, 4.0, (b,)), floats(0.5, 6.0, (b,))


CARD_SHAPES = [(16, 1080, 1920), (3, 37, 53), (2, 7, 1031)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w", CARD_SHAPES)
def test_kernels_match_their_twins_on_the_card(b, h, w):
    """Each stage's one launch gives its twin's bits on the card (the twin
    forced with the computed maps): match on a row slice of a batch (odd
    offset, strided frames), blend with and without the planes and either
    full-res, the alias planes of smoothed planes, the final blend with and
    without the alias map; 1080p with B=16 and odd shapes."""
    _need_card()
    maps = dualiso_recon.computed_maps(BLACK20, WHITE20)
    levels = dict(black20=BLACK20, white20=WHITE20)
    bright, dark, rb, a, b20, wd, ce, ov = _card_planes(b, h, w, seed=h * w)
    gen = torch.Generator(device="cuda").manual_seed(b)
    frames = torch.randint(-(1 << 15), 1 << 15, (b, h + 1, w), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int16)
    sub = frames[:, 1:]
    n = dualiso_recon.KERNEL_LAUNCHES

    def same(got, want, what):
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            assert len(got) == len(want), what
            for k, (g, x) in enumerate(zip(got, want)):
                same(g, x, f"{what}[{k}]")
            return
        if got is None or want is None:
            assert got is None and want is None, what
            return
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                           want.view(torch.int32) if want.dtype == torch.float32 else want), what

    same(dualiso_recon.match(sub, rb, a, b20, black20=BLACK20),
         dualiso_recon.match(sub, rb, a, b20, black20=BLACK20, maps=maps), "match")
    for use_fullres in (True, False):
        got = dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=use_fullres, planes=False,
                                  use_alias=True, **levels)
        want = dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=use_fullres, planes=False,
                                   use_alias=True, maps=maps, **levels)
        same(got, want, f"blend fullres={use_fullres}")
        for use_alias in (True, False):
            same(dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=use_fullres, planes=True,
                                     use_alias=use_alias, **levels),
                 dualiso_recon.blend(bright, dark, rb, wd, ce, ov, use_fullres=use_fullres, planes=True,
                                     use_alias=use_alias, maps=maps, **levels),
                 f"blend with planes fullres={use_fullres} alias={use_alias}")
    fullres, halfres, over, _ = want
    smooth_f, smooth_h = fullres ^ 5, torch.clamp(halfres + 77, max=(1 << 20) - 1)
    for fr in (fullres, None):
        for use_alias in (True, False):
            same(dualiso_recon.alias_planes(bright, smooth_f, smooth_h, fr, use_alias=use_alias, **levels),
                 dualiso_recon.alias_planes(bright, smooth_f, smooth_h, fr, use_alias=use_alias, maps=maps,
                                            **levels),
                 f"alias planes fullres={fr is not None} alias={use_alias}")
    f, hs_ev, fs_ev, f_ev, pre, skip = dualiso_recon.alias_planes(bright, smooth_f, smooth_h, fullres,
                                                                 use_alias=True, **levels)
    filtered = alias.alias_filter(pre, skip)
    for al, fe in ((filtered, f_ev), (None, fs_ev)):
        same(dualiso_recon.final(hs_ev, fs_ev, fe, f, al, over, dark, bright, **levels),
             dualiso_recon.final(hs_ev, fs_ev, fe, f, al, over, dark, bright, maps=maps, **levels),
             f"final alias={al is not None}")
    assert dualiso_recon.KERNEL_LAUNCHES == n + 1 + 6 + 4 + 1 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b, c, n", [(16, 3000, 4621), (3, 37, 0), (2, 300, 2049), (1, 3000, 5000)])
def test_fit_scores_kernel_matches_its_twin(b, c, n):
    """The exposure fit's scoring, one launch, counts as its twin on the
    card: 1080p's 16 frames x 3000 candidates x 4,621 pairs, no pairs,
    pairs past a shared-memory tile."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + c)
    hb = torch.randint(0, 60000, (b, n), generator=gen, device="cuda").to(torch.float32)
    hd = torch.trunc(hb * 0.125 + 300 + 40 * torch.randn((b, n), generator=gen, device="cuda"))
    valid = torch.rand((b, n), generator=gen, device="cuda") < 0.9
    hb, hd = torch.where(valid, hb, 0.0), torch.where(valid, hd, 0.0)
    a = dualiso_analysis_dev.candidate_gains(torch.device("cuda"))[:c].contiguous()
    bc = evmath.fma(-torch.rand((b, 1), generator=gen, device="cuda") * 1000, a[None, :],
                    torch.full((b, 1), 300.0, device="cuda"))
    before = dualiso_analysis_dev.KERNEL_LAUNCHES
    got = dualiso_analysis_dev.fit_scores(hb, hd, valid, a, bc)
    assert dualiso_analysis_dev.KERNEL_LAUNCHES == before + 1
    want = dualiso_analysis_dev.fit_scores_plain(hb, hd, valid, a, bc)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    if n and c == 3000:
        assert int(want.max()) > n // 4  # the gain 2**-3 fits many pairs


def _card_frames(b, seed, h=1080, w=1920):
    """Interlaced 14-bit 3-EV frames (B, H, W) int16 on the card, a scene
    with noise and the bright rows from phase 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    scene = 0.45 * x / w + 0.35 * y / h + 0.2 * (0.5 + 0.5 * torch.sin(x / 7.3) * torch.cos(y / 5.1))
    data = BLACK + scene * (WHITE - BLACK) / 8 + 8 * torch.randn((b, h, w), generator=gen, device="cuda")
    bright = (torch.arange(h, device="cuda") % 4 >= 2)[None, :, None]
    data = torch.where(bright, BLACK + (data - BLACK) * 8, data)
    return torch.clamp(data, 0, 16383).to(torch.int32).to(torch.int16)


@pytest.mark.cuda
def test_analysis_replay_matches_eager_on_the_card():
    """The replayed analysis equals the eager one over consecutive batches
    of other data (stale inputs would show), and a batch's outputs read
    back intact after the next batch's replay. The candidate gains' cache
    is cleared and their memory reused between replays: the graph reads its
    own copy. Each replay counts the scoring kernel's launch; the capture
    counts none."""
    _need_card()
    cache = dualiso_analysis_dev.GraphCache("test.analysis", 4)
    fn = dualiso_analysis_dev.functools.partial(dualiso_analysis_dev._analyze, y_off=0, hh=1080, black=BLACK)
    key = ("test", 16)
    batches = [_card_frames(16, seed) for seed in (1, 2, 3, 4)]
    is_hdr = torch.ones(16, dtype=torch.bool, device="cuda")
    gains = dualiso_analysis_dev.candidate_gains(torch.device("cuda"))
    n_gains = gains.shape[0]
    before = dualiso_analysis_dev.KERNEL_LAUNCHES
    outs = []
    for f in batches:  # eager, capture + replay, replay, replay
        outs.append(cache(key, fn, f, is_hdr, dualiso_analysis_dev.candidate_gains(torch.device("cuda"))))
        del gains
        dualiso_analysis_dev.candidate_gains.cache_clear()
        gains = torch.full((n_gains,), 1e30, device="cuda")  # likely where the gains were
    assert dualiso_analysis_dev.KERNEL_LAUNCHES == before + 4
    torch.cuda.synchronize()
    a_cand = dualiso_analysis_dev.candidate_gains(torch.device("cuda"))
    for f, got in zip(batches, outs):
        want = fn(f, is_hdr, a_cand)
        assert bool(want[0].all())
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not torch.equal(outs[1][3], outs[2][3])  # the batches' fits differ


@pytest.mark.cuda
def test_captured_spans_record_no_device_events():
    """With tracing on, a device span opened while the stream captures
    records no event (which the capture would refuse) and keeps its host
    times; the graph replays right."""
    _need_card()
    metrics.reset()
    metrics.enable(device=True)
    try:
        x = torch.rand((4, 64, 64), device="cuda") + 0.5
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with metrics.span("captured", metrics.DEVICE):
                y = evmath.log2_f32(x)
        spans = metrics.spans()
        assert sorted(s.name for s in spans) == ["captured", "ev"]
        assert all(s.device_ms is None and s.host_ms >= 0 for s in spans)
        x.copy_(torch.rand((4, 64, 64), device="cuda") + 2.0)
        graph.replay()
        want = evmath.log2_f32(x)  # eagerly, its span timed on the card
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert [s.device_ms is not None for s in metrics.spans()[2:]] == [True]
    finally:
        metrics.disable()
        metrics.reset()


@pytest.mark.cuda
def test_dual_iso_convert_runs_the_kernels_and_replays(tmp_path):
    """A card conversion of two takes: the stages launch 3 kernels a batch
    (recon.fused_launches), the analysis captures once, on the first take's
    second batch, and replays every later batch."""
    _need_card()
    from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
    from mlvfs_tpu_torch.pipeline.convert import convert_clip

    src = str(tmp_path / "D.MLV")
    synth.write_mlv(src, width=640, height=192, frames=12, dual_iso=3)
    dualiso_analysis_dev.ANALYSIS_GRAPHS.clear()
    metrics.reset()
    scored = dualiso_analysis_dev.KERNEL_LAUNCHES
    for k in range(2):
        convert_clip(src, str(tmp_path / f"out{k}"), ProcessingConfig(
            device="cuda", batch_size=4, dual_iso=2, hdr_interpolation_method=1, use_sidecar_idx=False))
    c = metrics.counters()
    assert c["dualiso.analysis_captures"] == 1 and c["dualiso.analysis_replays"] == 5
    assert c["recon.fused_launches"] == 3 * 6
    assert dualiso_analysis_dev.KERNEL_LAUNCHES - scored == 6  # the fit's scoring: one a batch
    for k in range(12):
        name = sorted(os.listdir(tmp_path / "out0"))[k]
        assert (tmp_path / "out0" / name).read_bytes() == (tmp_path / "out1" / name).read_bytes()
    metrics.reset()
