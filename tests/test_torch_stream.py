"""The port's host feed: prefetch ring, staging buffers, profiler hook (CPU)."""

import os
import sys
import threading

import pytest

from mlvfs_tpu.format import synth
from mlvfs_tpu.format.reader import MLVClip
from mlvfs_tpu_torch import cli
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import ClipConverter
from mlvfs_tpu_torch.pipeline.stream import BatchPrefetcher


@pytest.mark.parametrize("depth", [1, 2, 3, 7])
def test_prefetcher_yields_in_order(depth):
    batches = [[0, 1], [2, 3], [4], [5, 6], [7]]
    out = list(BatchPrefetcher(lambda idx: [2 * i for i in idx], batches, depth=depth))
    assert out == [(b, [2 * i for i in b]) for b in batches]


def test_prefetcher_raises_fetch_errors():
    def fetch(idx):
        if idx == [2]:
            raise OSError("bad read")
        return idx

    it = iter(BatchPrefetcher(fetch, [[0], [1], [2], [3]], depth=2))
    assert next(it) == ([0], [0])
    assert next(it) == ([1], [1])
    with pytest.raises(OSError, match="bad read"):
        next(it)


def test_staging_ring_concurrent_distinct(tmp_path):
    """Concurrent fetches never share a staging buffer, and the ring reuses
    its buffers (prefetch + 1 of them) instead of growing. More threads than
    cores, with a short switch interval, to shake out a racy turn."""
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=2)
    n_threads = max(8, (os.cpu_count() or 1) + 2)
    cfg = ProcessingConfig(device="cpu", prefetch=n_threads)
    rounds = 40
    ids = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads, timeout=30)
    old = sys.getswitchinterval()
    with MLVClip(src) as clip:
        conv = ClipConverter(clip, cfg)
        sys.setswitchinterval(1e-6)
        try:
            def worker(slot):
                for _ in range(rounds):
                    barrier.wait()
                    ids[slot].append(id(conv._staging((2, 128))[0]))
                    barrier.wait()

            threads = [threading.Thread(target=worker, args=(s,)) for s in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
            conv.close()
    for r in range(rounds):
        held = [ids[s][r] for s in range(n_threads)]
        assert len(set(held)) == n_threads, f"round {r}: shared buffer"
    assert len(conv._buf_ring) == cfg.prefetch + 1


def test_profile_env_writes_a_trace(tmp_path, monkeypatch):
    """MLVFS_TPU_PROFILE=<dir> records the CLI conversion with torch.profiler."""
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=2)
    prof = tmp_path / "prof"
    monkeypatch.setenv("MLVFS_TPU_PROFILE", str(prof))
    assert cli.main(["convert", src, "-o", str(tmp_path / "out"), "--device", "cpu"]) == 0
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].startswith("convert.") and traces[0].endswith(".json")
