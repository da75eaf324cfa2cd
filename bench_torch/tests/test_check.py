"""The benchmark's check, at a size a CPU test run holds: the control fails
it, and a run with the timed path broken underneath reads ``correct``
false. Run with ``python -m pytest bench_torch/tests``; no card needed
(the program runs its plain CPU path, the harness's look for a chip is
skipped)."""

import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import control  # noqa: E402
import harness  # noqa: E402

SIZE = (256, 192)
FRAMES = 32
CELLS = ["plain-default", "plain-flags-on", "dualiso-amaze", "dualiso-mean23"]
# windows long enough for the CPU to finish batches of every cell at SIZE
SECONDS = {"plain-default": 1.0, "plain-flags-on": 1.0, "dualiso-amaze": 8.0, "dualiso-mean23": 4.0}


def run(cell, tmp_path, seed=2**31 + 11):
    return harness.run_cell(cell, seed, SECONDS[cell], False, t_start=time.perf_counter(), device="cpu",
                            workdir=str(tmp_path / "wd"), size=SIZE, take_frames=FRAMES,
                            require_chip=False, log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    result = run(cell, tmp_path)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    readings = control.control_readings(cell, 2**31 + 12, "cpu", size=SIZE, take_frames=FRAMES)
    limits = harness.catalog.cell(cell)["limits"]
    assert any(readings[k] > limits[k] for k in limits), readings


def _patched(monkeypatch, fault):
    from mlvfs_tpu_torch.pipeline import convert, kernels

    if fault == "answer altered":
        write = convert.ClipConverter._write_dng

        def altered(path, header, img):
            if path.endswith("_000005.dng"):
                img = np.array(img, copy=True)
                img.reshape(-1)[1234] ^= 1
            return write(path, header, img)

        monkeypatch.setattr(convert.ClipConverter, "_write_dng", staticmethod(altered))
    elif fault == "half the batch left out":
        finish = convert.ClipConverter._finish_batch

        def half(self, outdir, basename, indices, imgs, info, computed):
            keep = len(indices) // 2
            return finish(self, outdir, basename, indices[:keep], imgs, info, computed)

        monkeypatch.setattr(convert.ClipConverter, "_finish_batch", half)
    elif fault == "state unchanged":
        monkeypatch.setattr(kernels, "run_pipeline", lambda imgs, fh, cfg, cal, info: (imgs, info))


FAULTS = [("plain-default", "answer altered"), ("plain-default", "half the batch left out"),
          ("plain-flags-on", "answer altered"), ("plain-flags-on", "half the batch left out"),
          ("plain-flags-on", "state unchanged"), ("dualiso-mean23", "answer altered"),
          ("dualiso-mean23", "half the batch left out"), ("dualiso-mean23", "state unchanged"),
          ("dualiso-amaze", "state unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    _patched(monkeypatch, fault)
    result = run(cell, tmp_path)
    assert not result["correct"], (fault, result["check"])
    assert result["failed"] > 0
