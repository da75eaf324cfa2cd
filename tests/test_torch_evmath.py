"""The EV transforms' dispatch on the CPU (``ops/evmath.py``): each public
entry runs its plain twin on CPU tensors, the twins equal XLA's float32
arithmetic (the reference's), the kernel's operand planner classifies and
refuses as ``csrc/evmath.cu`` needs, every call the convert paths make can
be planned, and ``csrc/evmath.cuh`` holds the twins' constants. The kernel
itself is held against the twins on the card in tests/test_torch_kernels.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvfs_tpu_torch import _build
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.ops import dualiso_analysis_dev, dualiso_full, dualiso_preview_dev, evmath, stripes
from mlvfs_tpu_torch.ops.dualiso_full import white_ev_of
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip
from mlvfs_tpu_torch.utils import metrics

BLACK20 = 2048 * 64
EVR = 32768


def _floats(step=4099):
    """Every ``step``-th float32 bit pattern, both signs, with the specials."""
    bits = np.arange(0, 1 << 32, step, dtype=np.int64)
    xs = ((bits + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32).view(np.float32)
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 1e-40, 2.0 ** -126, 1.0, 2.0, 88.8,
                     -104.0, 127.9, 128.0], np.float32)
    return np.concatenate([xs, spec])


def _entries():
    """(name, args) of each public entry on CPU tensors."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 5, 7), dtype=np.float32) * 100)
    raw = torch.from_numpy(rng.integers(0, 1 << 20, (2, 5, 7), dtype=np.int32))
    ev = torch.from_numpy(rng.integers(-10 * EVR, 14 * EVR, (2, 5, 7), dtype=np.int32))
    return {
        "fma": (x, torch.from_numpy(rng.random((2, 1, 1), dtype=np.float32)), 0.5),
        "log_f32": (x,),
        "log2_f32": (x,),
        "log2_add": (x, -4.0),
        "exp2_f32": (x - 50,),
        "raw2ev20": (raw, BLACK20),
        "ev2raw20": (ev, BLACK20, 640000, white_ev_of(BLACK20, 640000)),
        "fullres_weight": (raw, BLACK20),
    }


@pytest.mark.parametrize("name", list(_entries()))
def test_public_entry_runs_its_twin_on_the_cpu(name):
    """On CPU tensors the public entry is its twin, bit for bit, and launches
    nothing: KERNEL_LAUNCHES and the ``ev.launches`` counter stay put."""
    args = _entries()[name]
    before, counted = evmath.KERNEL_LAUNCHES, metrics.counters().get("ev.launches", 0)
    got = getattr(evmath, name)(*args)
    want = getattr(evmath, name + "_plain")(*args)
    assert got.dtype == want.dtype and got.device.type == "cpu"
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert evmath.KERNEL_LAUNCHES == before
    assert metrics.counters().get("ev.launches", 0) == counted


def test_public_entry_refuses_another_device():
    with pytest.raises(ValueError, match="unsupported device"):
        evmath.log2_f32(torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="more than one device"):
        evmath.fma(torch.ones(4), torch.ones(4, device="meta"), 1.0)


def _xla_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    return np.array_equal(np.isnan(got), nan) and np.array_equal(got[~nan].view(np.int32),
                                                                  want[~nan].view(np.int32))


@pytest.mark.parametrize("name", ["log_f32", "log2_f32", "log2_add", "exp_f32", "exp2_f32"])
def test_twins_equal_xla(name):
    """The twins (what the kernel computes) equal XLA's float32 log, log2,
    log2(x) + c, exp and exp2 on the CPU bit for bit over their domains:
    normal, zero, infinite, negative and NaN inputs for the logs (a
    subnormal input is cut off at the smallest normal), [-87, 88] for exp
    and [-125, 127] for exp2 (2^n a normal float)."""
    xs = _floats()
    c = np.float32(-3.5)
    if name.startswith("log"):
        xs = xs[(np.abs(xs) >= np.float32(2.0 ** -126)) | (xs == 0) | np.isnan(xs)]
    else:
        lo, hi = (-87, 88) if name == "exp_f32" else (-125, 127)
        xs = xs[(xs >= lo) & (xs <= hi)]
    ref = {"log_f32": jnp.log, "log2_f32": jnp.log2, "log2_add": lambda x: jnp.log2(x) + c,
           "exp_f32": jnp.exp, "exp2_f32": jnp.exp2}[name]
    args = (float(c),) if name == "log2_add" else ()
    got = getattr(evmath, name + "_plain")(torch.from_numpy(xs), *args).numpy()
    assert _xla_equal(got, jax.jit(ref)(xs))


def test_twins_of_the_20_bit_transforms_equal_the_reference():
    """raw2ev20 and ev2raw20's twins equal the reference's transforms on
    every 20-bit input and every EV of the table's range, at the cell's
    black and one off the 64-grid; zero_ev is raw2ev20(0)."""
    from mlvfs_tpu.ops import evmath as ref_evmath

    raw = np.arange(0, 1 << 20, dtype=np.int32)
    ev = np.arange(-10 * EVR, 14 * EVR, dtype=np.int32)
    for black20 in (BLACK20, 2047 * 64 + 17):
        np.testing.assert_array_equal(evmath.raw2ev20_plain(torch.from_numpy(raw), black20).numpy(),
                                      np.asarray(ref_evmath.raw2ev20(jnp.asarray(raw), black20)))
        assert evmath.zero_ev(black20) == int(ref_evmath.raw2ev20(jnp.zeros(1, jnp.int32), black20)[0])
    white_ev = white_ev_of(BLACK20, 15000 * 64)
    np.testing.assert_array_equal(
        evmath.ev2raw20_plain(torch.from_numpy(ev), BLACK20, 15000 * 64, white_ev).numpy(),
        np.asarray(ref_evmath.ev2raw20(jnp.asarray(ev), BLACK20, 15000 * 64, white_ev)))


# ------------------------------------------------------ the operand planner


def _kinds(plan):
    return [(op.kind, op.strides) for op in plan[2]]


def test_planner_classifies_full_strided_and_value_operands():
    """A tensor of the result's shape is a full plane, a per-frame (B, 1, 1)
    vector strided (stride 0 over a frame's pixels, the frame's pixels one
    merged dimension), a Python number or a 0-dim host tensor a float32
    value; dimensions every operand walks as one are merged."""
    b, h, w = 3, 4, 5
    full = torch.zeros(b, h, w)
    frame = torch.zeros(b, 1, 1)
    shape, dims, ops = evmath.plan_operands((full, frame, 0.1))
    assert shape == (b, h, w) and dims == (1, b, h * w)
    assert _kinds((shape, dims, ops)) == [(evmath.FULL, (0, h * w, 1)), (evmath.STRIDED, (0, 1, 0)),
                                          (evmath.VALUE, (0, 0, 0))]
    assert ops[2].value == float(np.float32(0.1)) and ops[2].tensor is None
    assert ops[0].tensor is full and ops[1].tensor is frame
    shape, dims, ops = evmath.plan_operands((torch.tensor(2.5), full, torch.tensor(-1.0)))
    assert [op.kind for op in ops] == [evmath.VALUE, evmath.FULL, evmath.VALUE]
    assert (ops[0].value, ops[2].value, dims) == (2.5, -1.0, (1, 1, b * h * w))
    shape, dims, ops = evmath.plan_operands((full, full, full))
    assert dims == (1, 1, b * h * w) and {op.kind for op in ops} == {evmath.FULL}


def test_planner_takes_the_analysis_broadcasts():
    """dualiso_analysis_dev's (B, 1) x (1, S) + (B, 1) and (1, N) x (S, 1) +
    (S, 1) products: every operand strided over the (B, S) / (S, N) result."""
    bsz, steps, n = 4, 3000, 7
    col, row = torch.zeros(bsz)[:, None], torch.zeros(steps)[None, :]
    shape, dims, ops = evmath.plan_operands((col, row, col))
    assert shape == (bsz, steps) and dims == (1, bsz, steps)
    assert _kinds((shape, dims, ops)) == [(evmath.STRIDED, (0, 1, 0)), (evmath.STRIDED, (0, 0, 1)),
                                          (evmath.STRIDED, (0, 1, 0))]
    hb, bc = torch.zeros(bsz, n), torch.zeros(bsz, steps)
    shape, dims, ops = evmath.plan_operands((hb[1][None, :], torch.zeros(steps)[:, None], bc[1][:, None]))
    assert shape == (steps, n) and dims == (1, steps, n)
    assert [op.strides for op in ops] == [(0, 0, 1), (0, 1, 0), (0, 1, 0)]
    assert ops[2].tensor.data_ptr() == bc[1].data_ptr()


@pytest.mark.parametrize("case", ["float64", "int32", "non-contiguous", "two devices", "no broadcast",
                                  "four dimensions", "too many elements", "not a number"])
def test_planner_refuses(case):
    """What the kernel does not take raises, before any launch: another dtype
    (TypeError), a full plane that is not contiguous, tensors on two
    devices, shapes that do not broadcast, strides that leave more than
    three dimensions, more than 2**31 - 1 elements (ValueError), an operand
    that is not a number or a tensor (TypeError)."""
    full = torch.zeros(2, 3, 4)
    operands, error = {
        "float64": ((full.double(), 1.0, 1.0), TypeError),
        "int32": ((full, torch.tensor(2, dtype=torch.int32), 1.0), TypeError),
        "non-contiguous": ((torch.zeros(4, 3, 2).transpose(0, 2), full, 1.0), ValueError),
        "two devices": ((full, torch.zeros(2, 3, 4, device="meta"), 1.0), ValueError),
        "no broadcast": ((full, torch.zeros(3, 3, 4), 1.0), ValueError),
        "four dimensions": ((torch.zeros(2, 3, 4, 5), torch.zeros(2, 1, 4, 1), 1.0), ValueError),
        "too many elements": ((torch.zeros(1).expand(1 << 31), 1.0, 1.0), ValueError),
        "not a number": ((full, "2", 1.0), TypeError),
    }[case]
    with pytest.raises(error):
        evmath.plan_operands(operands)


def test_unary_and_log2_add_planners_refuse():
    """A unary transform takes a contiguous tensor of its dtype; log2_add's x
    has the result's shape. The planners build each entry's C arguments."""
    x = torch.zeros(2, 3, 4)
    with pytest.raises(TypeError):
        evmath._plan_log2_f32(x.double())
    with pytest.raises(TypeError):
        evmath._plan_raw2ev20(x, BLACK20)  # float32, not int32
    with pytest.raises(ValueError):
        evmath._plan_log2_f32(x.transpose(1, 2))
    with pytest.raises(ValueError):
        evmath._plan_log2_add(x[:, :1], x)
    ev = x.int()
    entry, shape, dtype, cargs = evmath._plan_ev2raw20(ev, BLACK20, 640000, 20)
    assert (entry, shape, dtype) == ("mlvfs_ev_ev2raw20", (2, 3, 4), torch.int32)
    assert cargs == (24, ev.data_ptr(), BLACK20, 640000, 20, evmath.zero_ev(BLACK20))
    entry, shape, dtype, cargs = evmath._plan_fma(x, x[:, :1, :1].contiguous(), 2.0)
    assert entry == "mlvfs_ev_fma" and len(cargs) + 2 == len(_build._SIGNATURES["evmath"][entry][1])
    entry, shape, dtype, cargs = evmath._plan_log2_add(x, -4.0)
    assert len(cargs) + 2 == len(_build._SIGNATURES["evmath"][entry][1])


# ------------------------------------------- every caller's calls can be planned


def test_convert_paths_calls_plan(tmp_path, monkeypatch):
    """Every public EV call that --dual-iso (amaze-edge and mean23, hdr_check
    and the analysis included), the preview's device fit and
    --stripes-batch-cal make on a CPU batch is one the kernel takes: the
    dispatcher plans each call before running its twin."""
    planned = {}

    def plan_then_twin(plain, planner, *args):
        entry = planner(*args)[0]
        planned[entry] = planned.get(entry, 0) + 1
        return plain(*args)

    monkeypatch.setattr(evmath, "_dispatch", plan_then_twin)
    # computed once per levels or device: here, not by an earlier test in this process
    dualiso_full._max_ev.cache_clear()
    dualiso_analysis_dev.candidate_gains.cache_clear()
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=256, height=192, frames=2, dual_iso=3)
    for flags in ({}, {"hdr_interpolation_method": 1}):
        convert_clip(src, str(tmp_path / f"out{len(flags)}"), ProcessingConfig(
            device="cpu", batch_size=2, dual_iso=2, use_sidecar_idx=False, **flags))
    assert {"mlvfs_ev_fma", "mlvfs_ev_log_f32", "mlvfs_ev_log2_f32", "mlvfs_ev_log2_add",
            "mlvfs_ev_exp2_f32", "mlvfs_ev_raw2ev20", "mlvfs_ev_ev2raw20",
            "mlvfs_ev_fullres_weight"} <= set(planned)
    spec = synth.SynthSpec(width=256, height=192, frames=2, dual_iso=3)
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(np.stack([synth.make_frame_data(spec, rng) for _ in range(2)]).view(np.int16))
    before = planned["mlvfs_ev_fma"]
    dualiso_preview_dev.preview_fit_device_plain(imgs, spec.black, spec.white)
    stripes.calibrate_batch_device(imgs, spec.black, spec.white, 256 * 192 * 14 // 8)
    assert planned["mlvfs_ev_fma"] > before


# ------------------------------------------------------------ csrc/evmath.cuh


def test_header_constants_are_the_twins():
    """The float32 constants of csrc/evmath.cuh, exact hex literals, equal
    the twin's."""
    with open(os.path.join(_build.SRC_DIR, "evmath.cuh")) as f:
        found = dict(re.findall(r"constexpr float (\w+) = ([-+.\w]+)f;", f.read()))
    got = {k: float.fromhex(v) if "0x" in v else float(v) for k, v in found.items()}
    want = {"INV_LN2": evmath.INV_LN2, "LN2": evmath.LN2, "EV_RESOLUTION": float(evmath.EV_RESOLUTION),
            "SQRTHF": evmath._SQRTHF, "LOG_Q1": evmath._LOG_Q1, "LOG_Q2": evmath._LOG_Q2,
            "LOG2EF": evmath._LOG2EF, "EXP_C1": evmath._EXP_C1, "EXP_C2": evmath._EXP_C2,
            "EXP_LO": -104.0, "EXP_HI": float(np.float32(88.8)), "MIN_NORM": evmath._MIN_NORM,
            "PI_4": float(np.float32(np.pi / 4)),
            **{f"LOG_P{i}": v for i, v in enumerate(evmath._LOG_P)},
            **{f"EXP_P{i}": v for i, v in enumerate(evmath._EXP_P)}}
    assert got == want
    assert "-fmad=false" in _build.flags("evmath") and _build.sources("evmath") == ["evmath.cu", "evmath.cuh"]
