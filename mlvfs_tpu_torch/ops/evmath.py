"""Computed 20-bit EV transforms in float32 torch, the default (non-exact)
form of the full dual-ISO reconstruction's raw↔EV maps.

Counterpart of ``mlvfs_tpu/ops/evmath.py``: the reference's 20-bit tables
(build_ev2raw_lut, hdr.c:839-874) and fullres curve (hdr.c:890-913) are
log2/exp2/cos curves, computed per pixel in float32 instead of gathered from
4 MB tables. The reference's gate for these is PSNR, not bit equality.

The float32 operations are the ones XLA on the CPU runs for the reference:
``log2(x)`` is ``log(x) * f32(1/ln 2)``, ``exp2(x)`` is ``exp(x * f32(ln 2))``,
a product that feeds an add is one fused multiply-add, and ``log`` and
``exp`` are XLA's Cephes polynomials (:func:`log_f32_plain`, :func:`exp_f32_plain`),
reproduced operation for operation with exact fused multiply-adds
(:func:`~.dualiso.fma_f32`). Each step is an IEEE float32 operation or an
exact emulation of one, so the CPU and the card give the same values.
``cos`` is taken in float64 and rounded once; XLA's float32 cos differs
from that in about 1 % of inputs, which the PSNR gate covers.

Each transform but ``cos_f32`` has a plain twin ``<name>_plain``, in torch
on any device; a twin calls only twins. The public ``<name>`` runs the twin
on CPU tensors and launches ``csrc/evmath.cu`` on CUDA tensors, or raises:
it never falls back from one to the other (``exp_f32_plain`` has no public
form: no caller takes exp but through ``exp2_f32``). The kernel computes the
same float32 operations with native fused multiply-adds (``__fmaf_rn``), so
it gives the twin's bits. An operand of :func:`fma` and :func:`log2_add`
reaches the kernel as a full plane, a strided view that broadcasts to the
result, or a value (:func:`plan_operands`).
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..utils import metrics
from .dualiso import fma_f32
from .luts import EV_RESOLUTION

# Launches of csrc/evmath.cu by the transforms below, for showing that a run
# went through the kernel (also counted as ``ev.launches`` in utils.metrics).
# Only _launch adds to it, once per launch.
KERNEL_LAUNCHES = 0

# every transform below is one ``ev`` span, the outermost call only
_ev = metrics.traced("ev", metrics.DEVICE, outermost=True)

INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))  # XLA's folded 1/log(2)
LN2 = float(np.float32(math.log(2.0)))

# Cephes float32 constants, as XLA's CPU backend uses them
_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = [float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_LOG2EF = float(np.float32(1.44269504088896341))
_EXP_C1 = float(np.float32(0.693359375))
_EXP_C2 = float(np.float32(-2.12194440e-4))
_EXP_P = [float(np.float32(v)) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
    5.0000001201e-1)]
_MIN_NORM = float(np.frombuffer(np.uint32(0x00800000).tobytes(), np.float32)[0])


def fma_plain(x, y, z) -> torch.Tensor:
    """x * y + z rounded once to float32, broadcasting; any operand may be a
    Python float (taken as float32, and kept a 0-dim host tensor, so a call on
    CUDA tensors copies nothing to the card and never synchronises)."""
    return fma_f32(*(t.to(torch.float32) if isinstance(t, torch.Tensor) else
                     torch.tensor(t, dtype=torch.float32) for t in (x, y, z)))


def log_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, bit for bit as XLA's CPU backend
    computes it: x = m * 2^e with m in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial in m - 1, and e * ln 2 added in two parts."""
    xc = torch.clamp(x, min=_MIN_NORM)  # cut off subnormals
    bits = xc.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma_plain(t, p[0], p[1])
    y1 = fma_plain(t, p[3], p[4])
    y2 = fma_plain(t, p[6], p[7])
    y = fma_plain(y, t, p[2])
    y1 = fma_plain(y1, t, p[5])
    y2 = fma_plain(y2, t, p[8])
    y = fma_plain(y, x3, y1)
    y = fma_plain(y, x3, y2)
    y = fma_plain(y, x3, _LOG_Q1 * e)
    t = fma_plain(-0.5, x2, t) + y
    out = fma_plain(_LOG_Q2, e, t)
    out = torch.where(torch.isinf(x), x, torch.where(x == 0, -torch.inf, out))
    return torch.where((x < 0) | torch.isnan(x), torch.nan, out)


def exp_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, bit for bit as XLA's CPU backend computes it
    for x in about [-87, 88] (2^n a normal float): n = floor(x / ln 2 + 1/2),
    r = x - n ln 2 in two parts, a degree-5 polynomial in r, times 2^n."""
    xc = torch.clamp(x, -104.0, 88.8)
    n = torch.floor(fma_plain(xc, _LOG2EF, 0.5))
    r = fma_plain(-_EXP_C1, n, xc)
    r = fma_plain(-_EXP_C2, n, r)
    z = r * r
    p = _EXP_P
    y = fma_plain(r, p[0], p[1])
    for c in p[2:]:
        y = fma_plain(y, r, c)
    y = 1.0 + fma_plain(y, z, r)
    scale = ((n.to(torch.int32).clamp(-126, 127) + 127) << 23).view(torch.float32)  # 2^n
    return y * scale


@_ev
def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor, taken in float64 and rounded once."""
    return torch.cos(x.double()).float()


def log2_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA lowers it: log(x) * f32(1/ln 2), two roundings."""
    return log_f32_plain(x) * INV_LN2


def log2_add_plain(x: torch.Tensor, c) -> torch.Tensor:
    """jnp.log2(x) + c, the multiply contracted into the add (as XLA does);
    ``c`` a float or a float32 tensor that broadcasts to ``x``."""
    return fma_plain(log_f32_plain(x), INV_LN2, c)


def exp2_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """jnp.exp2 as XLA lowers it: exp(x * f32(ln 2))."""
    return exp_f32_plain(x * LN2)


def raw2ev20_plain(i: torch.Tensor, black20: int) -> torch.Tensor:
    """round(log2(1 + |i/64 - black/64|) * EVR) * sign (hdr.c:843-850), int32."""
    signal = torch.clamp(i.to(torch.float32) / 64.0 - black20 / 64.0, min=-1023.0)
    mag = torch.round(log2_f32_plain(1.0 + signal.abs()) * EV_RESOLUTION)
    return torch.where(signal > 0, mag, -mag).to(torch.int32)


def ev2raw20_plain(ev: torch.Tensor, black20: int, white20: int, white_ev: int) -> torch.Tensor:
    """Inverse transform with the black offset and the white clamp
    (hdr.c:852-865), int32. ``white_ev`` is raw2ev(white20), a host scalar."""
    evf = ev.to(torch.float32)
    pos = torch.clamp(black20 - 64.0 + torch.round(64.0 * exp2_f32_plain(evf / EV_RESOLUTION)),
                      float(black20), float((1 << 20) - 1))
    pos = torch.where(ev >= white_ev, torch.clamp(pos, min=float(white20)), pos)
    neg = torch.clamp(black20 + 64.0 - torch.round(64.0 * exp2_f32_plain(-evf / EV_RESOLUTION)),
                      0.0, float(black20))
    out = torch.where(ev < 0, neg, pos)
    # table quirk: ev2raw[raw2ev[0]] = 0 keeps fully-dead pixels (hdr.c:868)
    zero_ev = int(raw2ev20_plain(torch.zeros(1, dtype=torch.int32), black20)[0])
    out = torch.where(ev == zero_ev, 0.0, out)
    return out.to(torch.int32)


def fullres_weight_plain(i: torch.Tensor, black20: int) -> torch.Tensor:
    """Fullres mixing curve (build_fullres_curve, hdr.c:890-913), float32."""
    fullres_start, fullres_transition = 4.0, 4.0
    x = torch.clamp(i.to(torch.float32) / 64.0 - black20 / 64.0, min=1.0)
    ev2 = log2_add_plain(x, -fullres_start)  # log2(x) - 4, contracted
    c2 = -cos_f32(torch.clamp(ev2, 0.0, fullres_transition)
                  * float(np.float32(math.pi / fullres_transition)))
    return (c2 + 1.0) * 0.5


# ------------------------------------------------- the kernel's operands

VALUE, FULL, STRIDED = 0, 1, 2  # the operand kinds csrc/evmath.cu takes
MAX_ELEMENTS = (1 << 31) - 1  # the kernel's indices are 32-bit


class Operand(NamedTuple):
    """One operand as the kernel takes it: a value, a full plane, or a strided
    view with its element strides over the plan's three dimensions."""
    kind: int
    tensor: Optional[torch.Tensor]
    value: float
    strides: tuple


def _is_host_scalar(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dim() == 0 and t.device.type == "cpu"


def _call_device(*operands) -> torch.device:
    """The device a call runs on: that of its tensors, a 0-dim host tensor
    being a value (the CPU when there is nothing else)."""
    devices = {t.device for t in operands if isinstance(t, torch.Tensor) and not _is_host_scalar(t)}
    if len(devices) > 1:
        raise ValueError(f"evmath: operands on more than one device: {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


def _merge_dims(dims, strides):
    """Drop the size-1 dimensions and merge each pair of neighbours that every
    stride list walks as one; at most three are left, padded in front."""
    keep = [k for k, d in enumerate(dims) if d != 1]
    dims = [dims[k] for k in keep]
    strides = [[s[k] for k in keep] for s in strides]
    out_dims, out_strides = [], [[] for _ in strides]
    for k, d in enumerate(dims):
        if out_dims and all(o[-1] == s[k] * d for o, s in zip(out_strides, strides)):
            out_dims[-1] *= d
            for o, s in zip(out_strides, strides):
                o[-1] = s[k]
        else:
            out_dims.append(d)
            for o, s in zip(out_strides, strides):
                o.append(s[k])
    if len(out_dims) > 3:
        raise ValueError(f"evmath: the operands' strides leave {len(out_dims)} dimensions, the kernel "
                         "takes at most 3")
    pad = 3 - len(out_dims)
    return (1,) * pad + tuple(out_dims), [(0,) * pad + tuple(o) for o in out_strides]


def _broadcast_shape(shapes) -> tuple:
    """The shape ``shapes`` broadcast to (torch.broadcast_shapes, whose first
    call imports torch.fx's symbolic shapes: seconds of set-up)."""
    out = [1] * max((len(s) for s in shapes), default=0)
    for s in shapes:
        for k, d in enumerate(s, len(out) - len(s)):
            if d != 1:
                if out[k] not in (1, d):
                    raise ValueError(f"evmath: operand shapes do not broadcast: {shapes}")
                out[k] = d
    return tuple(out)


def plan_operands(operands):
    """How the kernel takes ``operands`` (each a Python number, a 0-dim host
    tensor, or a float32 tensor on the call's device): (the result's shape,
    its dimensions merged into three, one :class:`Operand` each).

    A number or a 0-dim host tensor is a VALUE (float32). A tensor of the
    result's shape is a FULL plane and must be contiguous. A tensor that
    broadcasts to it is STRIDED: its broadcast strides, which give a
    per-frame (B, 1, 1) vector stride 0 over each frame's pixels. Nothing is
    copied or expanded into memory. Raises TypeError for another type,
    ValueError for tensors on two devices, a non-contiguous full plane,
    shapes that do not broadcast, or more than 2**31 - 1 elements."""
    _call_device(*operands)
    tensors = []
    for op in operands:
        if isinstance(op, torch.Tensor):
            if op.dtype != torch.float32:
                raise TypeError(f"evmath: the kernel takes float32 operands, got {op.dtype}")
            if not _is_host_scalar(op):
                tensors.append(op)
        elif not isinstance(op, numbers.Real):
            raise TypeError(f"evmath: an operand is a number or a float32 tensor, got {type(op).__name__}")
    shape = _broadcast_shape([tuple(t.shape) for t in tensors])
    if math.prod(shape) > MAX_ELEMENTS:
        raise ValueError(f"evmath: the kernel takes at most {MAX_ELEMENTS} elements, got {shape}")
    contiguous = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    kinds, strides = [], []
    for t in tensors:
        if tuple(t.shape) == shape:
            if not t.is_contiguous():
                raise ValueError(f"evmath: a full-plane operand must be contiguous, got strides "
                                 f"{t.stride()} for shape {shape}")
            kinds.append(FULL)
            strides.append(contiguous)
        else:
            kinds.append(STRIDED)
            strides.append(t.expand(shape).stride())
    dims, merged = _merge_dims(list(shape), strides)
    planned = iter(zip(tensors, kinds, merged))
    out = []
    for op in operands:
        if isinstance(op, torch.Tensor) and not _is_host_scalar(op):
            t, kind, s = next(planned)
            out.append(Operand(kind, t, 0.0, s))
        else:
            out.append(Operand(VALUE, None, float(np.float32(float(op))), (0, 0, 0)))
    return shape, dims, out


def _c_operand(op: Operand) -> tuple:
    ptr = None if op.tensor is None else op.tensor.data_ptr()
    return (ptr, op.kind, op.value, *op.strides)


def _map_operand(x, dtype, what: str) -> int:
    """The element count of a unary transform's input: a contiguous tensor of
    ``dtype``."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype:
        raise TypeError(f"evmath.{what}: the kernel takes a {dtype} tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if not x.is_contiguous():
        raise ValueError(f"evmath.{what}: the kernel takes a contiguous tensor, got strides {x.stride()}")
    if x.numel() > MAX_ELEMENTS:
        raise ValueError(f"evmath.{what}: the kernel takes at most {MAX_ELEMENTS} elements")
    return x.numel()


# ------------------------------------------ planners: (entry, shape, dtype, C arguments)


def _plan_fma(x, y, z):
    shape, dims, ops = plan_operands((x, y, z))
    return ("mlvfs_ev_fma", shape, torch.float32,
            (math.prod(shape), dims[1], dims[2], *(a for op in ops for a in _c_operand(op))))


def _plan_log2_add(x, c):
    if not isinstance(x, torch.Tensor) or _is_host_scalar(x):
        raise TypeError("evmath.log2_add: x is a float32 tensor on the card")
    shape, dims, (xo, co) = plan_operands((x, c))
    if xo.kind != FULL:
        raise ValueError(f"evmath.log2_add: x must have the result's shape {shape}, got {tuple(x.shape)}")
    return ("mlvfs_ev_log2_add", shape, torch.float32,
            (math.prod(shape), dims[1], dims[2], x.data_ptr(), *_c_operand(co)))


def _plan_map(name: str, in_dtype, out_dtype):
    """The planner of a unary transform; its integer levels follow the input."""
    def plan(x, *levels):
        n = _map_operand(x, in_dtype, name)
        return "mlvfs_ev_" + name, tuple(x.shape), out_dtype, (n, x.data_ptr(), *map(int, levels))

    return plan


_plan_log_f32 = _plan_map("log_f32", torch.float32, torch.float32)
_plan_log2_f32 = _plan_map("log2_f32", torch.float32, torch.float32)
_plan_exp2_f32 = _plan_map("exp2_f32", torch.float32, torch.float32)
_plan_raw2ev20 = _plan_map("raw2ev20", torch.int32, torch.int32)
_plan_fullres_weight = _plan_map("fullres_weight", torch.int32, torch.float32)
_plan_ev2raw20_levels = _plan_map("ev2raw20", torch.int32, torch.int32)  # ..., white_ev, zero_ev


@functools.lru_cache(maxsize=16)
def zero_ev(black20: int) -> int:
    """raw2ev20(0): the EV that ev2raw20 maps to 0, on the host, once a level."""
    return int(raw2ev20_plain(torch.zeros(1, dtype=torch.int32), black20)[0])


def _plan_ev2raw20(ev, black20, white20, white_ev):
    return _plan_ev2raw20_levels(ev, black20, white20, white_ev, zero_ev(int(black20)))


def _launch(entry: str, shape, dtype, cargs, device) -> torch.Tensor:
    global KERNEL_LAUNCHES
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _build.entry("evmath", entry)
    rc = _build.on_current_stream(device, lambda stream: fn(out.data_ptr(), *cargs, stream))
    if rc != 0:
        raise RuntimeError(f"evmath kernel {entry} launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    metrics.count("ev.launches")
    return out


def _dispatch(plain, planner, *args):
    """``plain(*args)`` on the CPU; on a CUDA device the kernel entry that
    ``planner(*args)`` names, with its arguments; anything else raises."""
    dev = _call_device(*args)
    if dev.type == "cpu":
        return plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"evmath: unsupported device {dev}")
    entry, shape, dtype, cargs = planner(*args)
    return _launch(entry, shape, dtype, cargs, dev)


# ------------------------------------------------------ the transforms


@_ev
def fma(x, y, z) -> torch.Tensor:
    """x * y + z rounded once to float32, broadcasting; any operand may be a
    Python float (a value, as is a 0-dim host tensor: a call on CUDA tensors
    copies nothing to the card and never synchronises)."""
    return _dispatch(fma_plain, _plan_fma, x, y, z)


@_ev
def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, bit for bit as XLA's CPU backend
    computes it (:func:`log_f32_plain`)."""
    return _dispatch(log_f32_plain, _plan_log_f32, x)


@_ev
def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA lowers it: log(x) * f32(1/ln 2), two roundings."""
    return _dispatch(log2_f32_plain, _plan_log2_f32, x)


@_ev
def log2_add(x: torch.Tensor, c) -> torch.Tensor:
    """jnp.log2(x) + c, the multiply contracted into the add (as XLA does);
    ``c`` a float or a float32 tensor that broadcasts to ``x``."""
    return _dispatch(log2_add_plain, _plan_log2_add, x, c)


@_ev
def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.exp2 as XLA lowers it: exp(x * f32(ln 2))."""
    return _dispatch(exp2_f32_plain, _plan_exp2_f32, x)


@_ev
def raw2ev20(i: torch.Tensor, black20: int) -> torch.Tensor:
    """round(log2(1 + |i/64 - black/64|) * EVR) * sign (hdr.c:843-850), int32."""
    return _dispatch(raw2ev20_plain, _plan_raw2ev20, i, black20)


@_ev
def ev2raw20(ev: torch.Tensor, black20: int, white20: int, white_ev: int) -> torch.Tensor:
    """Inverse transform with the black offset and the white clamp
    (hdr.c:852-865), int32. ``white_ev`` is raw2ev(white20), a host scalar."""
    return _dispatch(ev2raw20_plain, _plan_ev2raw20, ev, black20, white20, white_ev)


@_ev
def fullres_weight(i: torch.Tensor, black20: int) -> torch.Tensor:
    """Fullres mixing curve (build_fullres_curve, hdr.c:890-913), float32."""
    return _dispatch(fullres_weight_plain, _plan_fullres_weight, i, black20)
