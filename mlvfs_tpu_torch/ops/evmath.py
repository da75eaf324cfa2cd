"""Computed 20-bit EV transforms in float32 torch, the default (non-exact)
form of the full dual-ISO reconstruction's raw↔EV maps.

Counterpart of ``mlvfs_tpu/ops/evmath.py``: the reference's 20-bit tables
(build_ev2raw_lut, hdr.c:839-874) and fullres curve (hdr.c:890-913) are
log2/exp2/cos curves, computed per pixel in float32 instead of gathered from
4 MB tables. The reference's gate for these is PSNR, not bit equality.

The float32 operations are the ones XLA on the CPU runs for the reference:
``log2(x)`` is ``log(x) * f32(1/ln 2)``, ``exp2(x)`` is ``exp(x * f32(ln 2))``,
a product that feeds an add is one fused multiply-add, and ``log`` and
``exp`` are XLA's Cephes polynomials (:func:`log_f32`, :func:`exp_f32`),
reproduced operation for operation with exact fused multiply-adds
(:func:`~.dualiso.fma_f32`). Each step is an IEEE float32 operation or an
exact emulation of one, so the CPU and the card give the same values.
``cos`` is taken in float64 and rounded once; XLA's float32 cos differs
from that in about 1 % of inputs, which the PSNR gate covers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import metrics
from .dualiso import fma_f32
from .luts import EV_RESOLUTION

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


@_ev
def fma(x, y, z) -> torch.Tensor:
    """x * y + z rounded once to float32, broadcasting; any operand may be a
    Python float (taken as float32, and kept a 0-dim host tensor, so a call on
    CUDA tensors copies nothing to the card and never synchronises)."""
    return fma_f32(*(t.to(torch.float32) if isinstance(t, torch.Tensor) else
                     torch.tensor(t, dtype=torch.float32) for t in (x, y, z)))


@_ev
def log_f32(x: torch.Tensor) -> torch.Tensor:
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
    y = fma(t, p[0], p[1])
    y1 = fma(t, p[3], p[4])
    y2 = fma(t, p[6], p[7])
    y = fma(y, t, p[2])
    y1 = fma(y1, t, p[5])
    y2 = fma(y2, t, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    t = fma(-0.5, x2, t) + y
    out = fma(_LOG_Q2, e, t)
    out = torch.where(torch.isinf(x), x, torch.where(x == 0, -torch.inf, out))
    return torch.where((x < 0) | torch.isnan(x), torch.nan, out)


@_ev
def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, bit for bit as XLA's CPU backend computes it
    for x in about [-87, 88] (2^n a normal float): n = floor(x / ln 2 + 1/2),
    r = x - n ln 2 in two parts, a degree-5 polynomial in r, times 2^n."""
    xc = torch.clamp(x, -104.0, 88.8)
    n = torch.floor(fma(xc, _LOG2EF, 0.5))
    r = fma(-_EXP_C1, n, xc)
    r = fma(-_EXP_C2, n, r)
    z = r * r
    p = _EXP_P
    y = fma(r, p[0], p[1])
    for c in p[2:]:
        y = fma(y, r, c)
    y = 1.0 + fma(y, z, r)
    scale = ((n.to(torch.int32).clamp(-126, 127) + 127) << 23).view(torch.float32)  # 2^n
    return y * scale


@_ev
def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor, taken in float64 and rounded once."""
    return torch.cos(x.double()).float()


@_ev
def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA lowers it: log(x) * f32(1/ln 2), two roundings."""
    return log_f32(x) * INV_LN2


@_ev
def log2_add(x: torch.Tensor, c) -> torch.Tensor:
    """jnp.log2(x) + c, the multiply contracted into the add (as XLA does);
    ``c`` a float or a float32 tensor that broadcasts to ``x``."""
    return fma(log_f32(x), INV_LN2, c)


@_ev
def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.exp2 as XLA lowers it: exp(x * f32(ln 2))."""
    return exp_f32(x * LN2)


@_ev
def raw2ev20(i: torch.Tensor, black20: int) -> torch.Tensor:
    """round(log2(1 + |i/64 - black/64|) * EVR) * sign (hdr.c:843-850), int32."""
    signal = torch.clamp(i.to(torch.float32) / 64.0 - black20 / 64.0, min=-1023.0)
    mag = torch.round(log2_f32(1.0 + signal.abs()) * EV_RESOLUTION)
    return torch.where(signal > 0, mag, -mag).to(torch.int32)


@_ev
def ev2raw20(ev: torch.Tensor, black20: int, white20: int, white_ev: int) -> torch.Tensor:
    """Inverse transform with the black offset and the white clamp
    (hdr.c:852-865), int32. ``white_ev`` is raw2ev(white20), a host scalar."""
    evf = ev.to(torch.float32)
    pos = torch.clamp(black20 - 64.0 + torch.round(64.0 * exp2_f32(evf / EV_RESOLUTION)),
                      float(black20), float((1 << 20) - 1))
    pos = torch.where(ev >= white_ev, torch.clamp(pos, min=float(white20)), pos)
    neg = torch.clamp(black20 + 64.0 - torch.round(64.0 * exp2_f32(-evf / EV_RESOLUTION)),
                      0.0, float(black20))
    out = torch.where(ev < 0, neg, pos)
    # table quirk: ev2raw[raw2ev[0]] = 0 keeps fully-dead pixels (hdr.c:868)
    zero_ev = int(raw2ev20(torch.zeros(1, dtype=torch.int32), black20)[0])
    out = torch.where(ev == zero_ev, 0.0, out)
    return out.to(torch.int32)


@_ev
def fullres_weight(i: torch.Tensor, black20: int) -> torch.Tensor:
    """Fullres mixing curve (build_fullres_curve, hdr.c:890-913), float32."""
    fullres_start, fullres_transition = 4.0, 4.0
    x = torch.clamp(i.to(torch.float32) / 64.0 - black20 / 64.0, min=1.0)
    ev2 = log2_add(x, -fullres_start)  # log2(x) - 4, contracted
    c2 = -cos_f32(torch.clamp(ev2, 0.0, fullres_transition)
                  * float(np.float32(math.pi / fullres_transition)))
    return (c2 + 1.0) * 0.5
