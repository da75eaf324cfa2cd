"""Share of its roofline at which the split-mode AMaZE demosaic runs:
kernels #8 (``csrc/amaze.cu``, five stage groups) and #10
(``csrc/amaze_scans.cu``, five raster passes) via ``ops.amaze_core``. The
least time is ``roofline.demosaic_bound`` with the passes, summed over the
traced window's demosaics, its Nyquist cells counted on these inputs from
each demosaic's dilated Nyquist map (``chip_smoke.py`` ``nyquist_cells``);
the time is those kernels' device time in the profiler's trace. Nothing
is read where the kernels did not run (mean23, or mega mode)."""

import roofline

SOURCE = "device_trace"
UNIT = "%"
_MASKS = {}


def _nyquist(args, kwargs, out):
    """One dilate call of a demosaic: its Nyquist cells (on the device) and
    its batch's least times on the host."""
    import torch

    b, hp, wp = out.shape
    mask = _MASKS.get((hp, wp, out.device))
    if mask is None:
        ys = torch.arange(hp, device=out.device)[:, None]
        xs = torch.arange(wp, device=out.device)[None, :]
        mask = _MASKS[(hp, wp, out.device)] = ((ys + xs) % 2) == 0
    h, w = hp - 2 * roofline.AMAZE_PAD, wp - 2 * roofline.AMAZE_PAD
    ops_s, bytes_s = roofline.demosaic_times(b, h, w, 0)
    return {"nyq_cells": ((out > 0) & mask).sum(), "ops_s_base": ops_s, "bytes_s": bytes_s,
            "bytes_may_bind": int(bytes_s > ops_s), "demosaics": 1}


TAPS = {"nyquist": ("mlvfs_tpu_torch.ops.amaze_scans:dilate", _nyquist)}


def read(rec):
    t, taps = rec.trace, rec.taps
    if not t or not taps.get("demosaics"):
        return None
    kernel_s = sum(s for name, s in t["kernel_s"].items()
                   if roofline.kernel_base_name(name) in roofline.AMAZE_SPLIT_KERNELS)
    if kernel_s <= 0:
        return None
    nyq_s = int(taps["nyq_cells"]) * roofline.AMAZE_OPS_PER_NYQ_CELL / roofline.FP32_OPS_PER_S
    if taps["bytes_may_bind"]:
        # a demosaic whose bound might be its bytes: the larger of the summed
        # bounds, still a least time of the whole
        bound_s = max(taps["ops_s_base"] + nyq_s, taps["bytes_s"])
    else:
        bound_s = taps["ops_s_base"] + nyq_s
    return 100.0 * bound_s / kernel_s
