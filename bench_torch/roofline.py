"""The card's peaks and the least time of the kernels the benchmark rates.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``,
``FP32_OPS_PER_S``, ``AMAZE_OPS_PER_*``, ``RASTER_*_OPS_PER_PX``,
``demosaic_bound``), so that the yardstick stays as it is when the
program's smoke test changes. The HBM bandwidth and the float32 rate are
NVIDIA's published H100 SXM figures at the 700 W limit. The int32 rate,
132 SMs x 64 int32 lanes x 1.98 GHz, is derived from an assumed clock and
is not published: a share bounded by it is a share of that assumption.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores

# float32 operations of AMaZE's stencil stages: a padded pixel, and a
# Nyquist cell (the R/B sites of the dilated Nyquist map)
AMAZE_OPS_PER_PADDED_PX = 446
AMAZE_OPS_PER_NYQ_CELL = 1478
# float32 / int32 operations a padded pixel of the five raster passes of one
# demosaic: refine 5 (twice), chroma 20 (each of two planes), dilate 8
RASTER_FP32_OPS_PER_PX = 2 * 5 + 2 * 20
RASTER_INT32_OPS_PER_PX = 8
AMAZE_PAD = 16  # the reflect pad on each side (ops/amaze_core.py PAD)

# the kernels of the split-mode demosaic: #8's stage groups and #10's passes
AMAZE_SPLIT_KERNELS = ("k_group1", "k_group2", "k_group3", "k_group4", "k_output",
                       "refine_kernel", "dilate_kernel", "chroma_kernel")


def demosaic_times(b: int, h: int, w: int, n_nyq: int, with_passes: bool = True):
    """(operations time, bytes time) in seconds of the AMaZE demosaic of a
    (b, h, w) batch with ``n_nyq`` Nyquist cells: the stencil stages'
    float32 operations and, ``with_passes``, the five raster passes' float32
    and int32 operations; one plane in and three out at the HBM rate."""
    n_padded = b * (h + 2 * AMAZE_PAD) * (w + 2 * AMAZE_PAD)
    t_bytes = b * h * w * 4 * 4 / HBM_BYTES_PER_S
    t_ops = (n_padded * AMAZE_OPS_PER_PADDED_PX + n_nyq * AMAZE_OPS_PER_NYQ_CELL) / FP32_OPS_PER_S
    if with_passes:
        t_ops += (n_padded * RASTER_FP32_OPS_PER_PX / FP32_OPS_PER_S
                  + n_padded * RASTER_INT32_OPS_PER_PX / INT32_OPS_PER_S)
    return t_ops, t_bytes


def demosaic_bound(b: int, h: int, w: int, n_nyq: int, with_passes: bool = True):
    """(bound in seconds, "operations" or "bytes"): the larger of
    :func:`demosaic_times`."""
    t_ops, t_bytes = demosaic_times(b, h, w, n_nyq, with_passes)
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def kernel_base_name(name: str) -> str:
    """The kernel's own name from the profiler's demangled one:
    ``void (anonymous namespace)::refine_kernel<true>(float const*, ...)``
    -> ``refine_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else name
