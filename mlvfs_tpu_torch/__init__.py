"""mlvfs_tpu_torch — the MLV → CinemaDNG conversion engine on PyTorch and CUDA.

The port of ``mlvfs_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference: each ported module keeps its
counterpart's name and is held bit-exact against it. The port imports torch
and never jax; it reuses the reference package's JAX-free host modules as
they are (``mlvfs_tpu.format``, ``mlvfs_tpu.emit``, ``mlvfs_tpu.codecs`` and
the bundled ``.fpm`` maps).

Layering:

  - ``mlvfs_tpu_torch.ops``      — LUTs, bit unpack (CUDA kernel + plain twin),
                                   focus-pixel fix
  - ``mlvfs_tpu_torch.pipeline`` — batch conversion engine, prefetch, calibration
  - ``mlvfs_tpu_torch.csrc``     — hand-written CUDA kernels (built by ``_build``)
  - ``mlvfs_tpu_torch.cli``      — ``python -m mlvfs_tpu_torch convert|info``
"""

__version__ = "0.1.0"
