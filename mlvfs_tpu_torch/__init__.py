"""mlvfs_tpu_torch — the MLV → CinemaDNG conversion engine on PyTorch and CUDA.

The port of ``mlvfs_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference: each ported module keeps its
counterpart's name and is held bit-exact against it. The port imports torch
and never jax, and nothing of ``mlvfs_tpu``: it carries its own copies of the
reference's JAX-free host modules (``format``, ``emit``, ``codecs`` with the
LJ92 source in ``csrc/lj92.cpp``, and the bundled ``.fpm`` maps in ``data/``).

Layering:

  - ``mlvfs_tpu_torch.format``   — MLV container model, chunk discovery, index,
                                   synthetic clips (host, numpy)
  - ``mlvfs_tpu_torch.emit``     — CDNG headers, BWF WAV, GIF preview (host)
  - ``mlvfs_tpu_torch.codecs``   — the native LJ92 codec (g++, ctypes)
  - ``mlvfs_tpu_torch.ops``      — LUTs, bit unpack and chroma smoothing (CUDA
                                   kernels + plain twins), focus/bad-pixel fix,
                                   deflicker median, stripe correction
  - ``mlvfs_tpu_torch.pipeline`` — batch conversion engine, prefetch, calibration
  - ``mlvfs_tpu_torch.csrc``     — hand-written CUDA kernels (built by ``_build``)
  - ``mlvfs_tpu_torch.cli``      — ``python -m mlvfs_tpu_torch convert|info``
"""

__version__ = "0.1.0"

SOFTWARE_NAME = "MLVFS"  # written into the DNG Software tag; matches reference output
