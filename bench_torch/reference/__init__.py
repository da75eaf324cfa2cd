"""The plain reference of the benchmark's check.

Copies of the port's plain twins (``mlvfs_tpu_torch/ops``, commit 1c20a80)
with their CUDA kernel routes removed, so that they run plain PyTorch on
the card too, and ``pipeline.py``, a cut copy of ``run_pipeline`` that
drives them. Nothing here imports the program, jax or ``mlvfs_tpu``; the
copies stay as they are when the program changes, so the yardstick does.
"""
