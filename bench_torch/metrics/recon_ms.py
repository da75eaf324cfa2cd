"""Device time a batch of the dual-ISO reconstruction,
``ops.dualiso_full.reconstruct_batch`` (the interpolation, the EV
transforms of ``ops.evmath``, the alias filter #7, AMaZE through
``ops.amaze``), by CUDA events on the compute stream around each call in
the traced window: the mean over its calls."""

SOURCE = "program_span"
UNIT = "ms"
DEVICE_SPANS = {"recon": "mlvfs_tpu_torch.ops.dualiso_full:reconstruct_batch"}


def read(rec):
    ms = [m for _, _, m in rec.device_ms("recon")]
    return sum(ms) / len(ms) if ms else None
