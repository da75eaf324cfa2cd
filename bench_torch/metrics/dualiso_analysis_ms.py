"""Device time a batch of the dual-ISO analysis: ``ops.dualiso_full.
hdr_check_batch`` and ``ops.dualiso_analysis_dev.analyze_batch`` by CUDA
events on the compute stream around each call in the traced window, the
mean of each summed. The (B,)-sized readback of its result that follows
the call is not inside the events."""

SOURCE = "program_span"
UNIT = "ms"
DEVICE_SPANS = {
    "hdr_check": "mlvfs_tpu_torch.ops.dualiso_full:hdr_check_batch",
    "analysis": "mlvfs_tpu_torch.ops.dualiso_analysis_dev:analyze_batch",
}


def read(rec):
    total = 0.0
    for name in DEVICE_SPANS:
        ms = [m for _, _, m in rec.device_ms(name)]
        if not ms:
            return None
        total += sum(ms) / len(ms)
    return total
