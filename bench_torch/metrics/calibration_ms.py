"""The per-take calibration on the host: ``ops.pixels.detect_bad_pixels``
plus ``ops.stripes.compute_correction``, summed over each take pass whose
calibration ran in the window, and the mean over those passes."""

SOURCE = "program_span"
UNIT = "ms"
HOST_SPANS = {
    "bad_pixels": "mlvfs_tpu_torch.ops.pixels:detect_bad_pixels",
    "stripes_cal": "mlvfs_tpu_torch.ops.stripes:compute_correction",
}


def read(rec):
    per_pass = {}
    for name in HOST_SPANS:
        for _, p, _, _, t0, t1 in rec.spans(name):
            per_pass[p] = per_pass.get(p, 0.0) + (t1 - t0)
    return 1e3 * sum(per_pass.values()) / len(per_pass) if per_pass else None
