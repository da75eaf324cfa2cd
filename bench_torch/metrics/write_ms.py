"""Mean time of ``ClipConverter._finish_batch`` a batch in the window, on
the write pool: the wait for the batch's compute, the pinned device-to-host
copy, the DNG headers rendered and one ``writev`` a DNG."""

SOURCE = "program_span"
UNIT = "ms"


def read(rec):
    spans = [b["finish"] for b in rec.batches]
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans) if spans else None
