"""Mean time of ``ClipConverter.fetch_batch`` a batch in the window, on the
prefetch threads: the frames' payloads gathered from the take's mapping
into the pinned staging ring and the host-to-device copy enqueued."""

SOURCE = "program_span"
UNIT = "ms"


def read(rec):
    spans = [b["fetch"] for b in rec.batches if b["fetch"]]
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans) if spans else None
