"""Host→device streaming with prefetch.

Counterpart of ``mlvfs_tpu/pipeline/stream.py``, unchanged in design. (The
JAX-only persistent compile cache has no counterpart.)

Implements the reference's documented-but-never-implemented ``--prefetch``
option (README.md:42, absent from the option table main.c:1853-1882) as a
real pipeline stage: a background thread gathers packed frames from the
memory-mapped chunks and stages them on the device while the previous batch
computes, so disk I/O, host decode (LZMA/LJ92), PCIe upload, and device
compute overlap.
"""

from __future__ import annotations

import concurrent.futures

from ..utils import metrics


class BatchPrefetcher:
    """Iterator over (indices, fetched) pairs with ``depth`` batches in flight.

    ``fetch(indices)`` runs on a background thread; it should end with an
    async device transfer (a non-blocking copy on a side stream) so upload
    overlaps compute too.
    """

    def __init__(self, fetch, batches, depth: int = 2):
        self._fetch = fetch
        self._batches = list(batches)
        self._depth = max(1, depth)
        # one worker per in-flight batch: compressed-clip host decode
        # (LZMA / native LJ92, both GIL-releasing) parallelizes across
        # batches instead of serializing on a single prefetch thread
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=self._depth)

    def __iter__(self):
        inflight = []
        batches = self._batches
        for idx in batches[: self._depth]:
            inflight.append(self._pool.submit(self._fetch, idx))
        try:
            for i, idx in enumerate(batches):
                fut = inflight.pop(0)
                nxt = i + self._depth
                if nxt < len(batches):
                    inflight.append(self._pool.submit(self._fetch, batches[nxt]))
                with metrics.span("wait.fetch", metrics.SYNC, batch=idx[0]):
                    fetched = fut.result()
                yield idx, fetched
        finally:
            for fut in inflight:
                fut.cancel()
            self._pool.shutdown(wait=False)

