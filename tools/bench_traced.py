"""A benchmark run of a cell with the port's tracer switched on, and what
the tracer saw:

    python3 tools/bench_traced.py --workload <cell> --seed <n> --seconds <s> \
        [--trace 0|1] [--detail <file.json>]

from the checkout's root. It runs ``bench_torch/run.py`` as the benchmark
runs a cell. With ``--trace 0`` (the default) it also loads the readers of
the program's spans (``READERS``), as a ``--trace 1`` run does: loading
them switches the tracer on after the warm-up, so the window is traced as
in a traced run, without the profiler and the harness's own device spans;
this measures what tracing costs the end-to-end metrics. The last line is
``run.py``'s, the readers' metrics beside the end-to-end ones.

``--detail`` writes, after the run, each take boundary of the window (the
compute stream's idle across it, as ``take_boundary_ms`` reads it, the
host ms of the ``take.*`` spans and the first ``wait.fetch`` around it,
and the host ms between the two ``take`` spans),
each span name's count, host ms and device ms a span, and the program's
counters over the whole process (the warm-up convert included).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("recon_ev_ms", "recon_interp_ms", "take_boundary_ms")


def boundaries(spans) -> list:
    """Each take boundary: take k's last ``process`` device end to take
    k+1's first ``decode`` device start, with the host spans around it."""
    import catalog

    gaps = catalog.metric("take_boundary_ms").gaps_ms(spans)
    takes = sorted({s.take for s in spans if s.name == "process" and s.dev_t1 is not None})
    out = []
    for k, gap in zip([k for k in takes if k + 1 in takes], gaps):
        row = {"take": k, "gap_ms": gap}
        for name, take in (("take.drain", k), ("take.save_cal", k), ("take.close", k),
                           ("take.open", k + 1), ("take.setup", k + 1)):
            row[name] = sum(s.host_ms for s in spans if s.name == name and s.take == take)
        row["wait.fetch"] = sum(s.host_ms for s in spans
                                if s.name == "wait.fetch" and s.batch == (k + 1, 0))
        ends = [s.t1 for s in spans if s.name == "take" and s.take == k]
        starts = [s.t0 for s in spans if s.name == "take" and s.take == k + 1]
        # the new anchor and the caller's work between the two takes
        row["between_takes"] = (starts[0] - ends[0]) / 1e6 if ends and starts else None
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--detail")
    args, rest = ap.parse_known_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "bench_torch"), ROOT]
    import catalog
    import run

    if not args.trace:
        metrics_of = catalog.metrics_of

        def with_readers(cell_name, traced, root=catalog.ROOT):
            return metrics_of(cell_name, traced, root) + list(READERS)

        catalog.metrics_of = with_readers
    rc = run.main(rest + ["--trace", str(args.trace)])
    if rc == 0 and args.detail:
        from mlvfs_tpu_torch.utils import metrics

        spans = metrics.spans()
        totals = metrics.totals(spans)
        for t in totals.values():
            t["host_ms"] /= t["count"]
            t["self_ms"] /= t["count"]
            if t["device_ms"] is not None:
                t["device_ms"] /= t["count"]
        os.makedirs(os.path.dirname(os.path.abspath(args.detail)), exist_ok=True)
        with open(args.detail, "w") as f:
            json.dump({"boundaries": boundaries(spans), "per_span": totals, "counters": metrics.counters()},
                      f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
