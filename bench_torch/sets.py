"""Sets of runs of one cell, one after another, and their spreads.

    python3 bench_torch/sets.py --workload <cell> --seconds <s> [<s> ...]
        [--trace 0|1] --seeds <n> [<n> ...] [--repeat <k>] [--out <file.jsonl>]

from the checkout's root. Runs ``run.py`` once for each seed (``--repeat``
times the list, in order) and window length, each run its own process and
never two at once; with several lengths each seed runs all of them, in
the given order for the first, third, ... seed and reversed for the
others, so that lengths compare within one machine and one hour. Appends
to ``--out`` one JSON line a run: its seed, window, exit code, seconds,
result line and the ``host`` record it logged on standard error. Prints a
line a run, then for each window length and each metric of the result the
median and the quartile spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median, as the bounds in
``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values: list) -> float:
    """Quartile spread of ``values`` as a share of their median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def last_json(text: str, prefix: str = ""):
    """The last line of ``text`` that holds a JSON object after ``prefix``."""
    for line in reversed(text.splitlines()):
        if line.startswith(prefix + "{"):
            try:
                return json.loads(line[len(prefix):])
            except json.JSONDecodeError:
                continue
    return None


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True)
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace, "rc": proc.returncode,
            "wall_s": round(time.perf_counter() - t, 3), "result": last_json(proc.stdout),
            "host": last_json(proc.stderr, "host "), "stderr_tail": proc.stderr[-1500:]}


def summarize(runs: list) -> dict:
    """{metric: (median, spread, n)} over the runs that gave a result."""
    values = {}
    for r in runs:
        for name, m in ((r["result"] or {}).get("metrics") or {}).items():
            values.setdefault(name, []).append(m["value"])
    return {name: (statistics.median(v), spread(v) if len(v) >= 2 else None, len(v))
            for name, v in values.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    order = [(seed, seconds) for k, seed in enumerate(args.seeds * args.repeat)
             for seconds in (args.seconds[::-1] if k % 2 else args.seconds)]
    for seed, seconds in order:
        r = run_once(args.workload, seed, seconds, args.trace)
        runs.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        res, host = r["result"] or {}, r["host"] or {}
        vals = {k: round(v["value"], 4) for k, v in (res.get("metrics") or {}).items()}
        print(f"{args.workload} seed {seed} {seconds:g} s rc {r['rc']} correct {res.get('correct')} "
              f"{vals} passes {host.get('passes_s')}", flush=True)
    for seconds in args.seconds:
        for name, (med, spr, n) in summarize([r for r in runs if r["seconds"] == seconds]).items():
            print(f"{args.workload} {seconds:g} s {name}: median {med:.4f} over {n} runs, quartile "
                  f"spread {'-' if spr is None else f'{100 * spr:.3f} %'}", flush=True)
    return 0 if all(r["rc"] == 0 and (r["result"] or {}).get("correct") for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
