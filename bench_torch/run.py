"""The benchmark of mlvfs_tpu_torch: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. Prints, as its last line on standard output, one
JSON object: ``correct``, ``attempted``, ``failed`` (DNG frames),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, as ``BENCHMARK.json`` lists them), ``device``,
``breakdown`` when traced, and last ``check``: each number compared with
the plain reference beside its limit, which are also the last lines on
standard error. Exits 2, printing no result, without the CUDA devices the
cell needs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "bench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.NoChip as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 2
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
