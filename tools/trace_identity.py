"""A cell's DNGs converted with the port's tracer off and on, compared byte
for byte:

    python3 tools/trace_identity.py --workload <cell> [--frames 32] [--seed 1] \
        [--device cpu --size 128x96]

from the checkout's root, on a card. It makes the cell's take as the
benchmark makes it (``bench_torch/take.py``, ``--frames`` frames of the
cell's configuration), converts it with the cell's flags through
``convert_clip`` twice, tracing off and then on with device spans, and
prints one JSON line: the DNG count, how many differ, and the traced
conversion's device spans by name.
"""

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", help="WxH in place of the configuration's (a CPU rehearsal)")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "bench_torch"), ROOT]
    import torch

    import catalog
    import harness
    import take as take_mod
    from mlvfs_tpu_torch.pipeline.convert import convert_clip
    from mlvfs_tpu_torch.utils import metrics

    cell = catalog.cell(args.workload)
    mix = catalog.traffic(cell["traffic"])
    for key, value in mix.get("env", {}).items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    config = harness.program_config(list(mix["flags"]), args.device)
    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    workdir = harness.workdir_for(ROOT) + "-identity"
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        take = take_mod.write(os.path.join(workdir, "TAKE.MLV"), catalog.config(cell["config"]),
                              args.frames, args.seed, int(mix["batch"]), torch.device(args.device),
                              size)
        trees = []
        for traced in (False, True):
            harness._remove_sidecars(take.path)
            out = os.path.join(workdir, f"out{int(traced)}")
            if traced:
                metrics.reset()
                metrics.enable(device=config.device)
            try:
                convert_clip(take.path, out, config)
            finally:
                metrics.disable()
            trees.append({n: open(os.path.join(out, n), "rb").read() for n in sorted(os.listdir(out))})
        device = {}
        for s in metrics.spans():
            if s.kind == metrics.DEVICE:
                device[s.name] = device.get(s.name, 0) + (s.device_ms is not None)
        print(json.dumps({"cell": args.workload, "dngs": len(trees[0]),
                          "same_names": list(trees[0]) == list(trees[1]),
                          "differ": sum(trees[0][n] != trees[1].get(n) for n in trees[0]),
                          "device_spans": device}))
        return 0 if list(trees[0]) == list(trees[1]) and trees[0] == trees[1] else 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
