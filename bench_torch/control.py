"""Readings that the check's limits are set from; the benchmark's runs do
not run this.

    python3 bench_torch/control.py --workload <cell> --seeds 11,12,13 [--seconds S] [--sound]

For each seed, the control: the plain reference put in the program's place
and computed one step below the configuration's precision (``float32``:
every fused product rounded twice, for the dual-ISO cells; ``12bit``: each
14-bit sample's two low bits dropped, for the plain cells), compared with
the reference on the batches a run would check, at the cell's own size.
With ``--sound``, also one run of the program for each seed (a window of
``--seconds``), in this one process, and its check numbers. Prints one JSON
line a reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_of(mix: dict) -> str:
    return "float32" if "--dual-iso" in mix["flags"] else "12bit"


def control_readings(cell_name: str, seed: int, device: str, size=None, take_frames=None) -> dict:
    """The control's check numbers for one seed, against the reference."""
    import catalog
    import dngcheck
    import harness
    import take as take_mod

    cell = catalog.cell(cell_name)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    import torch

    dev = torch.device(device)
    width, height = size or (cfg["sensor"]["width"], cfg["sensor"]["height"])
    take = take_mod.Take("", int(take_frames or mix["take_frames"]), width, height, int(mix["batch"]),
                         seed, cfg)
    settings = harness.reference_settings(list(mix["flags"]), take.batch)
    batches = harness.sample_batches(take.batches, mix["check_batches"], seed)
    dual = settings.dual_iso == 2
    exact = list(harness.reference_outputs(take, settings, batches, dev))
    low = list(harness.reference_outputs(take, settings, batches, dev, control=control_of(mix)))
    totals = {"px_diff": 0, "hdr_diff": 0, "missing": 0, "unconverted": 0}
    for (first, want, levels, bias), (_, got, got_levels, got_bias) in zip(exact, low):
        frames = []
        for k in range(got.shape[0]):
            tags = {dngcheck.IMAGE_WIDTH: (width,), dngcheck.IMAGE_LENGTH: (height,),
                    dngcheck.BITS_PER_SAMPLE: (16,), dngcheck.BLACK_LEVEL: (got_levels[k][0],),
                    dngcheck.WHITE_LEVEL: (got_levels[k][1],)}
            if got_bias is not None:
                tags[dngcheck.BASELINE_EXPOSURE] = tuple(got_bias[k])
            frames.append((tags, got[k]))
        t = harness.compare(frames, want, levels, bias, take, dual)
        for key in totals:
            totals[key] += t[key]
    return {name: totals[name] for name in cell["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sound", action="store_true", help="also run the program on each seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import catalog
    import harness

    mix = catalog.traffic(catalog.cell(args.workload)["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.sound:
            t = time.perf_counter()
            result = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t,
                                      device=args.device)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": "program",
                              "correct": result["correct"], "attempted": result["attempted"],
                              "metrics": result["metrics"],
                              "check": {k: v["value"] for k, v in result["check"].items()}}), flush=True)
        t = time.perf_counter()
        readings = control_readings(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": f"control:{control_of(mix)}",
                          "check": readings, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
