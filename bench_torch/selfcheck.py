"""A rehearsal of the benchmark on the CPU; it needs no card and measures
nothing.

    python3 bench_torch/selfcheck.py

It loads ``BENCHMARK.json`` and every configuration, traffic mix, cell and
metric file by name and checks that they agree; makes a tiny take with the
torch generator, writes it with the MLV writer and reads it back through
the program's reader; checks the metric arithmetic on fixed inputs (the
busy union, the p95, the AMaZE bound, frames counted only inside the
window); and shows that a cell file dropped into ``workloads/`` is found
without editing any other file. Exits 0 when every check holds.
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import catalog  # noqa: E402

FAILURES = []


def check(ok: bool, what: str):
    print(("ok   " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def check_manifest():
    bench = catalog.manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    check(set(cells) <= set(catalog.names("workloads")), "every cell has workloads/<cell>.json")
    for name, w in cells.items():
        f = catalog.cell(name)
        check(f["config"] == w["config"] and f["traffic"] == w["traffic"] and f["why"] == w["why"],
              f"{name}: its file agrees with BENCHMARK.json")
        catalog.traffic(w["traffic"])
        check(w["config"] in configs, f"{name}: configuration {w['config']} listed")
        e2e = catalog.metrics_of(name, False)
        layer = catalog.metrics_of(name, True)
        check("setup_s" in e2e and len(e2e) >= 2 and layer, f"{name}: setup_s, another end-to-end metric, a per-layer metric")
        for m in bench["per_layer"]:
            if name in m.get("workloads", [name]):
                check(m["moves"] in e2e, f"{name}: {m['name']} moves {m['moves']}, which the cell reports")
    for name, c in configs.items():
        f = catalog.config(name)
        check(c["file"] == f"bench_torch/configs/{name}.json" and f["source"] == c["source"]
              and f["reduced"] == c["reduced"], f"config {name}: file, source and reduced agree")
        check(any(w["config"] == name for w in cells.values()), f"config {name}: used by a cell")
    for m in bench["end_to_end"] + bench["per_layer"]:
        module = catalog.metric(m["name"])
        check(module.UNIT == m["unit"] and module.SOURCE == m["source"] and callable(module.read),
              f"metric {m['name']}: reader with its unit and source")
    # every file of every kind loads by its name, listed in BENCHMARK.json or kept for a later cell
    for name in catalog.names("configs"):
        check(catalog.config(name)["name"] == name, f"configs/{name}.json")
    for name in catalog.names("traffic"):
        check(catalog.traffic(name)["name"] == name, f"traffic/{name}.json")
    for name in catalog.names("workloads"):
        f = catalog.cell(name)
        catalog.config(f["config"])
        catalog.traffic(f["traffic"])
        check(bool(f["limits"]), f"workloads/{name}.json: its configuration, traffic and limits")
    for name in catalog.names("metrics"):
        module = catalog.metric(name)
        check(callable(module.read) and module.SOURCE in ("host_clock", "device_trace", "program_span",
                                                          "program_counter"), f"metrics/{name}.py")


def check_take():
    import numpy as np
    import torch

    import take as take_mod
    from mlvfs_tpu_torch.format.reader import MLVClip
    from mlvfs_tpu_torch.ops.unpack import unpack_batch

    cfg = catalog.config("5d3-1080p24-14bit-dualiso")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "T.MLV")
        t = take_mod.write(path, cfg, 6, 2**31 + 3, 4, torch.device("cpu"), size=(64, 32))
        again = take_mod.make_frames(t, 4, torch.device("cpu"))
        with MLVClip(path, use_sidecar=False) as clip:
            fh = clip.frame_headers(0)
            check((clip.frame_count, fh.xres, fh.yres, fh.raw_info.bits_per_pixel,
                   fh.raw_info.black_level) == (6, 64, 32, 14, 2048), "the take's headers read back")
            words = np.stack([np.asarray(clip.frame_payload(i)).view("<u2") for i in (4, 5)])
            got = unpack_batch(torch.from_numpy(words.view(np.int16)), 14, 32, 64)
        check(torch.equal(got.to(torch.int32) & 0xFFFF, again), "frames 4-5 unpack to the generator's, made again")
        rows = again[0].double().mean(dim=1)
        check(bool((rows[2::4] > rows[0::4] * 2).all()), "dual-ISO rows 2-3 of 4 brighter")


def check_arithmetic():
    import devtrace
    import harness
    import roofline
    import spans

    check(devtrace.busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4, "busy union of overlapping spans")
    p95 = catalog.metric("batch_latency_ms_p95").percentile
    check(p95(list(range(1, 101)), 95) == 95 and p95([7], 95) == 7 and p95(list(range(1, 21)), 95) == 19,
          "nearest-rank p95")
    ops, by = roofline.demosaic_bound(16, 540, 1920, 0)
    n_pad = 16 * 572 * 1952
    want = n_pad * (446 + 50) / 67e12 + n_pad * 8 / (132 * 64 * 1.98e9)
    check(by == "operations" and abs(ops - want) < 1e-15, "AMaZE bound at (16, 540, 1920)")
    check(roofline.kernel_base_name("(anonymous namespace)::k_group1(float*, int, int, int)") == "k_group1"
          and roofline.kernel_base_name("void (anonymous namespace)::refine_kernel<true>(float const*, float*, "
                                        "int, int, int)") == "refine_kernel"
          and roofline.kernel_base_name("Memcpy DtoH (Device -> Pinned)") == "DtoH",
          "kernel names from the profiler's (as an H100 trace spells them)")
    rec = spans.Recorder(cuda=False)
    rec.host = [("finish", 0, (0, 16), "w", 0.1, 0.5), ("finish", 0, (16, 16), "w", 0.4, 1.2),
                ("fetch", 0, (0, 16), "p", 0.0, 0.05), ("fetch", 0, (16, 16), "p", 0.05, 0.3)]
    batches = harness._window_batches(rec, t_close=1.0)
    check([b["first"] for b in batches] == [0] and sum(b["n"] for b in batches) == 16,
          "a batch written after the window's close is not counted")
    check(harness.sample_batches([0, 16, 32, 48], 2, 5) == harness.sample_batches([0, 16, 32, 48], 2, 5)
          and harness.sample_batches([0, 16, 32, 48], 2, 5)[0] == 0, "the check's sample: batch 0 and a seeded draw")


def check_discovery():
    name = "selfcheck-probe"
    path = os.path.join(HERE, "workloads", f"{name}.json")
    try:
        with open(path, "w") as f:
            f.write('{"config": "5d3-1080p24-14bit", "traffic": "default", "limits": {}, "why": "probe"}')
        check(name in catalog.names("workloads") and catalog.cell(name)["traffic"] == "default",
              "a cell file dropped into workloads/ is found by name")
    finally:
        os.unlink(path)


def main() -> int:
    check_manifest()
    check_take()
    check_arithmetic()
    check_discovery()
    print(f"selfcheck: {len(FAILURES)} failed")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
