"""Finds the benchmark's pieces by name: every configuration, traffic mix,
cell and metric is a file of its own under this directory, and
``BENCHMARK.json`` at the checkout's root lists which metrics each cell
reports. Adding a cell, a configuration or a metric adds a file and an
entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    path = os.path.join(HERE, *parts)
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """``workloads/<name>.json``: the cell's configuration, traffic and why."""
    return _json("workloads", f"{name}.json")


def config(name: str) -> dict:
    """``configs/<name>.json``: the camera, sensor and scene of a deployment."""
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    """``traffic/<name>.json``: the take length, the flags and the check's sample."""
    return _json("traffic", f"{name}.json")


def names(kind: str) -> list:
    """Every name of one kind (``workloads``, ``configs``, ``traffic``,
    ``metrics``), from the files present."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(f[: -len(suffix)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(suffix) and not f.startswith("_"))


def metric(name: str):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(cell_name: str, traced: bool, root: str = ROOT) -> list:
    """Names of the metrics a cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced (those whose ``workloads`` name it, or that
    have none)."""
    entries = manifest(root)["per_layer" if traced else "end_to_end"]
    return [m["name"] for m in entries if cell_name in m.get("workloads", [cell_name])]
