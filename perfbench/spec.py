"""What ``BENCHMARK.json`` names, found by name under ``perfbench/``.

A configuration is the file its ``configs`` entry names, a traffic mix
is ``perfbench/traffic/<traffic>.json`` (it names its kind of unit,
``perfbench/units/<unit>.py``), and every metric, end to end or per
layer, is read by ``perfbench/metrics/<name>.py``'s ``read(ctx)``.
Adding a cell, a configuration, a mix, a kind of unit or a metric adds
files and entries; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    """The configuration's file, with its ``panel_file`` (if any) made a
    path from ``root``."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                cfg = json.load(f)
            if "panel_file" in cfg:
                cfg["panel_file"] = os.path.join(root, cfg["panel_file"])
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    whose ``workloads`` list names it, or that have no such list."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``: a number, or None where
    the run gives it nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
