"""Find a cell's parts by name: `BENCHMARK.json` at the checkout's root
names the cells, configurations and metrics; each part is a file of
its own under `bench_h100/`, found by that name, so a new
configuration, traffic mix, cell or per-layer metric is a new file and
an entry in `BENCHMARK.json`, with no edit to any file here.

    configs/<config>.json     the model's sizes (the entry's `file`)
    traffic/<traffic>.json    the mix's parameters (traffic.py reads it)
    workloads/<cell>.json     how `correct` is decided: the check's
                              sizes and each compared number's limit
    metrics/<metric>.py       a per-layer metric's reader, read(ctx)
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    b = benchmark(root)
    w = {c["name"]: c for c in b["workloads"]}
    if name not in w:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(w)}")
    entry = w[name]
    conf = {c["name"]: c for c in b["configs"]}[entry["config"]]
    bench_dir = os.path.join(root, "bench_h100")
    # the cells an entry lists; an end-to-end entry with no list: all
    e2e = [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in b["per_layer"] if name in m["workloads"]]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_load(os.path.join(root, conf["file"])),
        traffic=_load(os.path.join(bench_dir, "traffic",
                                   entry["traffic"] + ".json")),
        check=_load(os.path.join(bench_dir, "workloads", name + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = os.path.join(root, "bench_h100", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
