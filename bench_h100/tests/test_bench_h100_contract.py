"""BENCHMARK.json against the rules a benchmark file has to keep: its
keys, the characters of every name and unit, the bounds, the per-layer
metrics' `moves` and cells, and a file under `bench_h100/` for every
configuration, traffic mix, cell and per-layer metric it names."""

import ast
import json
import os
import re

import pytest

from bench_h100 import catalog

ROOT = catalog.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
BENCH = catalog.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_h100/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["workloads"]   # no inference
        if "roofline" in m["name"]:   # a kernel's share: <kernel>_roofline
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(w):
    cell = catalog.cell(w)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e   # a metric's cell reports what it moves
        assert os.path.isfile(os.path.join(
            ROOT, "bench_h100", "metrics", m["name"] + ".py"))
    assert cell.check["limits"]
    assert cell.traffic["kind"] in ("train", "score")


def test_every_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for f in files:
        with open(os.path.join(ROOT, f)) as fh:
            cfg = json.load(fh)
        assert cfg["dtype"] == "float32" and cfg["lstmp_layers"]


def test_no_harness_source_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "kaldi_lstm_tpu"}
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "bench_h100")):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & bad, (f, tops)
