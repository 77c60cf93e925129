"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries of BENCHMARK.json), with no edit to any file of
the harness, are found by name and run."""

import json
import os
import shutil
import time

import torch

from bench_h100 import catalog
from bench_h100.run import run_cell
from bench_h100.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(catalog.ROOT, "bench_h100"),
                    os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = catalog.benchmark()
    here = os.path.join(root, "bench_h100")
    with open(os.path.join(here, "configs", "tiny_lstmp.json"), "w") as f:
        json.dump(dict(tiny.CONFIG, dtype="float32"), f)
    with open(os.path.join(here, "traffic", "tiny_train.json"), "w") as f:
        json.dump(tiny.TRAIN, f)
    with open(os.path.join(here, "workloads", "tiny-train.json"), "w") as f:
        json.dump(tiny.TRAIN_CHECK, f)
    with open(os.path.join(here, "metrics", "steps.tiny.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['step_frames']))\n")
    bench["configs"].append({"name": "tiny_lstmp", "source": "a test",
                             "file": "bench_h100/configs/tiny_lstmp.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-train", "config": "tiny_lstmp",
                               "traffic": "tiny_train", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps.tiny", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "Epoch driver",
                               "moves": "train_frames_per_s",
                               "workloads": ["tiny-train"]})
    bench["end_to_end"][0]["workloads"].append("tiny-train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = catalog.cell("tiny-train", root)
    assert cell.config["input_dim"] == tiny.CONFIG["input_dim"]
    assert cell.traffic == tiny.TRAIN and cell.check == tiny.TRAIN_CHECK
    assert "steps.tiny" in [m["name"] for m in cell.per_layer]
    assert "steps.tiny" not in [
        m["name"] for m in catalog.cell("train-google-f32", root).per_layer]
    result, _ = run_cell(cell, 7, 0.3, True, torch.device("cpu"),
                         t0=time.perf_counter(), root=root)
    assert result["correct"]
    assert result["metrics"]["steps.tiny"]["value"] == result["attempted"]
