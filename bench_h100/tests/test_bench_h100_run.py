"""A run of each kind of cell at a tiny size on the CPU: the plain
reference agrees with the port's CPU path, and each fault planted in
the timed path turns `correct` false. The look for a card is skipped:
`run_cell` is the run below it."""

import json
import subprocess
import sys
import time

import pytest
import torch

from bench_h100 import faults
from bench_h100.run import FORBIDDEN, ROOT, run_cell
from bench_h100.tests import tiny

SEED = 2**31 + 17   # the driver's seeds pass 32 signed bits
CPU = torch.device("cpu")


def _run(kind, trace=False, layers=1, seed=SEED, control=None):
    return run_cell(tiny.cell(kind, layers), seed, 0.3, trace, CPU,
                    control=control, t0=time.perf_counter())


@pytest.mark.parametrize("kind,layers", [("train", 1), ("train", 2),
                                         ("score", 1), ("score", 2)])
def test_reference_agrees_with_the_cpu_path(kind, layers):
    result, numbers = _run(kind, layers=layers)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {"train": {"train_frames_per_s", "setup_s"},
           "score": {"score_audio_s_per_s", "score_p95_ms", "setup_s"}}
    assert set(result["metrics"]) == e2e[kind]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", ["train", "score"])
def test_traced_run_reads_per_layer_metrics(kind):
    result, _ = _run(kind, trace=True)
    assert result["correct"]
    assert "busy_s" in result["device"] and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU runs no kernel: readers of device time find nothing
    assert "lstm_train_roofline" not in result["metrics"]
    assert "lstm_infer_roofline" not in result["metrics"]
    assert f"idle_share.{kind}" in result["metrics"]


def test_seeds_give_the_same_inputs():
    a, _ = _run("score")
    b, _ = _run("score")
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("kind,fault", [
    ("train", "state_unchanged"), ("train", "half_batch"),
    ("score", "half_utterances"), ("score", "answer_altered")])
def test_planted_fault_is_not_correct(kind, fault):
    plant = {**faults.TRAIN, **faults.SCORE}[fault]
    with plant():
        result, numbers = _run(kind)
    assert not result["correct"], (fault, numbers)


def test_lower_precision_control_is_not_correct():
    """The program's own bf16 path in place of its float32 one."""
    for kind in ("train", "score"):
        result, numbers = _run(kind, control="bf16")
        assert not result["correct"], (kind, numbers)


def test_no_run_loads_jax_or_the_jax_package():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from bench_h100.run import run_cell, forbidden_modules\n"
        "from bench_h100 import catalog\n"
        "from bench_h100.tests import tiny\n"
        "for kind in ('train', 'score'):\n"
        "    run_cell(tiny.cell(kind), 5, 0.2, True, torch.device('cpu'),\n"
        "             t0=time.perf_counter())\n"
        "for m in catalog.benchmark()['per_layer']:\n"
        "    catalog.reader(m['name'])\n"
        "import bench_h100.tools.readings, bench_h100.faults\n"
        "print(forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]
                      .replace("'", '"')) == []
    assert FORBIDDEN == {"jax", "jaxlib", "flax", "kaldi_lstm_tpu"}


def test_command_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "train-google-f32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["train-google-f32", "score-deep-f32",
                                  "train-deep-f32", "score-google-f32"])
def test_control_fails_on_the_card(cell):
    """The control at the cell's own size on the card: the program's
    bf16 path, and the reference put in its place in TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_h100 import catalog
    from bench_h100.checks import judge
    from bench_h100.tools.readings import tf32_numbers
    c = catalog.cell(cell)
    dev = torch.device("cuda", 0)
    result, _ = run_cell(c, SEED, 3, False, dev, control="bf16",
                         t0=time.perf_counter())
    assert not result["correct"]
    ok, _ = judge(tf32_numbers(c, SEED, dev),
                  {k: v for k, v in c.check["limits"].items()
                   if k not in ("frames_gap", "plain_calls", "missing")})
    assert not ok
