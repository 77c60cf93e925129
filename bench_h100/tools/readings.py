#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, one JSON
line each: the numbers `correct` compares for

- program: sound runs of the program (the lower readings);
- bf16: the program's own lower precision, `set_matmul_dtype(bf16)`;
- tf32: the reference put in the program's place, one precision below
  float32 (TF32), against the reference in float32;
- half_batch (training cells): the program with half of each batch left
  out and the mean taken over the rest (faults.py).

    python3 bench_h100/tools/readings.py --workload train-google-f32 \
        --seeds 11,12,13 --seconds 3 --modes program,bf16,tf32,half_batch

All runs share one process (the kernels load once); each run makes its
own weights, feed and net.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tf32_numbers(cell, seed: int, device) -> dict:
    """The reference in TF32 against the reference in float32, on the
    cell's own check: the same batches or utterances a run compares."""
    from bench_h100 import checks, model, score_cell, traffic, train_cell
    from bench_h100.reference import lstmp as ref

    cfg, tr, chk = cell.config, cell.traffic, cell.check
    pool = traffic.make_pool(tr, cfg["input_dim"], cfg["num_pdfs"], seed,
                             group=tr.get("batch_utts", 1))
    weights = model.make_weights(cfg, seed, device,
                                 trained=tr["kind"] == "score")
    if tr["kind"] == "score":
        counts = traffic.class_counts(cfg["num_pdfs"], seed)
        feats = [pool.feats[i % len(pool.lengths)]
                 for i in sorted(score_cell.sampled(pool, chk, seed))]
        want = ref.score(weights, feats, counts, device)
        got = ref.score(weights, feats, counts, device, tf32=True)
        return {"score_gap": checks.score_gap(got, want,
                                              ref.log_priors(counts))}
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    it = iter(StreamScheduler(
        traffic.TrainSource(pool, seed), traffic.Targets(pool),
        cfg["input_dim"], num_stream=tr["streams"], batch_size=tr["tbptt"],
        targets_delay=tr["targets_delay"]))
    steps = sum(chk["epochs"])
    batches = [train_cell.for_reference(next(it)) for _ in range(steps)]
    args = (weights, batches, train_cell.epoch_starts(chk["epochs"]),
            tr["learn_rate"], tr["momentum"], device)
    snap = {chk["change_at"], steps}
    want = ref.train_steps(*args, snap_at=snap)
    got = ref.train_steps(*args, snap_at=snap, tf32=True)
    nums = checks.train_numbers(got, want, chk["change_at"])
    nums["change_gap.setup"] = checks.train_numbers(got, want,
                                                    steps)["change_gap"]
    return nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--modes", default="program,bf16,tf32")
    args = p.parse_args(argv)
    import contextlib

    import torch
    from bench_h100 import catalog, faults
    from bench_h100.run import run_cell

    cell = catalog.cell(args.workload)
    device = torch.device("cuda", 0)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            if mode == "tf32":
                nums, extra = tf32_numbers(cell, seed, device), {}
            else:
                plant = faults.TRAIN.get(mode) or faults.SCORE.get(mode)
                with plant() if plant else contextlib.nullcontext():
                    r, nums = run_cell(
                        cell, seed, args.seconds, False, device,
                        control="bf16" if mode == "bf16" else None, t0=t)
                extra = {"correct": r["correct"],
                         "metrics": {k: m["value"]
                                     for k, m in r["metrics"].items()}}
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "numbers": nums,
                              "seconds": time.perf_counter() - t, **extra}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
