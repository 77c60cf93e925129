#!/usr/bin/env python3
"""Run one cell of the benchmark of `kaldi_lstm_tpu_torch` once.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights on the card from the seed, the utterance pool on the
host, the kernels built or loaded from the package's `_build/`, the
cell's warm-up and the set-up steps of its check) is timed from the
start of this process to the start of the window. The window runs the
cell's entry for `--seconds`; with `--trace 1` under torch.profiler,
and the cell's per-layer metrics are read from that trace and the
program's counters instead of its end-to-end ones. After the window
the device's memory peak is read, the program's state is freed and the
plain reference (`reference/`) decides `correct`.

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the JAX package and JAX itself, by top-level module name
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "kaldi_lstm_tpu"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_window(device, trace: bool, t0: float):
    """window(fn): run fn() as the measured window and return its span:
    seconds, set-up seconds before it, the program's counters' change
    and, when traced, the reduced trace."""
    import torch
    from kaldi_lstm_tpu_torch.ops.counts import snapshot_counts
    from bench_h100 import yardstick as ys

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def window(fn):
        sync()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        c0 = snapshot_counts()
        t_start = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(ys.WINDOW_MARK):
                fn()
                sync()
        else:
            fn()
            sync()
        t_end = time.perf_counter()
        c1 = snapshot_counts()
        span = {"seconds": t_end - t_start, "setup_s": t_start - t0,
                "counts": {k: c1[k] - c0[k] for k in c1}, "trace": None}
        if prof is not None:
            t = time.perf_counter()
            prof.__exit__(None, None, None)
            dev, host = ys.trace_from_profiler(prof)
            print(f"trace: {len(dev)} device and {len(host)} host events "
                  f"read in {time.perf_counter() - t:.1f} s", file=sys.stderr)
            mark = [h for h in host if h.name == ys.WINDOW_MARK]
            t_a = mark[0].start if mark else min(d.start for d in dev)
            t_b = mark[0].end if mark else max(d.end for d in dev)
            span["trace"] = ys.Trace(dev, host, t_a, t_b)
        return span

    return window


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control=None, t0: float = T0, root: str = ROOT):
    """One run of `cell` on `device`: (the result the command prints,
    every number the reference gave, compared or not)."""
    import torch
    from kaldi_lstm_tpu_torch.ops.counts import snapshot_counts
    from bench_h100 import catalog, checks, score_cell, train_cell
    from bench_h100 import yardstick as ys

    cuda = device.type == "cuda"
    runner = {"train": train_cell, "score": score_cell}[
        cell.traffic["kind"]]
    before = snapshot_counts()
    out = runner.run(cell, seed, seconds, make_window(device, trace, t0),
                     device, control)
    span = out["span"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    numbers = out["reference"]()
    after = snapshot_counts()
    if cuda:  # on the CPU every call takes a plain version
        numbers["plain_calls"] = float(sum(
            after[k] - before[k] for k in after if k.startswith("plain.")))
    limits = {k: v for k, v in cell.check["limits"].items()
              if cuda or k != "plain_calls"}
    ok, checked = checks.judge(numbers, limits)
    for part, sec in out["setup_parts"].items():
        print(f"setup {part} {sec:.3f} s", file=sys.stderr)

    metrics = {}
    e2e = dict(out["e2e"], setup_s=span["setup_s"])
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        tr = span["trace"]
        ctx = dict(out["ctx"], kind=cell.traffic["kind"], config=cell.config,
                   traffic=cell.traffic, trace=tr, counts=span["counts"],
                   window_s=tr.window_s)
        for m in cell.per_layer:
            v = catalog.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        tr = span["trace"]
        dev["busy_s"] = ys.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": ys.top_device_ops(tr),
                               "idle_gaps": ys.idle_gaps(tr)}
    result["checks"] = checked
    return result, numbers


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from bench_h100 import catalog

    cell = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.version.cuda is None:
        print("no CUDA device: the benchmark runs on NVIDIA GPUs only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if "NVIDIA" not in torch.cuda.get_device_name(device):
        print(f"not an NVIDIA GPU: {torch.cuda.get_device_name(device)}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may import neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
