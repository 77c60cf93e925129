"""Outer training recipe — the `train_lstm_streams.sh` equivalent, PyTorch
edition of ``kaldi_lstm_tpu.tools.run_recipe``: max_iters iterations of
train + cross-validate with learning-rate decay (lr *= halving_factor
once iter >= start_halving), per-iteration checkpoint files nnet.iterN
that double as resume points.

    python -m kaldi_lstm_tpu_torch.tools.run_recipe \\
        --tr-feats scp:tr/feats.scp --tr-targets ark:tr/post.ark \\
        --cv-feats scp:cv/feats.scp --cv-targets ark:cv/post.ark \\
        --proto nnet.proto --dir exp/lstm [--device cuda]

`--scheduler newbob` switches to upstream nnet1's train_scheduler.sh
logic instead of the fixed halving plan: an initial CV pass sets the
base loss; each iteration is ACCEPTED only if its CV AvgLoss improves
(rejected models are kept as nnet.iterN_rejected and the next iteration
restarts from the previous accepted model); halving starts when the
relative improvement drops below --start-halving-impr and training
stops when it drops below --end-halving-impr (newbob defaults 0.5 /
0.01 / 0.001, --min-iters/--keep-lr-iters honored); an iteration whose
CV loss blows up past --reject-blowup times the last one is rejected
even within --min-iters. Progress is journaled to <dir>/nnet/newbob.state
in the JAX tool's JSON format, so a run resumes in either package.

The port's `nnet_initialize` and `train_lstm_streams` run in this
process on ``--device`` (default cuda; cpu runs the plain path), with
``--step-group``, ``--bf16``, ``--verbose`` and the other trainer flags
passed on. ``--mesh`` and the multi-process flags pass on too: run one
recipe process per rank, each with its own ``--process-id``; rank 0
initializes the model and writes every file, the other ranks wait for
it. A mesh that does not match the process count exits 1 before any
file is written.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from kaldi_lstm_tpu_torch.tools import nnet_initialize, train_lstm_streams
from kaldi_lstm_tpu_torch.tools.train_lstm_streams import parse_mesh
from kaldi_lstm_tpu_torch.utils import LOG, device_from_arg

TOOL = "run-recipe"


class _TrainerFailed(Exception):
    def __init__(self, rc: int):
        super().__init__(rc)
        self.rc = rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LSTM multi-stream training "
                                "recipe (outer loop with LR halving)")
    p.add_argument("--tr-feats", required=True)
    p.add_argument("--tr-targets", required=True)
    p.add_argument("--cv-feats", required=True)
    p.add_argument("--cv-targets", required=True)
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--proto", default="", help="nnet.proto to initialize "
                   "from (if <dir>/nnet.init is absent)")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--learn-rate", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="passed to the trainer (per-element gradient "
                        "clip; 50 reproduces the standard variant)")
    p.add_argument("--num-stream", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--targets-delay", type=int, default=5)
    p.add_argument("--dump-interval", type=int, default=10000)
    p.add_argument("--max-iters", type=int, default=15)
    p.add_argument("--start-halving", type=int, default=3)
    p.add_argument("--halving-factor", type=float, default=None,
                   help="default 0.8 (fixed; train_lstm_streams.sh:13) "
                        "or 0.5 (newbob; train_scheduler.sh)")
    p.add_argument("--scheduler", choices=("fixed", "newbob"),
                   default="fixed",
                   help="fixed = the reference recipe's unconditional "
                        "halving plan; newbob = nnet1 train_scheduler.sh "
                        "accept/reject on CV loss")
    p.add_argument("--min-iters", type=int, default=0,
                   help="newbob: always accept/continue this many iters")
    p.add_argument("--keep-lr-iters", type=int, default=0,
                   help="newbob: don't halve before this many iters")
    p.add_argument("--start-halving-impr", type=float, default=0.01)
    p.add_argument("--end-halving-impr", type=float, default=0.001)
    p.add_argument("--reject-blowup", type=float, default=2.0,
                   help="newbob: reject an iteration whose CV loss "
                        "exceeds this factor of the previous loss even "
                        "within min/keep-lr iters (a diverged epoch "
                        "must not become the training base; upstream "
                        "train_scheduler.sh force-accepts). 0 = exact "
                        "upstream behavior")
    p.add_argument("--step-group", type=int, default=1,
                   help="passed to the trainer: batches per grouped step "
                        "(one CUDA-graph replay on the card)")
    p.add_argument("--bf16", default="false",
                   help="passed to the trainer: bfloat16 matmul inputs "
                        "with float32 accumulation (true|false)")
    p.add_argument("--mesh", default="",
                   help="passed to the trainer: sharded training over a "
                        "'data=D[,model=M]' mesh of processes")
    p.add_argument("--sync-every", type=int, default=8,
                   help="passed to the trainer with --mesh (continue-flag "
                        "agreement cadence)")
    p.add_argument("--fused-xent", default="auto",
                   help="passed to the trainer with --mesh "
                        "(auto|true|false)")
    p.add_argument("--coordinator-address", default="",
                   help="multi-process run: rank 0's host:port (run one "
                        "recipe process per rank)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="passed to nnet_initialize and the trainer: cuda "
                        "(default) or cpu")
    return p


def _valid_nnet(path: str) -> bool:
    """A killed run typically leaves a ZERO-BYTE model (opened, never
    flushed); resuming from it would fail deep in the trainer. Only the
    cheap emptiness check here — a full parse would reject the stub
    models the scheduler tests drive with."""
    if not os.path.exists(path):
        return False
    if os.path.getsize(path) == 0:
        LOG(f"WARNING: {path} is empty (left by a killed run?), "
            "regenerating")
        return False
    return True


def _mesh_error(args) -> str | None:
    """Why the mesh flags cannot run, checked before any file is
    written: a bad spec, a mesh without the matching process count, or
    several processes without a mesh."""
    world = (args.num_processes if args.num_processes > 1
             else int(os.environ.get("WORLD_SIZE", "1")))
    if not args.mesh:
        return ("multi-process training needs --mesh data=D[,model=M]"
                if world > 1 or args.coordinator_address else None)
    try:
        axes = parse_mesh(args.mesh)
    except ValueError as e:
        return str(e)
    n = axes["data"] * axes["model"]
    if n != world:
        return (f"mesh {axes['data']}x{axes['model']} needs {n} "
                f"devices, have {world} process(es)")
    return None


def _wait_for(path: str, rank: int, timeout: float = 600.0) -> None:
    """A rank other than 0 polls for a file that rank 0 creates before
    the first trainer call (after that, the trainer's own post-write
    barrier orders every model file)."""
    t0 = time.time()
    while not (os.path.exists(path) and os.path.getsize(path) > 0):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"rank {rank}: {path} not created by "
                               f"rank 0")
        time.sleep(0.2)


def _train(argv: list) -> None:
    rc = train_lstm_streams.main(argv)
    if rc != 0:
        raise _TrainerFailed(rc)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.halving_factor is None:
        args.halving_factor = 0.5 if args.scheduler == "newbob" else 0.8

    common = [
        f"--feature-transform={args.feature_transform}",
        f"--momentum={args.momentum}",
        f"--grad-clip={args.grad_clip}",
        f"--num-stream={args.num_stream}",
        f"--batch-size={args.batch_size}",
        f"--targets-delay={args.targets_delay}",
        f"--dump-interval={args.dump_interval}",
        f"--step-group={args.step_group}",
        f"--bf16={args.bf16}",
        f"--verbose={args.verbose}",
        f"--device={args.device}",
    ]
    if args.mesh:
        common += [f"--mesh={args.mesh}",
                   f"--sync-every={args.sync_every}",
                   f"--fused-xent={args.fused_xent}"]
    if args.num_processes > 1:
        common += [f"--coordinator-address={args.coordinator_address}",
                   f"--num-processes={args.num_processes}",
                   f"--process-id={args.process_id}"]
    msg = _mesh_error(args)
    if msg is not None:
        print(f"{TOOL}: {msg}", file=sys.stderr)
        return 1
    if device_from_arg(args.device, TOOL) is None:
        return 1
    args.rank0 = args.num_processes <= 1 or args.process_id == 0

    d = args.dir
    os.makedirs(f"{d}/log", exist_ok=True)
    os.makedirs(f"{d}/nnet", exist_ok=True)
    nnet_init = f"{d}/nnet.init"
    iter0 = f"{d}/nnet/nnet.iter0"
    if not args.rank0:
        _wait_for(nnet_init, args.process_id)
        _wait_for(iter0, args.process_id)
    else:
        if not _valid_nnet(nnet_init):
            if not args.proto:
                print("error: no nnet.init and no --proto given",
                      file=sys.stderr)
                return 1
            LOG("Initializing lstm")
            rc = nnet_initialize.main([args.proto, nnet_init,
                                       f"--device={args.device}"])
            if rc != 0:
                return rc
        if not _valid_nnet(iter0):
            shutil.copy(nnet_init, iter0)

    try:
        if args.scheduler == "newbob":
            return _newbob(args, d, common, args.learn_rate)
        return _fixed(args, d, common, args.learn_rate)
    except _TrainerFailed as e:
        return e.rc


def _fixed(args, d: str, common: list, learn_rate: float) -> int:
    it = 0
    # resume: skip iterations whose output model already exists (and is
    # not a zero-byte leftover of a killed run — same check as iter0)
    while it < args.max_iters and \
            _valid_nnet(f"{d}/nnet/nnet.iter{it + 1}"):
        if it >= args.start_halving:
            learn_rate *= args.halving_factor
        LOG(f"iteration {it + 1} already done, skipping")
        it += 1

    while it < args.max_iters:
        if it >= args.start_halving:
            learn_rate *= args.halving_factor
        cur = f"{d}/nnet/nnet.iter{it}"
        nxt = f"{d}/nnet/nnet.iter{it + 1}"
        LOG(f"=== iteration {it + 1}/{args.max_iters}, "
            f"learn_rate {learn_rate:g}")
        _train([args.tr_feats, args.tr_targets, cur, nxt,
                f"--learn-rate={learn_rate}"] + common)
        _train([args.cv_feats, args.cv_targets, nxt,
                "--cross-validate=true", f"--learn-rate={learn_rate}"]
               + common)
        it += 1

    final = f"{d}/nnet/nnet.iter{args.max_iters}"
    LOG(f"training finished, final model: {final}")
    return 0


def _newbob(args, d: str, common: list, learn_rate: float) -> int:
    """nnet1 train_scheduler.sh: initial CV -> iterate (train, CV),
    accept iff CV AvgLoss improved (else restart from the previous
    accepted model), halve once relative improvement < start_halving_impr,
    stop once < end_halving_impr (both only after min_iters). Progress is
    journaled to <dir>/nnet/newbob.state (JSON) after every iteration so
    a killed run resumes from the last completed iteration."""

    def cv(model: str) -> float:
        rc, stats = train_lstm_streams.run_main(
            [args.cv_feats, args.cv_targets, model,
             "--cross-validate=true"] + common)
        if rc != 0 or stats is None:
            raise _TrainerFailed(rc or 1)
        return stats.avg_loss()

    state_file = f"{d}/nnet/newbob.state"
    start_iter = 1
    halving = False
    if os.path.exists(state_file):
        with open(state_file) as f:
            st = json.load(f)
        start_iter = st["iter"] + 1
        loss, halving = st["loss"], st["halving"]
        learn_rate, cur, final = st["learn_rate"], st["cur"], st["final"]
        LOG(f"resuming newbob from iteration {start_iter} "
            f"(AvgLoss {loss:.6f}, lr {learn_rate:g}, "
            f"halving {halving})")
    else:
        cur = f"{d}/nnet/nnet.iter0"
        loss = cv(cur)
        LOG(f"### PREPARE CROSS-VALIDATION: AvgLoss {loss:.6f}")
        final = cur

    def save_state(it):
        if not args.rank0:
            return
        with open(state_file, "w") as f:
            json.dump({"iter": it, "loss": loss, "halving": halving,
                       "learn_rate": learn_rate, "cur": cur,
                       "final": final}, f)

    for it in range(start_iter, args.max_iters + 1):
        nxt = f"{d}/nnet/nnet.iter{it}"
        LOG(f"### ITERATION {it}/{args.max_iters}, learn_rate "
            f"{learn_rate:g}{' (halving)' if halving else ''}")
        _train([args.tr_feats, args.tr_targets, cur, nxt,
                f"--learn-rate={learn_rate}"] + common)
        loss_new = cv(nxt)
        loss_prev = loss
        # Divergence guard beyond upstream: train_scheduler.sh
        # force-accepts within min/keep iters even when CV got WORSE, so
        # a diverged iteration would become the base of all later
        # training. A blowup is rejected unconditionally; halving then
        # retries from the last GOOD model at a lower rate.
        blowup = (args.reject_blowup > 0
                  and loss_new > args.reject_blowup * max(loss, 1e-10))
        if blowup:
            LOG(f"nnet REJECTED on blowup ({os.path.basename(nxt)}): "
                f"AvgLoss {loss_new:.6f} > {args.reject_blowup:g} x "
                f"{loss:.6f} — diverged iteration, keeping "
                f"{os.path.basename(cur)}")
        if not blowup and (loss_new < loss or it <= args.keep_lr_iters
                           or it <= args.min_iters):
            # accept
            loss = loss_new
            cur = final = nxt
            LOG(f"nnet accepted ({os.path.basename(nxt)}), "
                f"AvgLoss {loss_new:.6f}")
        else:
            if args.rank0:
                shutil.move(nxt, nxt + "_rejected")
            LOG(f"nnet rejected ({os.path.basename(nxt)}), "
                f"AvgLoss {loss_new:.6f} > {loss:.6f}")
        # stopping criterion
        rel_impr = (loss_prev - loss_new) / max(abs(loss_prev), 1e-20)
        if halving and rel_impr < args.end_halving_impr:
            if it <= args.min_iters:
                LOG(f"we were supposed to finish, but we continue as "
                    f"min_iters : {args.min_iters}")
                save_state(it)
                continue
            LOG(f"finished, too small rel. improvement {rel_impr:g}")
            break
        # start learning-rate halving
        if rel_impr < args.start_halving_impr and it > args.keep_lr_iters:
            halving = True
        if halving:
            learn_rate *= args.halving_factor
        save_state(it)
    if args.rank0:
        shutil.copy(final, f"{d}/final.nnet")
    LOG(f"training finished, final model: {d}/final.nnet "
        f"(= {os.path.basename(final)}), CV AvgLoss {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
