"""Multi-stream truncated-BPTT trainer CLI, PyTorch edition of
``kaldi_lstm_tpu.tools.train_lstm_streams`` (upstream
`bd-nnet-train-lstm-streams`):

    train_lstm_streams [options] <feature-rspecifier> <targets-rspecifier>
                       <model-in> [<model-out>]

e.g.  python -m kaldi_lstm_tpu_torch.tools.train_lstm_streams \\
          scp:feats.scp ark:post.ark nnet.init nnet.iter1

Same arguments and log lines as the JAX tool, plus ``--device`` (default
cuda; exits 1 when CUDA is missing; ``--device cpu`` runs the plain
PyTorch path). ``--fused-xent`` keeps its meaning: auto = on for CUDA,
false = the unfused torch loss by the user's choice. Flags whose
machinery is not ported yet exit 1 with the ROADMAP item that adds it:
``--mesh`` and the multi-process flags, ``--step-group`` > 1,
``--bf16 true``, ``--debug-dump``, ``--profile-dir``.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    RandomAccessPosteriorReader,
    SequentialMatrixReader,
    read_float_vectors,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch
from kaldi_lstm_tpu_torch.utils import (
    LOG,
    WARN,
    device_from_arg,
    set_verbose_level,
)

TOOL = "train-lstm-streams"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Perform one iteration of LSTM training by "
                    "Stochastic Gradient Descent (multi-stream "
                    "truncated BPTT).")
    p.add_argument("feature_rspecifier")
    p.add_argument("targets_rspecifier")
    p.add_argument("model_in")
    p.add_argument("model_out", nargs="?", default=None)
    p.add_argument("--binary", default="true",
                   help="Write output in binary mode (true|false)")
    p.add_argument("--cross-validate", default="false",
                   help="Perform cross-validation (don't backpropagate)")
    p.add_argument("--feature-transform", default="",
                   help="Feature transform in Nnet format")
    p.add_argument("--objective-function", default="xent",
                   help="Objective function : xent|mse")
    p.add_argument("--learn-rate", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--l1-penalty", type=float, default=0.0,
                   help="L1 penalty (lassoo) scaled by num-frames "
                        "(upstream NnetTrainOptions)")
    p.add_argument("--l2-penalty", type=float, default=0.0,
                   help="L2 penalty (weight decay) scaled by num-frames "
                        "(upstream NnetTrainOptions)")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="Element-wise gradient clip (50 reproduces the "
                        "standard-variant behaviour)")
    p.add_argument("--targets-delay", type=int, default=5,
                   help="---LSTM--- BPTT targets delay")
    p.add_argument("--batch-size", type=int, default=20,
                   help="---LSTM--- BPTT batch size (Tbptt)")
    p.add_argument("--num-stream", type=int, default=4,
                   help="---LSTM--- BPTT multi-stream training")
    p.add_argument("--max-post-entries", type=int, default=1,
                   help="Sparse-target width Kmax per frame (1 covers "
                        "ali-to-post 1-best targets; raise for soft "
                        "posteriors from lattice-to-post / sum-post)")
    p.add_argument("--dump-interval", type=int, default=50000,
                   help="---LSTM--- num utts between model dumping")
    p.add_argument("--step-group", type=int, default=1,
                   help="Batches per device dispatch; only 1 is ported "
                        "(the grouped step is ROADMAP queue A item 10)")
    p.add_argument("--mesh", default="",
                   help="Multi-chip sharded training 'data=D[,model=M]'; "
                        "not ported (ROADMAP queue A item 8)")
    p.add_argument("--sync-every", type=int, default=8,
                   help="With --mesh: steps between the cross-host "
                        "continue-flag agreements (not ported)")
    p.add_argument("--fused-xent", default="auto",
                   choices=("auto", "true", "false"),
                   help="Fuse senone affine+softmax+xent into the K3/K4 "
                        "kernels (auto = on for CUDA; false = the unfused "
                        "torch loss)")
    p.add_argument("--coordinator-address", default="",
                   help="Multi-process coordinator host:port; not ported "
                        "(ROADMAP queue A item 8)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="Multi-process: total process count (0 = single "
                        "process; more is ROADMAP queue A item 8)")
    p.add_argument("--process-id", type=int, default=0,
                   help="Multi-process: this process's rank")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--state-in", default="",
                   help="Resume full train state (params + momentum) from "
                        "a .npz written by --state-out (either package)")
    p.add_argument("--state-out", default="",
                   help="Write full train state (params + momentum) for "
                        "exact resume")
    p.add_argument("--bf16", default="false",
                   help="bfloat16 matmul inputs; only false is ported "
                        "(ROADMAP queue A item 5)")
    p.add_argument("--debug-dump", default="",
                   help="Dump per-frame LSTM activations of the first "
                        "minibatch; not ported (ROADMAP queue A item 11)")
    p.add_argument("--profile-dir", default="",
                   help="Write a profiler trace of the steady-state "
                        "steps; not ported (ROADMAP queue A item 12)")
    p.add_argument("--frame-weights", default="",
                   help="Per-frame weights (ark: float-vector table) to "
                        "scale gradients")
    p.add_argument("--device", default="cuda",
                   help="Device to train on: cuda (default, exits 1 when "
                        "CUDA is missing) or cpu")
    # dummy options for script compatibility (reference :65-69)
    p.add_argument("--randomize", default="false", help="Dummy option, "
                   "for compatibility")
    p.add_argument("--length-tolerance", type=int, default=5,
                   help="Dummy option, for compatibility")
    p.add_argument("--use-gpu", default="yes", help="Dummy option (the "
                   "device is --device)")
    return p


def _bool(s: str) -> bool:
    return str(s).lower() in ("true", "1", "yes")


def _unported(args) -> str | None:
    """The message for a flag whose machinery is a later slice."""
    if args.mesh:
        return "--mesh: sharded training is ROADMAP queue A item 8"
    if args.coordinator_address or args.num_processes > 1:
        return ("multi-process training (--coordinator-address, "
                "--num-processes) is ROADMAP queue A item 8")
    if args.step_group > 1:
        return ("--step-group > 1: the grouped step (a CUDA-graph "
                "capture) is ROADMAP queue A item 10")
    if _bool(args.bf16):
        return "--bf16 true: bfloat16 kernels are ROADMAP queue A item 5"
    if args.debug_dump:
        return "--debug-dump is ROADMAP queue A item 11"
    if args.profile_dir:
        return "--profile-dir is ROADMAP queue A item 12"
    return None


def run_main(argv=None):
    """main() that also returns the epoch's LossStats (None on argument
    errors): the recipe's newbob scheduler reads the CV AvgLoss."""
    out: list = []
    rc = main(argv, out)
    return rc, (out[0] if out else None)


def main(argv=None, _stats_out=None) -> int:
    args = build_parser().parse_args(argv)
    msg = _unported(args)
    if msg is not None:
        print(f"{TOOL}: {msg}; not in this port yet", file=sys.stderr)
        return 1
    set_verbose_level(args.verbose)
    if args.verbose >= 1:
        WARN("--verbose >= 1: the first-minibatch moment dumps are ROADMAP "
             "queue A item 11; only the progress logs are printed")
    crossvalidate = _bool(args.cross_validate)
    if not crossvalidate and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1

    transf = transf_params = None
    if args.feature_transform:
        transf, transf_params = Nnet.read(args.feature_transform, device)
    nnet, params = Nnet.read(args.model_in, device)
    fused = None if args.fused_xent == "auto" else _bool(args.fused_xent)
    opts = TrainOptions(learn_rate=args.learn_rate, momentum=args.momentum,
                        grad_clip=args.grad_clip,
                        l1_penalty=args.l1_penalty,
                        l2_penalty=args.l2_penalty,
                        objective=args.objective_function,
                        fused_xent=fused)

    LOG(("CROSS-VALIDATION" if crossvalidate else "TRAINING") + " STARTED")

    feats = SequentialMatrixReader(args.feature_rspecifier)
    targets = RandomAccessPosteriorReader(args.targets_rspecifier,
                                          max_entries=args.max_post_entries)
    frame_weights = None
    if args.frame_weights:
        frame_weights = read_float_vectors(args.frame_weights)
    scheduler = StreamScheduler(
        iter(feats), targets, feat_dim=nnet.input_dim,
        num_stream=args.num_stream, batch_size=args.batch_size,
        targets_delay=args.targets_delay, warn=WARN,
        max_entries=args.max_post_entries,
        frame_weights=frame_weights)

    def dump(p, num_done):
        name = f"{args.model_out}_utt{num_done}"
        nnet.write(name, p, binary=_bool(args.binary))
        LOG(f"dumped model to {name}")

    opt_state = None
    if args.state_in:
        from kaldi_lstm_tpu_torch.train.checkpoint import load_train_state
        params, opt_state, meta = load_train_state(args.state_in, params,
                                                   device)
        LOG(f"resumed train state from {args.state_in} (meta: {meta})")

    res = run_epoch(nnet, params, scheduler, opts,
                    transf=transf, transf_params=transf_params,
                    crossvalidate=crossvalidate, opt_state=opt_state,
                    dump_interval=args.dump_interval, dump_fn=dump)

    if not crossvalidate:
        nnet.write(args.model_out, res.params, binary=_bool(args.binary))
        if args.state_out:
            from kaldi_lstm_tpu_torch.train.checkpoint import \
                save_train_state
            save_train_state(args.state_out, res.params, res.opt_state,
                             meta={"learn_rate": args.learn_rate,
                                   "num_done": scheduler.num_done})
            LOG(f"wrote train state to {args.state_out}")

    LOG(f"Done {scheduler.num_done} files, {scheduler.num_no_tgt_mat} with "
        f"no tgt_mats, {scheduler.num_other_error} with other errors. "
        f"[{'CROSS-VALIDATION' if crossvalidate else 'TRAINING'}, "
        f"{res.elapsed / 60:.2f} min, "
        f"fps{res.total_frames / max(res.elapsed, 1e-9):.0f}]")
    LOG(res.stats.report())
    if _stats_out is not None:
        _stats_out.append(res.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
