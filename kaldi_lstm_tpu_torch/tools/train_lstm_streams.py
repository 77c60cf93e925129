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
false = the unfused torch loss by the user's choice. ``--step-group N``
runs N steps per CUDA-graph replay on the card (a loop on the CPU),
``--verbose 1`` prints the first-minibatch moment dumps, ``--debug-dump
DIR`` the per-frame LSTM dumps of ``tools/nnet_debug_dump.py`` before
training, and ``--profile-dir DIR`` writes a torch.profiler trace of the
training epoch. ``--bf16 true`` sets the net's (and the feature
transform's) matmul dtype to bfloat16 (``Nnet.set_matmul_dtype``): every
product of the training and cross-validation passes rounds its operands
to bf16 and sums in float32, on the bf16 kernels on the card.

``--mesh data=D[,model=M]`` trains sharded (``parallel/``) over a world
of exactly D x M processes, joined by ``--coordinator-address host:port
--num-processes N --process-id I`` (or torchrun's environment); each
process reads its own shard of the corpus with ``--num-stream`` streams
(the M processes of one data position read the same shard), rank 0
writes the model. Under ``--device cuda`` the rank of local index i on
its host takes card i mod the host's card count; NCCL joins the ranks
where each rank of a host has a card of its own, gloo otherwise (the
CPU, or two ranks of a host on one card).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

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
                   help="Batches per grouped step: one CUDA-graph replay "
                        "of that many steps on the card (identical math; "
                        "takes the per-launch host cost out of the step "
                        "loop), a loop on the CPU")
    p.add_argument("--mesh", default="",
                   help="Sharded training 'data=D[,model=M]' over D x M "
                        "processes: streams shard over 'data' (gradients "
                        "summed over the data ranks), the senone output "
                        "layer over 'model' (the tensor-parallel loss). "
                        "--num-stream is the PER-PROCESS stream count. "
                        "Empty = single-device path.")
    p.add_argument("--sync-every", type=int, default=8,
                   help="With --mesh: steps between the cross-process "
                        "continue-flag agreements of the SyncedScheduler "
                        "(locally exhausted processes pad with fully "
                        "masked filler batches in between)")
    p.add_argument("--fused-xent", default="auto",
                   choices=("auto", "true", "false"),
                   help="Fuse senone affine+softmax+xent into the K3/K4 "
                        "kernels (auto = on for CUDA; false = the unfused "
                        "torch loss)")
    p.add_argument("--coordinator-address", default="",
                   help="Multi-process: host:port of rank 0's "
                        "torch.distributed store (every process passes "
                        "the same address; empty = single process, or "
                        "torchrun's environment)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="Multi-process: total process count (0 = single "
                        "process)")
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
                   help="bfloat16 matmul inputs with float32 accumulation "
                        "(true|false)")
    p.add_argument("--debug-dump", default="",
                   help="directory: before training, dump per-frame LSTM "
                        "activations/derivatives for the first minibatch "
                        "(the reference's int DEBUG blocks, "
                        "bd-nnet-lstm-projected-streams.h:314-324)")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler trace (Chrome trace JSON) "
                        "of the training epoch to this directory")
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


def parse_mesh(spec: str) -> dict:
    """'data=4,model=2' -> {'data': 4, 'model': 2} (model defaults 1)."""
    out = {"data": 1, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k not in out or not v.isdigit() or int(v) < 1:
            raise ValueError(f"bad --mesh entry {part!r} "
                             f"(want data=D[,model=M])")
        out[k] = int(v)
    return out


def multiprocess_requested(args) -> bool:
    """True when the flags (or torchrun's environment) ask for several
    processes."""
    return bool(args.coordinator_address or args.num_processes > 1
                or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def _reads_stdin(rspec: str) -> bool:
    # 'ark:-', 'ark,t:-', 'scp:-', bare '-' all map to sys.stdin
    return rspec == "-" or rspec.rsplit(":", 1)[-1] == "-"


def _start_profiler(device):
    """A torch.profiler run over the training epoch (the CPU side,
    and the card's kernels and copies on CUDA). The card is idle when it
    starts (the set-up's copies done), so the trace holds the epoch's
    work and nothing before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    profiler = profile(activities=acts)
    profiler.start()
    return profiler


def _stop_profiler(profiler, directory: str, device) -> str:
    """Stop the profiler and write its Chrome trace into `directory`,
    after the card has finished the epoch's kernels (the profiler
    collects only the records of kernels that have completed)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{TOOL}.{os.getpid()}.pt.trace.json")
    profiler.export_chrome_trace(path)
    return path


def run_main(argv=None):
    """main() that also returns the epoch's LossStats (None on argument
    errors): the recipe's newbob scheduler reads the CV AvgLoss."""
    out: list = []
    rc = main(argv, out)
    return rc, (out[0] if out else None)


def main(argv=None, _stats_out=None) -> int:
    args = build_parser().parse_args(argv)
    if args.step_group < 1:
        print(f"{TOOL}: --step-group must be >= 1", file=sys.stderr)
        return 1
    set_verbose_level(args.verbose)
    crossvalidate = _bool(args.cross_validate)
    if not crossvalidate and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1
    plan = None
    rank0 = True
    if multiprocess_requested(args):
        if not args.mesh:
            raise ValueError("multi-process training needs --mesh "
                             "data=D[,model=M] over its processes")
        from kaldi_lstm_tpu_torch.parallel import multihost
        multihost.initialize(args.coordinator_address or None,
                             args.num_processes or None, args.process_id,
                             device=device)
        import torch.distributed as dist
        device = multihost.rank_device(device)
        rank0 = dist.get_rank() == 0

    transf = transf_params = None
    if args.feature_transform:
        transf, transf_params = Nnet.read(args.feature_transform, device)
    prof = args.verbose >= 2
    t_start = time.perf_counter()
    nnet, params = Nnet.read(args.model_in, device)
    if _bool(args.bf16):
        import torch
        for net in (nnet, transf):
            if net is not None:
                net.set_matmul_dtype(torch.bfloat16)
    if prof:
        LOG(f"invocation profile: model read {args.model_in} "
            f"{time.perf_counter() - t_start:.2f}s")
    fused = None if args.fused_xent == "auto" else _bool(args.fused_xent)
    opts = TrainOptions(learn_rate=args.learn_rate, momentum=args.momentum,
                        grad_clip=args.grad_clip,
                        l1_penalty=args.l1_penalty,
                        l2_penalty=args.l2_penalty,
                        objective=args.objective_function,
                        fused_xent=fused)

    if args.mesh:
        from kaldi_lstm_tpu_torch.parallel import MeshPlan, make_mesh
        axes = parse_mesh(args.mesh)
        mesh = make_mesh(data=axes["data"], model=axes["model"],
                         device=device)
        plan = MeshPlan(mesh, nnet)
        LOG(f"sharded training on mesh data={axes['data']} "
            f"model={axes['model']} ({mesh.world} process(es), this one "
            f"at {mesh.data_index},{mesh.model_index} on {mesh.device})")

    if args.debug_dump and (_reads_stdin(args.feature_rspecifier)
                            or _reads_stdin(args.targets_rspecifier)):
        # the dump pre-reads the rspecifiers with its own readers; a
        # single-shot stdin stream would be consumed before training
        WARN("--debug-dump skipped: stdin rspecifiers cannot be read "
             "twice")
        args.debug_dump = ""
    if args.debug_dump:
        from kaldi_lstm_tpu_torch.tools.nnet_debug_dump import (
            debug_dump,
            load_chunk,
        )
        raw_dim = transf.input_dim if transf else nnet.input_dim
        dbg_x, dbg_ids = load_chunk(
            args.feature_rspecifier, args.targets_rspecifier,
            args.num_stream, args.batch_size, raw_dim)
        if transf is not None:
            import torch
            with torch.no_grad():
                dbg_x = transf.feedforward(
                    transf_params, torch.from_numpy(dbg_x).to(device)
                ).cpu().numpy()
        debug_dump(nnet, params, dbg_x, dbg_ids, args.debug_dump,
                   have_targets=True)

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
        if plan is not None:
            p = plan.gather_params(p)  # collective: every rank enters
            if not rank0:
                return
        name = f"{args.model_out}_utt{num_done}"
        nnet.write(name, p, binary=_bool(args.binary))
        LOG(f"dumped model to {name}")

    opt_state = None
    if args.state_in:
        from kaldi_lstm_tpu_torch.train.checkpoint import load_train_state
        params, opt_state, meta = load_train_state(args.state_in, params,
                                                   device)
        LOG(f"resumed train state from {args.state_in} (meta: {meta})")

    profiler = None
    if args.profile_dir and not crossvalidate:
        profiler = _start_profiler(device)

    if prof:
        LOG(f"invocation profile: setup (parse+read+readers) "
            f"{time.perf_counter() - t_start:.2f}s to epoch start")
    res = run_epoch(nnet, params, scheduler, opts,
                    transf=transf, transf_params=transf_params,
                    crossvalidate=crossvalidate, opt_state=opt_state,
                    dump_interval=args.dump_interval, dump_fn=dump,
                    monitor_verbose=args.verbose,
                    step_group=args.step_group,
                    plan=plan, sync_every=args.sync_every)

    if profiler is not None:
        path = _stop_profiler(profiler, args.profile_dir, device)
        LOG(f"profiler trace written to {path}")

    if not crossvalidate:
        t_write = time.perf_counter()
        out_params, out_opt = res.params, res.opt_state
        if plan is not None:  # collective gathers: every rank enters
            out_params = plan.gather_params(out_params)
            if args.state_out:
                out_opt = type(out_opt)(
                    corr=plan.gather_params(out_opt.corr))
        if rank0:
            nnet.write(args.model_out, out_params,
                       binary=_bool(args.binary))
            if args.state_out:
                from kaldi_lstm_tpu_torch.train.checkpoint import \
                    save_train_state
                save_train_state(args.state_out, out_params, out_opt,
                                 meta={"learn_rate": args.learn_rate,
                                       "num_done": scheduler.num_done})
                LOG(f"wrote train state to {args.state_out}")
        if prof:
            LOG(f"invocation profile: model fetch+write {args.model_out} "
                f"{time.perf_counter() - t_write:.2f}s")
        if plan is not None:
            # no rank may re-open the model (CV, the next recipe
            # iteration) before rank 0 has written it
            from kaldi_lstm_tpu_torch.parallel.multihost import barrier
            barrier("model_write")

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
