"""One rank of the port's multi-process CPU tests (gloo), and the helper
that starts a world of them.

    python tests/torch_dist_worker.py <job> <rank> <world> <port> <workdir>

Each job reads its inputs from <workdir> (written by the test, which
holds the results against the JAX package) and writes
<workdir>/out_<rank>.npz (or the files the CLI writes). Jobs:

* ``tp``: the tensor-parallel loss (parallel/xent_tp.py) on this rank's
  frames and class shard, fused and unfused, for every case of
  tp_in.npz; the mesh is spec.json's.
* ``step``: the sharded step (parallel/sharded_trainer.py), plain and
  grouped, for every case of spec.json on the global batches of
  step_in.npz, the parameters gathered after the last step.
* ``epoch``: run_epoch with a plan over this rank's corpus shard, then
  the trainer CLI and the recipe over the mesh flags (spec.json).

The worker imports only the port and numpy. Every collective runs under
KLT_DIST_TIMEOUT, so a rank that dies fails the test and hangs nothing.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_world(job: str, world: int, work: str) -> list:
    """Start the `world` ranks of `job` on a free localhost port; returns
    the processes (collect them with `finish_world`)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1",
               KLT_DIST_TIMEOUT="120")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]


def finish_world(procs: list, timeout: float = 300.0) -> list:
    """Wait for every rank; kill them all and raise if one fails or the
    time runs out. Returns each rank's output."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{out[-6000:]}")
    return outs


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _spec(work: str) -> dict:
    with open(os.path.join(work, "spec.json")) as f:
        return json.load(f)


def job_tp(rank, world, work, port):
    import torch

    from kaldi_lstm_tpu_torch.parallel.mesh import class_bounds, make_mesh
    from kaldi_lstm_tpu_torch.parallel.xent_tp import make_tp_fused_xent
    spec = _spec(work)
    D, M = spec["mesh"]
    mesh = make_mesh(D, M)
    inp = np.load(os.path.join(work, "tp_in.npz"))
    out = {"rank": np.array([rank, mesh.data_index, mesh.model_index])}
    for case in spec["cases"]:
        r, w, b, ids, tw, mask = (inp[f"{case}_{k}"] for k in
                                  ("r", "w", "b", "ids", "tw", "mask"))
        N, K = r.shape[0], w.shape[0]
        rows = slice(mesh.data_index * N // D,
                     (mesh.data_index + 1) * N // D)
        bounds = class_bounds(K, M)
        cls = slice(int(bounds[mesh.model_index]),
                    int(bounds[mesh.model_index + 1]))
        for fused in (True, False):
            fn = make_tp_fused_xent(mesh, K, fused=fused)
            rt = torch.tensor(r[rows], requires_grad=True)
            wt = torch.tensor(w[cls], requires_grad=True)
            bt = torch.tensor(b[cls], requires_grad=True)
            loss, aux = fn(rt, wt, bt, torch.tensor(ids[rows]),
                           torch.tensor(tw[rows]), torch.tensor(mask[rows]))
            dr, dw, db = torch.autograd.grad(loss, (rt, wt, bt))
            tag = f"{case}_{int(fused)}"
            out[f"{tag}_aux"] = np.array([float(v) for v in aux])
            out[f"{tag}_dr"] = dr.numpy()
            out[f"{tag}_dw"] = dw.numpy()
            out[f"{tag}_db"] = db.numpy()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)


def _flat(params) -> np.ndarray:
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tree_leaves(params)])


def job_step(rank, world, work, port):
    import torch

    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.parallel import (
        MeshPlan,
        make_mesh,
        make_sharded_grouped_train_step,
        make_sharded_train_step,
    )
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.trainer import TrainOptions
    spec = _spec(work)
    D, M = spec["mesh"]
    mesh = make_mesh(D, M)
    inp = np.load(os.path.join(work, "step_in.npz"))
    out = {}
    for case in spec["cases"]:
        name = case["name"]
        nnet, params = Nnet.read(case["model"], "cpu")
        plan = MeshPlan(mesh, nnet)
        opts = TrainOptions(**case["opts"])
        arrays = [inp[f"{case['batches']}_{k}"] for k in
                  ("feats", "ids", "w", "mask", "flags")]
        nb, S = arrays[0].shape[:2]
        cv = case.get("cv", False)
        global_states = nnet.init_states(S, "cpu")
        p = plan.place_params(params)
        opt = init_momentum(p)
        states = plan.place_states(global_states)
        lr = torch.tensor(opts.learn_rate)
        if case.get("group"):
            gstep = make_sharded_grouped_train_step(
                nnet, opts, plan, crossvalidate=cv,
                states_example=global_states)
            p, opt, states, rows = gstep(
                p, opt, states, (), *plan.place_batch(*arrays, group=True),
                lr)
            aux = rows[-1].numpy()
        else:
            step = make_sharded_train_step(nnet, opts, plan,
                                           crossvalidate=cv,
                                           states_example=global_states)
            for i in range(nb):
                p, opt, states, a = step(
                    p, opt, states, (),
                    *plan.place_batch(*(x[i] for x in arrays)), lr)
                aux = np.array([float(v) for v in a])
        out[f"{name}_params"] = _flat(plan.gather_params(p))
        out[f"{name}_aux"] = aux
        out[f"{name}_shard"] = _flat(p)
    if D > 1:  # a global stream count that the data axis cannot split
        nnet, _ = Nnet.read(spec["cases"][0]["model"], "cpu")
        try:
            make_sharded_train_step(
                nnet, TrainOptions(), MeshPlan(mesh, nnet),
                states_example=nnet.init_states(D + 1, "cpu"))
            out["indivisible"] = np.array("")
        except ValueError as e:
            out["indivisible"] = np.array(str(e))
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)


def job_epoch(rank, world, work, port):
    """A library epoch over this rank's shard, then the CLIs."""
    from kaldi_lstm_tpu_torch.io.kaldi_io import (
        RandomAccessPosteriorReader,
        SequentialMatrixReader,
    )
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.parallel import MeshPlan, make_mesh
    from kaldi_lstm_tpu_torch.tools import run_recipe, train_lstm_streams
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch
    spec = _spec(work)
    mp = ["--coordinator-address", f"localhost:{port}", "--num-processes",
          str(world), "--process-id", str(rank), "--device", "cpu",
          "--verbose=0"]
    out = {}
    # the trainer CLI over the data axis, each rank on its own shard
    shard = os.path.join(work, f"shard{rank}")
    common = [f"scp:{shard}/feats.scp", f"ark:{shard}/post.ark",
              os.path.join(work, "nnet.init")]
    rc, stats = train_lstm_streams.run_main(
        common + [os.path.join(work, "dp.nnet"), "--mesh", "data=2",
                  "--sync-every=2", "--step-group", "2"]
        + spec["train_flags"] + mp)
    assert rc == 0
    out["cli_stats"] = np.array([stats.loss, stats.entropy, stats.correct,
                                 stats.frames])
    rc, cv = train_lstm_streams.run_main(
        common + ["--cross-validate=true", "--mesh", "data=2"]
        + spec["train_flags"] + mp)
    assert rc == 0
    out["cv_stats"] = np.array([cv.loss, cv.entropy, cv.correct,
                                cv.frames])

    # the library path on the same shards, for the global-batch check
    nnet, params = Nnet.read(os.path.join(work, "nnet.init"), "cpu")
    sched = StreamScheduler(
        iter(SequentialMatrixReader(f"scp:{shard}/feats.scp")),
        RandomAccessPosteriorReader(f"ark:{shard}/post.ark"),
        feat_dim=nnet.input_dim, num_stream=spec["num_stream"],
        batch_size=spec["batch_size"], targets_delay=0)
    plan = MeshPlan(make_mesh(data=2, model=1), nnet)
    res = run_epoch(nnet, params, sched, TrainOptions(**spec["opts"]),
                    plan=plan, sync_every=3)
    out["lib_params"] = _flat(plan.gather_params(res.params))
    s = res.stats
    out["lib_stats"] = np.array([s.loss, s.entropy, s.correct, s.frames])

    # the model axis: both ranks read the whole corpus, so the run is the
    # single-process one split over the classes
    whole = [f"scp:{work}/whole/feats.scp", f"ark:{work}/whole/post.ark",
             os.path.join(work, "nnet.init")]
    rc = train_lstm_streams.main(
        whole + [os.path.join(work, "tp.nnet"), "--mesh", "model=2"]
        + spec["train_flags"] + mp)
    assert rc == 0
    rc = run_recipe.main(
        ["--tr-feats", f"scp:{work}/whole/feats.scp",
         "--tr-targets", f"ark:{work}/whole/post.ark",
         "--cv-feats", f"scp:{work}/whole/feats.scp",
         "--cv-targets", f"ark:{work}/whole/post.ark",
         "--proto", os.path.join(work, "nnet.proto"),
         "--dir", os.path.join(work, "exp_m"), "--scheduler", "fixed",
         "--max-iters", "2", "--step-group", "2", "--mesh", "model=2",
         "--verbose", "0"] + spec["recipe_flags"] + mp[:-1])
    assert rc == 0
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)


JOBS = {"tp": job_tp, "step": job_step, "epoch": job_epoch}


def main():
    job, rank, world, port, work = sys.argv[1:6]
    rank, world, port = int(rank), int(world), int(port)
    import torch
    torch.set_num_threads(1)
    if job != "epoch":  # the CLIs join through their own flags
        from kaldi_lstm_tpu_torch.parallel import multihost
        multihost.initialize(f"localhost:{port}", world, rank)
    JOBS[job](rank, world, work, port)
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
