"""Multi-process training through the port's CLIs and epoch loop: two
gloo ranks (tests/torch_dist_worker.py) with the trainer's
--coordinator-address / --num-processes / --process-id flags, as the
JAX package's tests/test_multiprocess.py and tests/test_cli_mesh.py
drive its tools.

* --mesh data=2 on shards of unequal size (rank 1 runs out first and
  pads with filler batches): both ranks hold the same global statistics,
  rank 0 writes a model that both packages read, the cross-validation
  statistics equal one process's over the two shards, and the library
  epoch (run_epoch with a plan) leaves bit-identical parameters on both
  ranks, equal to one process's epoch over the same global batches;
* --mesh model=2 (both ranks on the whole corpus): the trainer CLI and
  run_recipe --step-group 2 equal the single-process runs;
* a bad --mesh spec raises, and a mesh the world cannot hold raises.

Tolerances: parameters 1e-5 absolute and relative (5e-5 after the
recipe's two iterations, as the JAX test holds its recipe), statistics
1e-5 relative, frame counts exactly.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    PosteriorWriter,
    RandomAccessPosteriorReader,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.parallel.multihost import empty_batch
from kaldi_lstm_tpu_torch.tools import (
    make_synth_data,
    nnet_initialize,
    run_recipe,
    train_lstm_streams,
)
from kaldi_lstm_tpu_torch.train.streams import StreamBatch, StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

PROTO = """<NnetProto>
<LstmProjectedStreams> <InputDim> 6 <OutputDim> 12 <CellDim> 16 <ParamScale> 0.05 <NumStream> 8
<AffineTransform> <InputDim> 12 <OutputDim> 8 <ParamStddev> 0.1
<Softmax> <InputDim> 8 <OutputDim> 8
</NnetProto>
"""
TRAIN = ["--learn-rate=1e-3", "--num-stream=4", "--targets-delay=0",
         "--batch-size=20"]
RECIPE = ["--learn-rate", "1e-3", "--num-stream", "4", "--targets-delay",
          "0"]
OPTS = {"learn_rate": 1e-3, "momentum": 0.9}
TOL = dict(rtol=1e-5, atol=1e-5)


def _worker():
    path = pathlib.Path(__file__).with_name("torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_dist_worker",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(d, n, seed):
    make_synth_data.main(["--dir", str(d), "--num-utts", str(n),
                          "--feat-dim", "6", "--num-classes", "8",
                          "--seed", str(seed), "--label-seed", "7",
                          "--max-len", "60"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mp")
    # shard 0: 8 utterances, shard 1: 4, so rank 1 runs out first
    for rank, (n, seed) in enumerate(((8, 11), (4, 22))):
        _corpus(work / f"shard{rank}", n, seed)
    _corpus(work / "whole", 6, 33)
    (work / "nnet.proto").write_text(PROTO)
    nnet_initialize.main([str(work / "nnet.proto"), str(work / "nnet.init"),
                          "--device", "cpu"])
    (work / "spec.json").write_text(json.dumps(
        {"train_flags": TRAIN, "recipe_flags": RECIPE, "num_stream": 4,
         "batch_size": 20, "opts": OPTS}))
    w = _worker()
    w.finish_world(w.start_world("epoch", 2, str(work)))
    return work, [dict(np.load(work / f"out_{r}.npz")) for r in range(2)]


def _flat(params):
    return np.concatenate([t.detach().numpy().ravel()
                           for t in tree_leaves(params)])


def _shard_sched(work, rank):
    nnet, _ = Nnet.read(str(work / "nnet.init"), "cpu")
    d = work / f"shard{rank}"
    return StreamScheduler(
        iter(SequentialMatrixReader(f"scp:{d}/feats.scp")),
        RandomAccessPosteriorReader(f"ark:{d}/post.ark"),
        feat_dim=nnet.input_dim, num_stream=4, batch_size=20,
        targets_delay=0)


class GlobalBatches:
    """The two shards' schedulers as one: each batch is rank 0's rows
    then rank 1's, an exhausted shard's rows a filler batch, as the
    two-rank epoch assembles its global batch."""

    def __init__(self, scheds):
        self.scheds = scheds
        self.S = sum(s.S for s in scheds)
        self.T, self.feat_dim, self.K = (scheds[0].T, scheds[0].feat_dim,
                                         scheds[0].K)

    @property
    def num_done(self):
        return sum(s.num_done for s in self.scheds)

    def __iter__(self):
        its = [iter(s) for s in self.scheds]
        while True:
            got = [next(it, None) for it in its]
            if all(g is None for g in got):
                return
            parts = [g if g is not None else
                     empty_batch(s.S, s.T, s.feat_dim, s.K)
                     for g, s in zip(got, self.scheds)]
            yield StreamBatch(*(np.concatenate(a) for a in
                                zip(*(p[:5] for p in parts))),
                              num_new_utts=sum(p.num_new_utts
                                               for p in parts))


def test_ranks_agree_on_global_stats_and_write_one_model(run):
    work, out = run
    np.testing.assert_array_equal(out[0]["cli_stats"], out[1]["cli_stats"])
    np.testing.assert_array_equal(out[0]["cv_stats"], out[1]["cv_stats"])
    assert out[0]["cli_stats"][3] > 0
    path = str(work / "dp.nnet")
    p_port = _flat(Nnet.read(path, "cpu")[1])
    import jax
    p_jax = np.concatenate([np.asarray(x).ravel() for x in
                            jax.tree_util.tree_leaves(JNnet.read(path)[1])])
    np.testing.assert_array_equal(p_port, p_jax)


def test_library_epoch_is_one_global_epoch(run):
    """run_epoch with a plan on each rank's shard: bit-identical params
    on both ranks, equal to one process's epoch over the global
    batches (rank 0's streams, then rank 1's)."""
    work, out = run
    np.testing.assert_array_equal(out[0]["lib_params"],
                                  out[1]["lib_params"])
    np.testing.assert_array_equal(out[0]["lib_stats"], out[1]["lib_stats"])
    nnet, params = Nnet.read(str(work / "nnet.init"), "cpu")
    res = run_epoch(nnet, params, GlobalBatches([_shard_sched(work, 0),
                                                 _shard_sched(work, 1)]),
                    TrainOptions(**OPTS))
    np.testing.assert_allclose(out[0]["lib_params"], _flat(res.params),
                               **TOL)
    s = res.stats
    np.testing.assert_allclose(out[0]["lib_stats"][:2],
                               [s.loss, s.entropy], rtol=1e-5)
    assert list(out[0]["lib_stats"][2:]) == [s.correct, s.frames]


def test_cross_validation_stats_are_the_global_sums(run, tmp_path):
    """CV under --mesh data=2 on the two shards: the same AvgLoss and
    frame count as one process over both shards (JAX
    tests/test_cli_mesh.py:101)."""
    work, out = run
    # the shards' keys repeat: the union renames them
    with MatrixWriter(f"ark:{tmp_path}/feats.ark") as fw, \
            PosteriorWriter(f"ark:{tmp_path}/post.ark") as pw:
        for r in range(2):
            d = work / f"shard{r}"
            post = RandomAccessPosteriorReader(f"ark:{d}/post.ark")
            for key, m in SequentialMatrixReader(f"scp:{d}/feats.scp"):
                fw.write(f"s{r}_{key}", m)
                pw.write(f"s{r}_{key}", post.value(key))
    rc, s = train_lstm_streams.run_main(
        [f"ark:{tmp_path}/feats.ark", f"ark:{tmp_path}/post.ark",
         str(work / "nnet.init"), "--cross-validate=true", "--device",
         "cpu"] + TRAIN)
    assert rc == 0
    loss, _, _, frames = out[0]["cv_stats"]
    assert frames == s.frames
    assert abs(loss / frames - s.avg_loss()) < 1e-5


def test_model_axis_cli_matches_single_process(run, tmp_path):
    """--mesh model=2 with both ranks on the whole corpus is the
    single-process run with the senone layer split (JAX
    tests/test_cli_mesh.py:57)."""
    work, _ = run
    out = tmp_path / "single.nnet"
    assert train_lstm_streams.main(
        [f"scp:{work}/whole/feats.scp", f"ark:{work}/whole/post.ark",
         str(work / "nnet.init"), str(out), "--device", "cpu"]
        + TRAIN) == 0
    np.testing.assert_allclose(_flat(Nnet.read(str(work / "tp.nnet"),
                                               "cpu")[1]),
                               _flat(Nnet.read(str(out), "cpu")[1]), **TOL)


def test_run_recipe_model_axis_matches_single_process(run, tmp_path):
    """run_recipe --mesh model=2 --step-group 2 (two iterations with CV)
    against the single-process recipe (JAX tests/test_cli_mesh.py:116)."""
    work, _ = run
    d = tmp_path / "exp_s"
    assert run_recipe.main(
        ["--tr-feats", f"scp:{work}/whole/feats.scp",
         "--tr-targets", f"ark:{work}/whole/post.ark",
         "--cv-feats", f"scp:{work}/whole/feats.scp",
         "--cv-targets", f"ark:{work}/whole/post.ark",
         "--proto", str(work / "nnet.proto"), "--dir", str(d),
         "--scheduler", "fixed", "--max-iters", "2", "--verbose", "0",
         "--device", "cpu"] + RECIPE) == 0
    got = _flat(Nnet.read(str(work / "exp_m/nnet/nnet.iter2"), "cpu")[1])
    want = _flat(Nnet.read(str(d / "nnet/nnet.iter2"), "cpu")[1])
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6)


def test_cli_mesh_rejects_bad_spec():
    """JAX tests/test_cli_mesh.py:82."""
    with pytest.raises(ValueError):
        train_lstm_streams.parse_mesh("data=0")
    with pytest.raises(ValueError):
        train_lstm_streams.parse_mesh("rows=2")
    assert train_lstm_streams.parse_mesh("data=4,model=2") == \
        {"data": 4, "model": 2}
    assert train_lstm_streams.parse_mesh("data=8") == \
        {"data": 8, "model": 1}


def test_cli_mesh_without_its_ranks_fails_fast(run, tmp_path, monkeypatch):
    """A mesh larger than the world raises the JAX package's message
    before any step (JAX tests/test_cli_mesh.py:93 fails fast on a
    stream count its data axis cannot split; here --num-stream is per
    process, so that case is the sharded step's, in
    tests/test_torch_sharding.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    work, _ = run
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        train_lstm_streams.main(
            [f"scp:{work}/whole/feats.scp", f"ark:{work}/whole/post.ark",
             str(work / "nnet.init"), str(tmp_path / "x.nnet"),
             "--mesh", "data=4", "--device", "cpu"] + TRAIN)
    assert not os.path.exists(tmp_path / "x.nnet")
    assert not torch.distributed.is_initialized()
