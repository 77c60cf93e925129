"""The port's multi-process scheduling (parallel/multihost.py), held to
the JAX package's tests/test_multihost.py case for case: the batch-count
simulation matches the real scheduler, synced padding keeps the ranks'
step counts equal (live mode, skip-robust, lengths mode), and an empty
batch is a training no-op. Each case also runs the JAX package's
SyncedScheduler and holds the batches to it byte for byte."""

import threading

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.parallel.multihost import SyncedScheduler as JSynced
from kaldi_lstm_tpu.parallel.multihost import count_batches as j_count
from kaldi_lstm_tpu.train.streams import StreamScheduler as JScheduler
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.parallel.multihost import (
    SyncedScheduler,
    _allreduce_max,
    count_batches,
    empty_batch,
)
from kaldi_lstm_tpu_torch.train.optim import init_momentum
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, make_train_step

D = 3


class DictTargets:
    def __init__(self, table):
        self.table = table

    def has_key(self, key):
        return key in self.table

    def value(self, key):
        return self.table[key]


def make_utts(lengths, seed=0):
    """Utterances whose feature row f[t, 0] = utt_index*1000 + t and
    target id = utt_index*1000 + t, so provenance is checkable."""
    rng = np.random.RandomState(seed)
    utts, targets = [], {}
    for i, L in enumerate(lengths):
        key = f"utt{i}"
        f = rng.randn(L, D).astype(np.float32)
        f[:, 0] = i * 1000 + np.arange(L)
        utts.append((key, f))
        targets[key] = [[(i * 1000 + t, 1.0)] for t in range(L)]
    return utts, DictTargets(targets)


def make_sched(lengths, S=2, T=4, cls=StreamScheduler):
    utts, targets = make_utts(lengths)
    return cls(iter(utts), targets, feat_dim=D, num_stream=S,
               batch_size=T, targets_delay=0)


class BarrierAgree:
    """Thread-synchronized max-allreduce across simulated ranks: the
    contract of multihost._allreduce_max, one thread per rank."""

    def __init__(self, n):
        self.vals = [0] * n
        self._write = threading.Barrier(n)
        self._read = threading.Barrier(n)

    def fn(self, rank):
        def agree(v):
            self.vals[rank] = int(v)
            self._write.wait()
            m = max(self.vals)
            self._read.wait()  # all read before anyone writes next round
            return m
        return agree


def _run_ranks(synceds):
    out = [None] * len(synceds)
    errs = [None] * len(synceds)

    def run(i):
        try:
            out[i] = list(synceds[i])
        except BaseException as e:  # surfaced below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(synceds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "rank thread hung (collective desync)"
    for e in errs:
        if e is not None:
            raise e
    return out


def _same(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("lengths,S,T", [
    ([5, 9, 3, 7, 1], 2, 4),
    ([6, 10, 4], 2, 4),
    ([4, 4, 4, 4], 2, 4),
    ([2], 2, 4),
    ([2, 10], 2, 4),
    ([17, 3, 8, 1, 1, 25], 3, 5),
    ([], 2, 4),
])
def test_count_batches_matches_real_scheduler(lengths, S, T):
    real = len(list(make_sched(lengths, S, T)))
    assert count_batches(lengths, S, T) == real == j_count(lengths, S, T)


@pytest.mark.parametrize("agree_every", [1, 3])
def test_synced_live_mode_equal_steps_across_hosts(agree_every):
    res = {}
    for key, sched, synced in (("port", StreamScheduler, SyncedScheduler),
                               ("jax", JScheduler, JSynced)):
        agree = BarrierAgree(2)
        h0 = synced(make_sched([5, 9, 3, 7, 6], cls=sched),
                    agree_fn=agree.fn(0), agree_every=agree_every)
        h1 = synced(make_sched([4, 2], cls=sched), agree_fn=agree.fn(1),
                    agree_every=agree_every)
        res[key] = _run_ranks([h0, h1])
    b0, b1 = res["port"]
    assert len(b0) == len(b1)
    assert len(b0) >= len(list(make_sched([5, 9, 3, 7, 6])))
    n1_real = len(list(make_sched([4, 2])))
    for b in b1[n1_real:]:
        assert b.mask.sum() == 0 and b.reset_flags.sum() == 0
    assert sum(int(b.mask.sum()) for b in b0) == 5 + 9 + 3 + 7 + 6
    assert sum(int(b.mask.sum()) for b in b1) == 4 + 2
    for mine, theirs in zip(res["port"], res["jax"]):
        _same(mine, theirs)


def test_synced_live_mode_robust_to_runtime_skips():
    """One rank's scheduler rejects utterances at run time (missing
    targets): the step counts still agree and nothing hangs."""
    agree = BarrierAgree(2)
    utts0, targets0 = make_utts([5, 9, 3, 7])
    utts1, targets1 = make_utts([6, 30, 4, 8, 2])
    del targets1.table["utt1"]
    del targets1.table["utt3"]
    s0 = StreamScheduler(iter(utts0), targets0, feat_dim=D, num_stream=2,
                         batch_size=4, targets_delay=0)
    s1 = StreamScheduler(iter(utts1), targets1, feat_dim=D, num_stream=2,
                         batch_size=4, targets_delay=0)
    b0, b1 = _run_ranks([SyncedScheduler(s0, agree_fn=agree.fn(0)),
                         SyncedScheduler(s1, agree_fn=agree.fn(1))])
    assert len(b0) == len(b1)
    assert s1.num_no_tgt_mat == 2
    assert sum(int(b.mask.sum()) for b in b1) == 6 + 4 + 2
    assert sum(int(b.mask.sum()) for b in b0) == 5 + 9 + 3 + 7


def test_synced_lengths_mode():
    lengths = [5, 9, 3, 7]
    synced = SyncedScheduler(make_sched(lengths), agree_fn=lambda n: n,
                             lengths=lengths)
    batches = list(synced)
    assert len(batches) == count_batches(lengths, 2, 4)
    assert sum(int(b.mask.sum()) for b in batches) == sum(lengths)
    _same(batches, list(JSynced(make_sched(lengths, cls=JScheduler),
                                agree_fn=lambda n: n, lengths=lengths)))


def test_synced_lengths_mode_pads_to_larger_target():
    lengths = [5, 9, 3]
    synced = SyncedScheduler(make_sched(lengths),
                             agree_fn=lambda local: local + 3,
                             lengths=lengths)
    batches = list(synced)
    assert len(batches) == synced.target_steps
    for b in batches[-3:]:
        assert b.mask.sum() == 0 and b.reset_flags.sum() == 0
    with pytest.raises(RuntimeError, match="single-use"):
        list(synced)


def test_synced_lengths_mode_raises_on_undercount_instead_of_hanging():
    synced = SyncedScheduler(make_sched([4, 9]), agree_fn=lambda n: n,
                             lengths=[4])
    with pytest.raises(RuntimeError, match="desync"):
        list(synced)


def test_empty_batch_is_training_noop():
    """An empty batch leaves params and momentum identical and adds zero
    stats; one process's default agreement is the identity."""
    proto = ("<NnetProto>\n"
             "<LstmProjectedStreams> <InputDim> 3 <OutputDim> 4 "
             "<CellDim> 5 <NumStream> 2\n"
             "<AffineTransform> <InputDim> 4 <OutputDim> 6\n"
             "<Softmax> <InputDim> 6 <OutputDim> 6\n</NnetProto>")
    nnet, params = Nnet.init_from_proto(proto,
                                        torch.Generator().manual_seed(0),
                                        "cpu")
    step = make_train_step(nnet, TrainOptions(learn_rate=0.1, momentum=0.9),
                           device="cpu")
    opt = init_momentum(params)
    for c in opt.corr[1].values():
        c.fill_(0.25)  # a momentum a plain update would decay
    before = [t.clone() for t in (*params[0], *params[1].values(),
                                  *opt.corr[1].values())]
    b = empty_batch(2, 4, 3, 1)
    params, opt, _, aux = step(
        params, opt, nnet.init_states(2, "cpu"), (),
        *(torch.from_numpy(a) for a in (b.feats, b.tgt_ids, b.tgt_weights,
                                        b.mask, b.reset_flags)),
        torch.tensor(0.1))
    after = (*params[0], *params[1].values(), *opt.corr[1].values())
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    assert float(aux.frames) == 0 and float(aux.xent) == 0.0
    assert _allreduce_max(7) == 7


class FakeStore:
    """The set/get surface of a TCPStore that `local_layout` uses, with
    every rank's key already posted."""

    def __init__(self, hosts):
        self.keys = {f"klt_host/{r}": h.encode() for r, h in
                     enumerate(hosts)}

    def set(self, key, value):
        assert key in self.keys  # the test posted the host's name

    def get(self, key):
        return self.keys[key]


@pytest.fixture
def cards(monkeypatch):
    """Pretend the host has n cards and NCCL: returns a setter."""
    import kaldi_lstm_tpu_torch.parallel.multihost as mh

    def set_cards(n):
        monkeypatch.setattr(mh.torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(mh.dist, "is_nccl_available", lambda: True)
    return set_cards


@pytest.mark.parametrize("hosts,local_world", [
    (["a"] * 8 + ["b"] * 8, 8),  # 2 hosts x 8 cards: world 16
    (["a", "b"], 1),             # 2 hosts x 1 card: world 2
])
def test_nccl_when_each_local_rank_has_a_card(cards, monkeypatch, hosts,
                                              local_world):
    """The backend follows the ranks of this host, never the world: a
    rank each card on every host is NCCL however large the world."""
    import kaldi_lstm_tpu_torch.parallel.multihost as mh
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    cards(local_world)
    for rank in range(len(hosts)):
        lr, lw = mh.local_layout(rank, len(hosts), FakeStore(hosts))
        assert lw == local_world and lr == rank % local_world
        backend, dev, _ = mh.pick_backend("cuda", lr, lw)
        assert backend == "nccl"
        assert dev == torch.device("cuda", lr)


def test_gloo_when_ranks_share_a_card(cards, monkeypatch):
    """Two ranks of one host on its one card: gloo, both on cuda:0, and
    the reason says so."""
    import kaldi_lstm_tpu_torch.parallel.multihost as mh
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cards(1)
    lr, lw = mh.local_layout(1, 2, None)  # torchrun's environment
    assert (lr, lw) == (1, 2)
    backend, dev, why = mh.pick_backend("cuda", lr, lw)
    assert backend == "gloo" and dev == torch.device("cuda", 0)
    assert "share 1 card" in why
    # three ranks on two cards: gloo, cuda:(local rank mod 2)
    cards(2)
    backend, dev, _ = mh.pick_backend("cuda", 2, 3)
    assert backend == "gloo" and dev == torch.device("cuda", 0)


def test_cpu_is_gloo(cards):
    import kaldi_lstm_tpu_torch.parallel.multihost as mh
    cards(8)
    backend, dev, _ = mh.pick_backend("cpu", 0, 1)
    assert backend == "gloo" and dev == torch.device("cpu")
