"""Multi-process training support on torch.distributed; PyTorch edition
of ``kaldi_lstm_tpu.parallel.multihost``.

* `initialize()` — ``dist.init_process_group`` from the trainer's
  ``--coordinator-address``, ``--num-processes`` and ``--process-id`` (or
  from torchrun's environment), with a finite timeout, so a rank that
  cannot join raises instead of waiting for ever;
* per-rank data feeding: each rank runs its own StreamScheduler over its
  shard of the corpus; its [S, T] batch is its rows of the global
  [S x D, T] batch (`shard_batch_to_mesh`);
* the cross-rank termination rule: every step of the sharded trainer is
  collective, so every rank must run the same number of steps.
  `SyncedScheduler` keeps the ranks in lock-step with a periodically
  all-reduced continue flag and pads a locally exhausted rank with empty
  (fully masked, no-reset) batches: masked frames contribute zero
  gradient and zero statistics, and the step's filler guard makes a
  batch with no frames in the whole mesh an exact no-op. The protocol is
  robust to utterances skipped at run time (missing targets, length
  mismatch): a rank whose scheduler rejects data simply reaches its end
  earlier and fills.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from kaldi_lstm_tpu_torch.train.streams import StreamBatch, StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import place_arrays
from kaldi_lstm_tpu_torch.utils import LOG

# seconds a rank waits for the others (joining, and in each collective)
# before it raises; KLT_DIST_TIMEOUT overrides
DEFAULT_TIMEOUT_S = 600


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("KLT_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def _torchrun_layout() -> bool:
    return "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ


def local_layout(rank: int, world: int, store) -> tuple[int, int]:
    """(local rank, local world): this rank's index among the ranks of
    its host, and their number. From torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE where they are set, else from the host names that
    every rank posts in `store` (a collective over the store: every
    rank must call it)."""
    if _torchrun_layout():
        return (int(os.environ["LOCAL_RANK"]),
                int(os.environ["LOCAL_WORLD_SIZE"]))
    store.set(f"klt_host/{rank}", socket.gethostname())
    hosts = [store.get(f"klt_host/{r}").decode() for r in range(world)]
    mine = [r for r in range(world) if hosts[r] == hosts[rank]]
    return mine.index(rank), len(mine)


def pick_backend(device, local_rank: int,
                 local_world: int) -> tuple[str, torch.device, str]:
    """(backend, this rank's device, why) for a `--device` choice and
    the ranks on this host. NCCL whenever every rank of this host can
    have a card of its own; gloo on the CPU, or where several ranks of
    the host share a card (NCCL refuses two ranks of one communicator on
    one device). Local rank i takes cuda:(i mod cards); an explicit
    cuda:N keeps N."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", device, "tensors on the CPU"
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("--device cuda: no CUDA device is visible")
    if device.index is None:
        device = torch.device("cuda", local_rank % cards)
    if not dist.is_nccl_available():
        return "gloo", device, "this PyTorch has no NCCL"
    if cards >= local_world:
        return "nccl", device, (f"{local_world} rank(s) on this host, "
                                f"{cards} card(s): a card each")
    return "gloo", device, (f"{local_world} ranks on this host share "
                            f"{cards} card(s); NCCL refuses two ranks of "
                            f"one communicator on one device")


def rank_device(device) -> torch.device:
    """This process's device for a `--device` choice once `initialize`
    has run: a bare cuda is the card it set for this rank."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cpu") -> str:
    """Join the process group: a TCP store at `coordinator_address`
    (host:port, hosted by rank 0) with the given world size and rank,
    or torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK, LOCAL_WORLD_SIZE) without an address. The backend
    follows `pick_backend` on the ranks of this host (never the world),
    and its reason is logged. Idempotent (a recipe runs several trainer
    invocations in one process). Returns the backend. Raises when the
    rank cannot join in KLT_DIST_TIMEOUT seconds."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address:
        if not num_processes or process_id is None:
            raise ValueError("--coordinator-address needs --num-processes "
                             "and --process-id")
        world, rank = int(num_processes), int(process_id)
        host, _, port = coordinator_address.rpartition(":")
    else:
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("multi-process training needs "
                             "--coordinator-address host:port (or "
                             "torchrun's environment)")
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    store = None
    if coordinator_address or not _torchrun_layout():
        # torchrun's agent hosts the store at MASTER_PORT; without it,
        # rank 0 hosts one, which also carries the host names
        store = dist.TCPStore(host, int(port), world, rank == 0,
                              timeout=_timeout())
    local_rank, local_world = local_layout(rank, world, store)
    backend, dev, why = pick_backend(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is None:
        dist.init_process_group(backend=backend, init_method="env://",
                                world_size=world, rank=rank,
                                timeout=_timeout())
    else:
        dist.init_process_group(backend=backend, store=store,
                                world_size=world, rank=rank,
                                timeout=_timeout())
    atexit.register(_leave)
    LOG(f"process group: backend {backend} ({why}), rank {rank} of "
        f"{world}, local rank {local_rank} of {local_world}, device {dev}")
    return backend


def _leave() -> None:
    """Tear the process group down before the interpreter exits: a
    process that exits with a gloo group alive can abort in its
    threads' teardown (SIGABRT after the work is done)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(name: str) -> None:
    """Cross-process sync point (a no-op in one process): used after rank
    0's model writes, so no rank reads a half-written file when the
    recipe re-opens it (CV, the next iteration)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def empty_batch(S: int, T: int, D: int, K: int = 1) -> StreamBatch:
    """A fully masked batch: zero gradient, zero stats, no state reset;
    the filler that keeps collectives in step after local exhaustion."""
    return StreamBatch(
        feats=np.zeros((S, T, D), np.float32),
        tgt_ids=np.zeros((S, T, K), np.int32),
        tgt_weights=np.zeros((S, T, K), np.float32),
        mask=np.zeros((S, T), np.float32),
        reset_flags=np.zeros(S, np.int32),
        num_new_utts=0)


def count_batches(lengths, num_stream: int, batch_size: int) -> int:
    """The batch count a StreamScheduler emits for utterances of these
    lengths (the same round-robin refill, simulated on lengths alone)."""
    it = iter(lengths)
    curt = [0] * num_stream
    lent = [0] * num_stream
    fed = [False] * num_stream
    batches = 0
    while True:
        for s in range(num_stream):
            if curt[s] < lent[s]:
                continue
            nxt = next(it, None)
            if nxt is None:
                continue
            curt[s], lent[s], fed[s] = 0, int(nxt), True
        if not any(c < n for c, n in zip(curt, lent)):
            return batches
        for s in range(num_stream):
            if fed[s]:
                curt[s] += batch_size
        batches += 1


class SyncedScheduler:
    """Wraps a StreamScheduler so that every rank yields the same batch
    count.

    Default (live) mode: batches stream lazily from the local scheduler;
    every `agree_every` steps all ranks agree (a MAX all-reduce) on
    whether ANY rank still has real data. While one does, every rank
    yields exactly `agree_every` batches, real ones where it has them and
    fully masked fillers where it does not, so the step count is the
    same on every rank by construction, skipped utterances included.
    Cost: one tiny all-reduce per `agree_every` steps and at most
    `agree_every - 1` trailing filler steps.

    `lengths` mode: this rank's usable utterance lengths give a one-shot
    exact count with no per-step collectives; only safe when the lengths
    describe exactly what the scheduler will accept. A scheduler that
    nevertheless yields more than the agreed count raises instead of
    hanging a collective.

    `agree_fn` reduces a local int to the global max (by default an
    all-reduce over the world; injectable for tests)."""

    def __init__(self, scheduler: StreamScheduler, agree_fn=None,
                 lengths=None, agree_every: int = 1):
        self.scheduler = scheduler
        self.agree_every = max(1, int(agree_every))
        self._agree = agree_fn if agree_fn is not None else _allreduce_max
        self._iterated = False
        if lengths is not None:
            local = count_batches(lengths, scheduler.S, scheduler.T)
            self.target_steps = int(self._agree(local))
        else:
            self.target_steps = None  # discovered while iterating

    # the StreamScheduler surface that run_epoch reads
    @property
    def S(self):
        return self.scheduler.S

    @property
    def T(self):
        return self.scheduler.T

    @property
    def feat_dim(self):
        return self.scheduler.feat_dim

    @property
    def K(self):
        return self.scheduler.K

    @property
    def num_done(self):
        return self.scheduler.num_done

    @property
    def num_no_tgt_mat(self):
        return self.scheduler.num_no_tgt_mat

    @property
    def num_other_error(self):
        return self.scheduler.num_other_error

    @property
    def total_valid_frames(self):
        return self.scheduler.total_valid_frames

    def _filler(self) -> StreamBatch:
        return empty_batch(self.scheduler.S, self.scheduler.T,
                           self.scheduler.feat_dim, self.scheduler.K)

    def _iter_counted(self) -> Iterator[StreamBatch]:
        n = 0
        for b in self.scheduler:
            if n >= self.target_steps:
                raise RuntimeError(
                    f"SyncedScheduler lengths-mode desync: local scheduler "
                    f"produced more than the agreed {self.target_steps} "
                    f"batches — the provided lengths disagree with what "
                    f"the scheduler accepted at runtime (skipped/extra "
                    f"utterances?). Use the default live mode "
                    f"(lengths=None), which is skip-robust.")
            yield b
            n += 1
        for _ in range(self.target_steps - n):
            yield self._filler()

    def _iter_live(self) -> Iterator[StreamBatch]:
        it = iter(self.scheduler)
        nxt = next(it, None)
        steps = 0
        while True:
            if not int(self._agree(int(nxt is not None))):
                self.target_steps = steps
                return
            for _ in range(self.agree_every):
                if nxt is not None:
                    yield nxt
                    nxt = next(it, None)
                else:
                    yield self._filler()
                steps += 1

    def __iter__(self) -> Iterator[StreamBatch]:
        # the StreamScheduler is single-use: a second pass would yield
        # only fillers and train on nothing, so refuse it
        if self._iterated:
            raise RuntimeError(
                "SyncedScheduler is single-use (its StreamScheduler is "
                "exhausted); construct a new one with fresh readers "
                "per epoch")
        self._iterated = True
        if self.target_steps is not None:
            return self._iter_counted()
        return self._iter_live()


def _allreduce_max(local_count: int) -> int:
    """The MAX of an int over the world's ranks (itself in one process),
    on the CPU under gloo and on this rank's card under NCCL."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local_count
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([local_count], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def shard_batch_to_mesh(plan, batch: StreamBatch) -> tuple:
    """This rank's batch (its rows of the global batch) on its device:
    (feats, tgt_ids, tgt_weights, mask, reset_flags)."""
    return place_arrays((batch.feats, batch.tgt_ids, batch.tgt_weights,
                         batch.mask, batch.reset_flags), plan.mesh.device)


def shard_group_to_mesh(plan, batches) -> tuple:
    """B of this rank's batches stacked along a leading [B] axis, on its
    device, for the grouped sharded step."""
    return place_arrays([np.stack(a) for a in zip(
        *((b.feats, b.tgt_ids, b.tgt_weights, b.mask, b.reset_flags)
          for b in batches))], plan.mesh.device)
