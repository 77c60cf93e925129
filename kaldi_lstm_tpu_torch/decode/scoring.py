"""Batched acoustic-model scoring, PyTorch edition of
``kaldi_lstm_tpu.decode.scoring``.

`AmScorer` is the device half of upstream `nnet-forward`: whole
utterances, zero initial LSTM state, optional device-side log-softmax and
log-prior subtraction, `batch_utts` utterances per dispatch with lengths
padded to `length_bucket` multiples (padding repeats the last frame, so
the padded frames change no output row of a causal net with a clamped
time shift). tools/nnet_forward.py writes the matrices.

The scorer feeds `utils.timer.PROFILE` on its caller's thread: the spans
`score.stage` (padding and pinning a batch), `score.dispatch` (its
upload, forward and the queued copy back), `score.fetch_wait` (waiting
for that copy) and `score.emit` (each utterance's rows, closed before
the rows are yielded), all but the wait with the batch's number as
their argument in a profiler trace; and the counters `score.batches`,
`score.frames` (unpadded), `score.frame_slots` (B x T_b a batch) and
`score.pinned_bytes` (pinned host bytes requested, input and result;
the caching host allocator may serve them from freed blocks).
"""

from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import KaldiInput, read_vector
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.utils import WARN
from kaldi_lstm_tpu_torch.utils.timer import PROFILE
from kaldi_lstm_tpu_torch.utils.tree import params_device


def read_class_frame_counts(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return read_vector(KaldiInput(f))


def log_priors_from_counts(counts: np.ndarray, prior_scale: float = 1.0,
                           prior_floor: float = 1e-10) -> np.ndarray:
    priors = counts / max(counts.sum(), 1.0)
    return prior_scale * np.log(
        np.maximum(priors, prior_floor)).astype(np.float32)


def dense_from_topk(vals: np.ndarray, idx: np.ndarray, num_pdfs: int,
                    floor_margin: float) -> np.ndarray:
    """Reconstruct dense [..., num_pdfs] log-likelihood rows from a
    device-pruned (top-P values, int32 indices) pair: unfetched pdfs
    read the per-frame floor ``min(fetched values) - floor_margin``."""
    vals = np.asarray(vals, np.float32)
    floor = vals.min(axis=-1, keepdims=True) - floor_margin
    out = np.broadcast_to(floor,
                          vals.shape[:-1] + (num_pdfs,)).copy()
    np.put_along_axis(out, np.asarray(idx).astype(np.int64), vals,
                      axis=-1)
    return out


class PendingFetch(NamedTuple):
    """A batch's device result on its way to the host (CUDA only):
    fresh pinned host tensors that a side stream copies into, and timing
    events. ``begin`` and ``ready`` are recorded on the compute stream
    before the batch's input copy and after its forward, ``start`` and
    ``done`` on the side stream before and after its result's copy."""
    host: tuple
    begin: torch.cuda.Event
    ready: torch.cuda.Event
    start: torch.cuda.Event
    done: torch.cuda.Event


def copy_overlaps(a: PendingFetch, b: PendingFetch) -> bool:
    """Whether batch a's copy to the host ran while batch b's device work
    did: [a.start, a.done] and [b.begin, b.ready] intersect. Both must
    have completed."""
    return a.start.elapsed_time(b.ready) > 0.0 \
        and b.begin.elapsed_time(a.done) > 0.0


def queue_host_copy(y, side: torch.cuda.Stream, device,
                    begin: torch.cuda.Event) -> PendingFetch:
    """Queue the copy of a device result (a tensor, or a tuple of them)
    to fresh pinned host tensors on the `side` stream, after the work
    queued so far on `device`'s current stream; `begin` was recorded on
    that stream before the result's input copy."""
    ready = torch.cuda.Event(enable_timing=True)
    ready.record(torch.cuda.current_stream(device))
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    host = []
    with torch.cuda.stream(side):
        side.wait_event(ready)
        start.record(side)
        for t in (y if isinstance(y, tuple) else (y,)):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)   # the allocator keeps t for the copy
            host.append(h)
        done.record(side)
    return PendingFetch(tuple(host), begin, ready, start, done)


def fetch_block(y, top_p: int, num_pdfs: int,
                floor_margin: float) -> np.ndarray:
    """Bring a scoring result to the host as a dense [B, T, K] float32
    block, rebuilt from the pruned (vals, idx) pair when `top_p` > 0. On
    CUDA `y` is a PendingFetch: wait for its copy only, in the span
    `score.fetch_wait`."""
    if isinstance(y, PendingFetch):
        with PROFILE.section("score.fetch_wait"):
            y.done.synchronize()
        y = y.host if top_p > 0 else y.host[0]
    if top_p <= 0:
        return y.cpu().float().numpy()
    return dense_from_topk(y[0].cpu().float().numpy(), y[1].cpu().numpy(),
                           num_pdfs, floor_margin)


class AmScorer:
    """Batched whole-utterance AM scoring (see module docstring).

    * ``pipeline=True``: batch k+1 is queued on the device stream before
      batch k is fetched, so device compute overlaps the host-side fetch
      and whatever the caller does with the rows. On CUDA every batch's
      scores go to the host on a side stream of the scorer's own, into
      fresh pinned memory, as soon as its forward is done: batch k's
      copy runs while batch k+1 computes. A pinned buffer is never
      reused, because the rows yielded are views of it that the caller
      may keep.
    * ``top_p > 0``: prune the fetch ON DEVICE — only the top-P
      log-likelihoods per frame (values + int32 pdf indices) are copied;
      dense rows are rebuilt host-side with the per-frame floor
      ``min(top values) - floor_margin``.
    * ``fetch_dtype`` (e.g. torch.bfloat16) halves the payload of the
      fetched values.

    The net runs on ``device`` (default: the device its parameters are
    on); the feature transform's parameters must be on the same device.
    """

    def __init__(self, nnet: Nnet, params, transf: Optional[Nnet] = None,
                 transf_params=None, log_prior: Optional[np.ndarray] = None,
                 apply_log: bool = False, no_softmax: bool = False,
                 batch_utts: int = 8, length_bucket: int = 128,
                 pipeline: bool = False, top_p: int = 0,
                 floor_margin: float = 10.0, fetch_dtype=None,
                 device=None):
        self.device = torch.device(device) if device is not None \
            else params_device(params)
        self.nnet, self.params = nnet, params
        self.transf, self.transf_params = transf, transf_params
        self.log_prior = log_prior
        self.apply_log, self.no_softmax = apply_log, no_softmax
        self.B = max(batch_utts, 1)
        self.bucket = max(length_bucket, 1)
        self.pipeline = bool(pipeline)
        self.top_p = int(top_p)
        if self.top_p > 0 and not (apply_log or no_softmax):
            # probability-domain output would make both the top-k
            # ranking (prior subtraction happens host-side there) and
            # the min-minus-margin floor wrong
            raise ValueError(
                "top_p pruned fetch requires log-domain output "
                "(apply_log or no_softmax)")
        self.floor_margin = float(floor_margin)
        self.fetch_dtype = fetch_dtype
        self.num_pdfs = nnet.output_dim
        self._lp_dev = None if log_prior is None else \
            torch.tensor(log_prior, dtype=torch.float32, device=self.device)
        self._copy_stream = None
        # batches dispatched and emitted so far, in the same order: the
        # argument of a batch's spans
        self.dispatched = self.emitted = 0

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor):
        if self.transf is not None:
            x = self.transf.feedforward(self.transf_params, x)
        y, _ = self.nnet.propagate(self.params, x,
                                   logits=self.no_softmax or self.apply_log)
        if self.apply_log and not self.no_softmax:
            y = torch.log_softmax(y, dim=-1)
        if self._lp_dev is not None and (self.apply_log or self.no_softmax):
            y = y - self._lp_dev
        if self.top_p > 0:
            vals, idx = torch.topk(y, self.top_p, dim=-1)
            if self.fetch_dtype is not None:
                vals = vals.to(self.fetch_dtype)
            return vals, idx.to(torch.int32)
        if self.fetch_dtype is not None:
            y = y.to(self.fetch_dtype)
        return y

    def _copy_async(self, y, begin: torch.cuda.Event) -> PendingFetch:
        """Queue the copy of a device result (a tensor, or the top_p
        (vals, idx) pair) to fresh pinned host tensors on the side
        stream, after the compute stream's work so far."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return queue_host_copy(y, self._copy_stream, self.device, begin)

    def _fetch(self, y) -> np.ndarray:
        return fetch_block(y, self.top_p, self.num_pdfs, self.floor_margin)

    def _postprocess(self, y: np.ndarray) -> np.ndarray:
        # device path already applied log-softmax / prior subtraction
        if self.log_prior is not None and not (self.apply_log
                                               or self.no_softmax):
            WARN("class-frame-counts given but output is not in log "
                 "domain; taking log before prior division")
            y = np.log(np.maximum(y, 1e-20)) - self.log_prior
        return y

    def _dispatch(self, group):
        """Stage a group and queue its device computation (async); on
        CUDA also queue the copy of its result to the host."""
        n = self.dispatched
        self.dispatched += 1
        cuda = self.device.type == "cuda"
        with PROFILE.section("score.stage", n):
            T = -(-max(f.shape[0] for _, f in group) // self.bucket) \
                * self.bucket
            D = group[0][1].shape[1]
            # always [B, ...]: extra rows are zeros, never written out
            x = np.zeros((self.B, T, D), np.float32)
            for i, (_, f) in enumerate(group):
                x[i, :f.shape[0]] = f
                if f.shape[0]:
                    x[i, f.shape[0]:] = f[-1]  # repeat last frame as padding
            xt = torch.from_numpy(x)
            if cuda:
                # pinned staging makes the copy asynchronous, so queuing
                # batch k+1 does not wait for batch k to finish
                xt = xt.pin_memory()
        PROFILE.add("score.batches")
        PROFILE.add("score.frames", sum(f.shape[0] for _, f in group))
        PROFILE.add("score.frame_slots", self.B * T)
        with PROFILE.section("score.dispatch", n):
            if not cuda:
                return self._forward(xt.to(self.device))
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(torch.cuda.current_stream(self.device))
            xt = xt.to(self.device, non_blocking=True)
            y = self._copy_async(self._forward(xt), begin)
        PROFILE.add("score.pinned_bytes",
                    x.nbytes + sum(h.nbytes for h in y.host))
        return y

    def _emit(self, group, y_dev) -> Iterator[tuple[str, np.ndarray]]:
        n = self.emitted
        self.emitted += 1
        out = self._fetch(y_dev)
        for i, (key, f) in enumerate(group):
            with PROFILE.section("score.emit", n):
                rows = self._postprocess(out[i, :f.shape[0]])
            yield key, rows

    def score_stream(self, reader: Iterable
                     ) -> Iterator[tuple[str, np.ndarray]]:
        """(key, feats) pairs in -> (key, scores [T, K]) pairs out, in
        input order, batching B utterances per device dispatch. With
        ``pipeline=True`` one batch stays in flight."""
        inflight = None   # (group, device result)
        group = []
        for key, feats in reader:
            group.append((key, feats))
            if len(group) >= self.B:
                y = self._dispatch(group)
                if self.pipeline:
                    if inflight is not None:
                        yield from self._emit(*inflight)
                    inflight = (group, y)
                else:
                    yield from self._emit(group, y)
                group = []
        if group:
            y = self._dispatch(group)
            if inflight is not None:
                yield from self._emit(*inflight)
            inflight = None
            yield from self._emit(group, y)
        elif inflight is not None:
            yield from self._emit(*inflight)
