"""Multi-stream truncated-BPTT batch scheduler (host logic, numpy), the
port's own copy of ``kaldi_lstm_tpu.train.streams`` without the native
fill.

Reproduces the reference trainer's stream machinery
(bd-nnet-train-lstm-streams.cc:143-206):

* S parallel streams, each advancing through one utterance;
* exhausted streams are refilled round-robin from the utterance source at
  the start of each batch (missing targets / length mismatches are warned
  and skipped with counters);
* every batch is a fixed-shape [S, Tbptt] chunk with
  - mask: 1 = valid frame, 0 = padding past the utterance end (times the
    per-frame weight with --frame-weights);
  - targets padded by repeating the last frame (its gradient is masked,
    but the LSTM state still advances through padded frames);
  - features shifted forward by `targets_delay` within the utterance,
    clamped to the last frame;
  - reset_flags: 1 for streams that started a new utterance this batch
    (the trainer zeroes their carried state *before* the chunk);
* iteration ends when every stream is exhausted and the source is dry.

Batch layout is stream-major [S, T, ...].
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np


class StreamBatch(NamedTuple):
    feats: np.ndarray        # [S, T, D] float32 (targets-delay applied)
    tgt_ids: np.ndarray      # [S, T, Kmax] int32
    tgt_weights: np.ndarray  # [S, T, Kmax] float32
    mask: np.ndarray         # [S, T] float32 0/1 (times frame weights)
    reset_flags: np.ndarray  # [S] int32, 1 = new utterance this batch
    num_new_utts: int        # utterances fed this batch (progress counter)


class PrefetchIterator:
    """Run an iterator on a background thread with a bounded queue, so
    host-side batch assembly (ark reads, stream fill) overlaps device
    compute. An exception in the producer is raised on the consumer
    side."""

    def __init__(self, iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._sentinel:
                if self._err is not None:
                    raise self._err
                return
            yield item


class StreamScheduler:
    """Iterates fixed-shape multi-stream BPTT batches from an utterance
    source.

    Args:
      utterances: iterator of (key, feats [L, D] float32).
      targets: object with has_key(key) -> bool and value(key) ->
        Posterior, optionally value_dense(key, K) -> ([L, K] ids,
        [L, K] weights) (e.g. RandomAccessPosteriorReader).
      feat_dim: D. num_stream: S. batch_size: Tbptt.
      targets_delay: feature shift (future context).
      max_entries: Kmax sparse-target width (1 for ali-to-post targets).
      warn: logging callback for skipped utterances.
      frame_weights: optional dict key -> [L] float32 per-frame weights
        (--frame-weights) that multiply the frame mask.
    """

    def __init__(self, utterances: Iterator[tuple[str, np.ndarray]],
                 targets, feat_dim: int, num_stream: int = 4,
                 batch_size: int = 20, targets_delay: int = 5,
                 max_entries: int = 1, warn=None, frame_weights=None):
        self.source = iter(utterances)
        self.targets = targets
        self.feat_dim = feat_dim
        self.S = num_stream
        self.T = batch_size
        self.delay = targets_delay
        self.K = max_entries
        self.warn = warn or (lambda msg: None)
        self.frame_weights = frame_weights

        self.keys: list[str] = [""] * self.S
        self.feats: list[Optional[np.ndarray]] = [None] * self.S
        self.tgt_ids: list[Optional[np.ndarray]] = [None] * self.S
        self.tgt_w: list[Optional[np.ndarray]] = [None] * self.S
        self.fw: list[Optional[np.ndarray]] = [None] * self.S
        self.curt = np.zeros(self.S, np.int64)
        self.lent = np.zeros(self.S, np.int64)
        self.source_done = False

        # counters mirroring num_done / num_no_tgt_mat / num_other_error
        self.num_done = 0
        self.num_no_tgt_mat = 0
        self.num_other_error = 0
        self.total_valid_frames = 0

    def _next_utterance(self):
        """Pull the next usable utterance, skipping bad ones. Targets come
        back dense ([L, K] ids/weights), converted once per utterance."""
        while True:
            try:
                key, feats = next(self.source)
            except StopIteration:
                self.source_done = True
                return None
            if not self.targets.has_key(key):
                self.warn(f"{key}, missing targets")
                self.num_no_tgt_mat += 1
                continue
            if hasattr(self.targets, "value_dense"):
                ids, w = self.targets.value_dense(key, self.K)
            else:
                post = self.targets.value(key)
                ids = np.zeros((len(post), self.K), np.int32)
                w = np.zeros((len(post), self.K), np.float32)
                for t, frame in enumerate(post):
                    for k, (pdf, weight) in enumerate(frame[:self.K]):
                        ids[t, k] = pdf
                        w[t, k] = weight
            if feats.shape[0] == 0:
                self.warn(f"{key}, zero-length utterance, skip")
                self.num_other_error += 1
                continue
            if feats.shape[0] != ids.shape[0]:
                self.warn(f"{key}, length miss-match between feats and "
                          f"targets, skip")
                self.num_other_error += 1
                continue
            fw = None
            if self.frame_weights is not None:
                if key not in self.frame_weights:
                    self.warn(f"{key}, missing frame weights, skip")
                    self.num_other_error += 1
                    continue
                fw = np.asarray(self.frame_weights[key], np.float32)
                if fw.shape[0] != feats.shape[0]:
                    self.warn(f"{key}, length miss-match between feats "
                              f"and frame weights, skip")
                    self.num_other_error += 1
                    continue
            return (key, np.ascontiguousarray(feats, np.float32),
                    np.ascontiguousarray(ids), np.ascontiguousarray(w), fw)

    def _refill(self) -> np.ndarray:
        """Feed exhausted streams; returns new_utt_flags [S]."""
        flags = np.zeros(self.S, np.int32)
        for s in range(self.S):
            if self.curt[s] < self.lent[s]:
                continue
            nxt = self._next_utterance()
            if nxt is None:
                continue
            (self.keys[s], self.feats[s], self.tgt_ids[s], self.tgt_w[s],
             self.fw[s]) = nxt
            self.curt[s] = 0
            self.lent[s] = self.feats[s].shape[0]
            flags[s] = 1
        return flags

    def __iter__(self) -> Iterator[StreamBatch]:
        while True:
            flags = self._refill()
            if not np.any(self.curt < self.lent):
                return  # every stream exhausted and source dry

            S, T, D, K = self.S, self.T, self.feat_dim, self.K
            curt_before = self.curt.copy()
            feats = np.zeros((S, T, D), np.float32)
            ids = np.zeros((S, T, K), np.int32)
            weights = np.zeros((S, T, K), np.float32)
            mask = np.zeros((S, T), np.float32)
            for s in range(S):
                if self.feats[s] is None:
                    continue  # source dry before this stream ever fed
                lent = int(self.lent[s])
                curt = int(self.curt[s])
                idx = curt + np.arange(T)
                row = np.minimum(idx, lent - 1)
                mask[s] = (idx < lent).astype(np.float32)
                ids[s] = self.tgt_ids[s][row]
                weights[s] = self.tgt_w[s][row]
                feats[s] = self.feats[s][np.minimum(idx + self.delay,
                                                    lent - 1)]
                self.curt[s] = curt + T

            if self.frame_weights is not None:
                for s in range(S):
                    if self.fw[s] is None:
                        continue
                    idx = int(curt_before[s]) + np.arange(T)
                    valid = idx < int(self.lent[s])
                    if valid.any():
                        mask[s, valid] *= self.fw[s][idx[valid]]

            self.num_done += int(flags.sum())
            self.total_valid_frames += float(mask.sum())
            yield StreamBatch(feats=feats, tgt_ids=ids, tgt_weights=weights,
                              mask=mask, reset_flags=flags,
                              num_new_utts=int(flags.sum()))
