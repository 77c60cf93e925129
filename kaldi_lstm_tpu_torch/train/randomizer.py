"""Frame-level data randomizer, the nnet1 NnetDataRandomizer (upstream
nnet/nnet-randomizer.h, included by the reference's trainer at
google/nnetbin/bd-nnet-train-lstm-streams.cc:8 for script-compat dummy
options), PyTorch edition of ``kaldi_lstm_tpu.train.randomizer``: it
backs the frame-shuffled DNN trainer (tools/nnet_train_frmshuff.py).

Host numpy only: a fixed-capacity buffer of (feature row, sparse target
entries, frame weight) tuples filled utterance by utterance; once full
(or the input is exhausted) the rows are shuffled with
``np.random.RandomState(seed).permutation``, the JAX package's own
draw, so its minibatches are byte-equal to the JAX package's, and
drained as fixed-shape minibatches. The final partial minibatch is
padded with zero-weight rows (masked out of the loss and the gradient)
rather than dropped.
"""

from __future__ import annotations

import numpy as np


class FrameRandomizer:
    """Capacity-bounded frame shuffler.

    Parameters mirror upstream NnetDataRandomizerOptions:
    `size` = --randomizer-size (frames buffered per shuffle window),
    `minibatch` = --minibatch-size, `seed` = --randomizer-seed,
    `randomize=False` preserves order (--randomize=false, used for
    cross-validation passes)."""

    def __init__(self, dim: int, size: int = 32768,
                 minibatch: int = 256, kmax: int = 1,
                 seed: int = 777, randomize: bool = True):
        self.dim = dim
        self.size = max(size, minibatch)
        self.minibatch = minibatch
        self.kmax = kmax
        self.rng = np.random.RandomState(seed)
        self.randomize = randomize
        self.feats = np.zeros((self.size, dim), np.float32)
        self.ids = np.zeros((self.size, kmax), np.int32)
        self.weights = np.zeros((self.size, kmax), np.float32)
        self.frame_w = np.zeros(self.size, np.float32)
        self.filled = 0

    def room(self) -> int:
        return self.size - self.filled

    @property
    def full(self) -> bool:
        return self.filled >= self.size

    def add(self, feats: np.ndarray, post, frame_weights=None) -> int:
        """Buffer up to room() frames of one utterance; returns the
        number of rows consumed (callers loop: add, drain when full,
        add the rest)."""
        n = min(len(post), self.room())
        if n <= 0:
            return 0
        lo = self.filled
        self.feats[lo:lo + n] = feats[:n]
        self.ids[lo:lo + n] = 0
        self.weights[lo:lo + n] = 0.0
        for t in range(n):
            for k, (pdf, w) in enumerate(post[t][:self.kmax]):
                self.ids[lo + t, k] = pdf
                self.weights[lo + t, k] = w
        if frame_weights is None:
            self.frame_w[lo:lo + n] = 1.0
        else:
            self.frame_w[lo:lo + n] = frame_weights[:n]
        self.filled += n
        return n

    def drain(self):
        """Shuffle the buffered rows and yield
        (feats [B,1,dim], ids [B,1,kmax], weights [B,1,kmax],
        frame_w [B,1]) minibatches; the trailing partial batch is
        zero-weight padded. Clears the buffer."""
        n = self.filled
        if n == 0:
            return
        order = (self.rng.permutation(n) if self.randomize
                 else np.arange(n))
        B = self.minibatch
        for lo in range(0, n, B):
            idx = order[lo:lo + B]
            m = len(idx)
            f = np.zeros((B, 1, self.dim), np.float32)
            i = np.zeros((B, 1, self.kmax), np.int32)
            w = np.zeros((B, 1, self.kmax), np.float32)
            fw = np.zeros((B, 1), np.float32)
            f[:m, 0] = self.feats[idx]
            i[:m, 0] = self.ids[idx]
            w[:m, 0] = self.weights[idx]
            fw[:m, 0] = self.frame_w[idx]
            yield f, i, w, fw
        self.filled = 0
