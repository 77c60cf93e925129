"""Faults planted in the program underneath a run, for the tests and
readings that show `correct` coming out false (tests/, tools/). Each is
a context manager that patches one function of the program's timed
path and restores it.

- `state_unchanged`: the training step returns params and momentum
  unchanged.
- `half_batch`: the training loss leaves out every other row (half of
  the streams) and takes the mean over the rest.
- `half_utterances`: scoring zeroes the features of every other
  utterance of a batch.
- `answer_altered`: scoring adds 1 to the first score of every
  utterance where the device produces it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _rescaled(loss, aux, mask, kept):
    scale = mask.sum() / kept.sum().clamp(min=1)
    return loss * scale, aux._replace(
        xent=aux.xent * scale, entropy=aux.entropy * scale,
        correct=aux.correct * scale, frames=mask.sum())


@contextlib.contextmanager
def state_unchanged():
    from kaldi_lstm_tpu_torch.train import trainer

    def update(params, grads, opt_state, *a, **k):
        return params, opt_state

    with _patched(trainer, "momentum_update", update):
        yield


@contextlib.contextmanager
def half_batch():
    from kaldi_lstm_tpu_torch.train import trainer
    fused, plain = trainer.fused_affine_xent, trainer._LOSS_FNS["xent"]

    def fused_half(r, w, b, ids, tw, mask, compute_dtype=None):
        keep = (torch.arange(mask.shape[0], device=mask.device) % 2 == 0)
        m2 = mask * keep.to(mask.dtype)
        loss, aux = fused(r, w, b, ids, tw, m2, compute_dtype=compute_dtype)
        return _rescaled(loss, aux, mask, m2)

    def plain_half(logits, ids, tw, mask):
        keep = (torch.arange(mask.shape[0], device=mask.device) % 2 == 0)
        m2 = mask * keep.to(mask.dtype)[:, None]
        loss, aux = plain(logits, ids, tw, m2)
        return _rescaled(loss, aux, mask, m2)

    with _patched(trainer, "fused_affine_xent", fused_half), \
            _patched(trainer, "_LOSS_FNS", dict(trainer._LOSS_FNS,
                                                xent=plain_half)):
        yield


@contextlib.contextmanager
def half_utterances():
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    forward = AmScorer._forward

    def forward_half(self, x):
        x = x.clone()
        x[1::2] = 0.0
        return forward(self, x)

    with _patched(AmScorer, "_forward", forward_half):
        yield


@contextlib.contextmanager
def answer_altered():
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    forward = AmScorer._forward

    def forward_altered(self, x):
        y = forward(self, x).clone()
        y[:, 0, 0] += 1.0
        return y

    with _patched(AmScorer, "_forward", forward_altered):
        yield


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SCORE = {"half_utterances": half_utterances, "answer_altered": answer_altered}
