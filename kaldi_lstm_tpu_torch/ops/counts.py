"""Every kernel wrapper's launch and plain-call counters, in one place.

Each wrapper module keeps its own counters (module globals bumped where
it launches its kernel or takes its plain version). This module names
them all once, so a caller that reads, zeroes or adjusts the whole set
(the grouped training step, which credits a captured graph's launches
on every replay; the chip smoke test) cannot miss one.
"""

from __future__ import annotations

from kaldi_lstm_tpu_torch.ops import lstm_infer, lstm_stack, lstm_train
from kaldi_lstm_tpu_torch.ops import xent_affine

# name -> (module, global): launches under the kernel's entry-point name
# (the float32 entry points; the bf16 ones of the --bf16 path under
# "<name>_bf16"; K5's advance-mask entry points under
# "lstmp_infer_masked[_bf16]"), plain-version calls under "plain.<module>"
_COUNTERS = {
    "lstmp_train_fwd": (lstm_train, "FWD_LAUNCHES"),
    "lstmp_train_bwd": (lstm_train, "BWD_LAUNCHES"),
    "xent_affine_fwd": (xent_affine, "FWD_LAUNCHES"),
    "xent_affine_bwd": (xent_affine, "BWD_LAUNCHES"),
    "lstmp_infer": (lstm_infer, "LAUNCHES"),
    "lstmp_train_fwd_bf16": (lstm_train, "FWD_BF16_LAUNCHES"),
    "lstmp_train_bwd_bf16": (lstm_train, "BWD_BF16_LAUNCHES"),
    "xent_affine_fwd_bf16": (xent_affine, "FWD_BF16_LAUNCHES"),
    "xent_affine_bwd_bf16": (xent_affine, "BWD_BF16_LAUNCHES"),
    "lstmp_infer_bf16": (lstm_infer, "BF16_LAUNCHES"),
    "lstmp_infer_masked": (lstm_infer, "MASKED_LAUNCHES"),
    "lstmp_infer_masked_bf16": (lstm_infer, "MASKED_BF16_LAUNCHES"),
    "lstmp_stack_fwd2": (lstm_stack, "FWD2_LAUNCHES"),
    "lstmp_stack_infer2": (lstm_stack, "INFER2_LAUNCHES"),
    "lstmp_stack_fwd2_bf16": (lstm_stack, "FWD2_BF16_LAUNCHES"),
    "lstmp_stack_infer2_bf16": (lstm_stack, "INFER2_BF16_LAUNCHES"),
    "plain.lstm_train": (lstm_train, "PLAIN_CALLS"),
    "plain.xent_affine": (xent_affine, "PLAIN_CALLS"),
    "plain.lstm_infer": (lstm_infer, "PLAIN_CALLS"),
    "plain.lstm_stack": (lstm_stack, "PLAIN_CALLS"),
}


def snapshot_counts() -> dict[str, int]:
    """Every counter's current value, by name."""
    return {k: getattr(m, attr) for k, (m, attr) in _COUNTERS.items()}


def add_counts(delta: dict[str, int]) -> None:
    """Add `delta[name]` to each named counter."""
    for k, d in delta.items():
        m, attr = _COUNTERS[k]
        setattr(m, attr, getattr(m, attr) + d)


def reset_counts() -> None:
    """Zero every counter of every wrapper."""
    for m in (lstm_infer, lstm_stack, lstm_train, xent_affine):
        m.reset_counts()


def plain_calls() -> int:
    """Calls, over all wrappers, that took a plain version."""
    return sum(v for k, v in snapshot_counts().items()
               if k.startswith("plain."))
