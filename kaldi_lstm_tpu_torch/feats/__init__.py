"""Host feature extraction (fbank, MFCC): this package's copy of
``kaldi_lstm_tpu.feats``, numpy only."""

from kaldi_lstm_tpu_torch.feats.fbank import (
    FrameOptions,
    MelOptions,
    FbankOptions,
    MfccOptions,
    compute_fbank,
    compute_mfcc,
    mel_banks,
    num_frames,
)

__all__ = [
    "FrameOptions", "MelOptions", "FbankOptions", "MfccOptions",
    "compute_fbank", "compute_mfcc", "mel_banks", "num_frames",
]
