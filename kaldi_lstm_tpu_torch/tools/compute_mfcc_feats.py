"""MFCC extraction CLI — upstream compute-mfcc-feats semantics
(DCT-II of log-mel energies, sinusoidal liftering, C0 = raw
log-energy by default). Shares frame/mel/window handling with
compute_fbank_feats.

    python -m kaldi_lstm_tpu_torch.tools.compute_mfcc_feats \\
        scp:wav.scp ark,scp:mfcc.ark,mfcc.scp

This package's copy of ``kaldi_lstm_tpu.tools.compute_mfcc_feats``: host
numpy on the port's feats/ and io/kaldi_io.py, the same arguments, log
lines and output bytes. One ``RandomState(--seed)`` feeds the dither of
every utterance in reader order, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.feats import MfccOptions, compute_mfcc
from kaldi_lstm_tpu_torch.tools.compute_fbank_feats import (
    _b,
    add_frame_args,
    frame_opts_from_args,
    mel_opts_from_args,
    run_extraction,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Extract MFCC features from wav files")
    p.add_argument("wav_rspecifier", help="scp:wav.scp")
    p.add_argument("feats_wspecifier", help="ark:... / ark,scp:...")
    add_frame_args(p)
    p.add_argument("--num-mel-bins", type=int, default=23)
    p.add_argument("--low-freq", type=float, default=20.0)
    p.add_argument("--high-freq", type=float, default=0.0)
    p.add_argument("--num-ceps", type=int, default=13)
    p.add_argument("--use-energy", default="true")
    p.add_argument("--energy-floor", type=float, default=0.0)
    p.add_argument("--raw-energy", default="true")
    p.add_argument("--cepstral-lifter", type=float, default=22.0)
    args = p.parse_args(argv)

    def make_opts(a):
        return MfccOptions(
            frame_opts=frame_opts_from_args(a),
            mel_opts=mel_opts_from_args(a),
            num_ceps=a.num_ceps,
            use_energy=_b(a.use_energy),
            energy_floor=a.energy_floor,
            raw_energy=_b(a.raw_energy),
            cepstral_lifter=a.cepstral_lifter)

    return run_extraction(args, make_opts, compute_mfcc)


if __name__ == "__main__":
    sys.exit(main())
