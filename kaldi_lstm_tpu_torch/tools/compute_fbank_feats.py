"""Log-mel filterbank extraction CLI — upstream compute-fbank-feats.
Makes the framework standalone up front: the reference's recipe assumes
feats.scp was produced by upstream Kaldi featbin
(google/train_lstm_streams.sh consumes $data/feats.scp; the paper's
config is 40 log-fbank bins, 25 ms / 10 ms).

    python -m kaldi_lstm_tpu_torch.tools.compute_fbank_feats \\
        scp:wav.scp ark,scp:fbank.ark,fbank.scp --num-mel-bins 40

This package's copy of ``kaldi_lstm_tpu.tools.compute_fbank_feats``:
host numpy on the port's feats/ and io/kaldi_io.py, the same arguments,
log lines and output bytes. One ``RandomState(--seed)`` feeds the dither
of every utterance in reader order, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.feats import (
    FbankOptions,
    FrameOptions,
    MelOptions,
    compute_fbank,
)
from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    CompressedMatrixWriter,
)
from kaldi_lstm_tpu_torch.io.wav import SequentialWaveReader
from kaldi_lstm_tpu_torch.utils import LOG


def add_frame_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sample-frequency", type=float, default=16000.0)
    p.add_argument("--frame-length", type=float, default=25.0,
                   help="frame length in milliseconds")
    p.add_argument("--frame-shift", type=float, default=10.0)
    p.add_argument("--dither", type=float, default=1.0,
                   help="dithering constant; 0 disables")
    p.add_argument("--preemphasis-coefficient", type=float, default=0.97)
    p.add_argument("--remove-dc-offset", default="true")
    p.add_argument("--window-type", default="povey")
    p.add_argument("--blackman-coeff", type=float, default=0.42)
    p.add_argument("--round-to-power-of-two", default="true")
    p.add_argument("--snip-edges", default="true")
    p.add_argument("--channel", type=int, default=-1,
                   help="channel to extract (-1 -> first, warn if more)")
    p.add_argument("--compress", default="false",
                   help="write CompressedMatrix records")
    p.add_argument("--seed", type=int, default=0,
                   help="dither RNG seed (upstream uses srand; a fixed "
                        "seed makes runs reproducible)")


def _b(s) -> bool:
    return str(s).lower() in ("true", "1", "yes")


def frame_opts_from_args(args) -> FrameOptions:
    return FrameOptions(
        samp_freq=args.sample_frequency,
        frame_shift_ms=args.frame_shift,
        frame_length_ms=args.frame_length,
        dither=args.dither,
        preemph_coeff=args.preemphasis_coefficient,
        remove_dc_offset=_b(args.remove_dc_offset),
        window_type=args.window_type,
        blackman_coeff=args.blackman_coeff,
        round_to_power_of_two=_b(args.round_to_power_of_two),
        snip_edges=_b(args.snip_edges))


def mel_opts_from_args(args) -> MelOptions:
    return MelOptions(num_bins=args.num_mel_bins,
                      low_freq=args.low_freq, high_freq=args.high_freq)


def run_extraction(args, make_opts, compute) -> int:
    rng = np.random.RandomState(args.seed)
    writer_cls = (CompressedMatrixWriter if _b(args.compress)
                  else MatrixWriter)
    n = frames = 0
    with writer_cls(args.feats_wspecifier) as w:
        for key, wave in SequentialWaveReader(args.wav_rspecifier):
            if abs(wave.samp_freq - args.sample_frequency) > 1e-3:
                LOG(f"WARNING: {key}: wav sample rate {wave.samp_freq} "
                    f"!= --sample-frequency {args.sample_frequency}; "
                    "skipping")
                continue
            ch = args.channel
            if ch < 0:
                if wave.data.shape[0] > 1:
                    LOG(f"WARNING: {key} has {wave.data.shape[0]} "
                        "channels, using channel 0")
                ch = 0
            feat = compute(wave.channel(ch), make_opts(args),
                           dither_rng=rng)
            if feat.shape[0] == 0:
                LOG(f"WARNING: {key} too short "
                    f"({wave.data.shape[1]} samples), skipping")
                continue
            w.write(key, feat)
            n += 1
            frames += feat.shape[0]
    LOG(f"Processed {n} utterances, {frames} frames")
    return 0 if n > 0 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Extract log-mel filterbank features from wav files")
    p.add_argument("wav_rspecifier", help="scp:wav.scp")
    p.add_argument("feats_wspecifier", help="ark:... / ark,scp:...")
    add_frame_args(p)
    p.add_argument("--num-mel-bins", type=int, default=23)
    p.add_argument("--low-freq", type=float, default=20.0)
    p.add_argument("--high-freq", type=float, default=0.0)
    p.add_argument("--use-energy", default="false")
    p.add_argument("--energy-floor", type=float, default=0.0)
    p.add_argument("--raw-energy", default="true")
    p.add_argument("--use-log-fbank", default="true")
    p.add_argument("--use-power", default="true")
    args = p.parse_args(argv)

    def make_opts(a):
        return FbankOptions(
            frame_opts=frame_opts_from_args(a),
            mel_opts=mel_opts_from_args(a),
            use_energy=_b(a.use_energy),
            energy_floor=a.energy_floor,
            raw_energy=_b(a.raw_energy),
            use_log_fbank=_b(a.use_log_fbank),
            use_power=_b(a.use_power))

    return run_extraction(args, make_opts, compute_fbank)


if __name__ == "__main__":
    sys.exit(main())
