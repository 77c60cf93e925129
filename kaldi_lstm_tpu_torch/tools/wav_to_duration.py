"""Durations (seconds) of a wave table — upstream wav-to-duration
(featbin/wav-to-duration.cc); recipes use it for data checks and
per-utterance audio accounting.

    python -m kaldi_lstm_tpu_torch.tools.wav_to_duration scp:wav.scp \\
        ark,t:dur.txt

This package's copy of ``kaldi_lstm_tpu.tools.wav_to_duration``: host
numpy on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    KaldiOutput,
    TableWriter,
    write_float,
)
from kaldi_lstm_tpu_torch.io.wav import SequentialWaveReader
from kaldi_lstm_tpu_torch.utils import LOG


def FloatWriter(wspecifier: str) -> TableWriter:
    def _write(out: KaldiOutput, value: float) -> None:
        if out.binary:
            write_float(out, float(value))
        else:
            out.stream.write(f"{float(value):.7g}\n".encode())
    return TableWriter(wspecifier, _write)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Write per-recording durations in seconds")
    p.add_argument("wav_rspecifier")
    p.add_argument("wspecifier")
    args = p.parse_args(argv)

    n = 0
    total = 0.0
    with FloatWriter(args.wspecifier) as w:
        for key, wave in SequentialWaveReader(args.wav_rspecifier):
            w.write(key, wave.duration)
            total += wave.duration
            n += 1
    LOG(f"Printed durations for {n} recordings; total {total:.1f} s "
        f"({total / 3600:.3f} h)")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
