"""Cut utterance segments out of recordings — upstream extract-segments
(featbin/extract-segments.cc): a `segments` file of lines

    <segment-id> <recording-id> <start-seconds> <end-seconds> [<channel>]

against `scp:wav.scp`, writing a wave table of the cut pieces. This is
how every real corpus (conversational recordings, long sessions) is
turned into the per-utterance wav table the feature tools consume:

    python -m kaldi_lstm_tpu_torch.tools.extract_segments scp:wav.scp \\
        segments ark:- | python -m ...compute_fbank_feats ark:- ark:fb.ark

Upstream semantics kept: --min-segment-length skips too-short cuts;
segments ending up to --max-overshoot seconds past the file end are
clipped, longer overshoots are skipped; end <= 0 means "until the end
of the recording".

This package's copy of ``kaldi_lstm_tpu.tools.extract_segments``: host
numpy on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.wav import SequentialWaveReader, WaveWriter
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def read_segments(path: str):
    """-> list of (seg_id, rec_id, start_s, end_s, channel|-1)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) not in (4, 5):
                raise ValueError(f"segments line {ln}: expected 4-5 "
                                 f"fields, got {len(parts)}")
            seg, rec = parts[0], parts[1]
            start, end = float(parts[2]), float(parts[3])
            chan = int(parts[4]) if len(parts) == 5 else -1
            if start < 0 or (0 < end <= start):
                raise ValueError(f"segments line {ln}: bad times "
                                 f"{start} {end}")
            out.append((seg, rec, start, end, chan))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Extract segments of recordings into a wave table")
    p.add_argument("wav_rspecifier")
    p.add_argument("segments_file")
    p.add_argument("wav_wspecifier")
    p.add_argument("--min-segment-length", type=float, default=0.1,
                   help="skip segments shorter than this many seconds")
    p.add_argument("--max-overshoot", type=float, default=0.5,
                   help="allow segment ends at most this many seconds "
                        "past the recording end (clipped); skip beyond")
    args = p.parse_args(argv)

    try:
        segs = read_segments(args.segments_file)
    except ValueError as e:
        print(f"extract-segments: {e}", file=sys.stderr)
        return 1
    by_rec: dict[str, list] = {}
    for s in segs:
        by_rec.setdefault(s[1], []).append(s)

    n_done = n_err = 0
    seen_recs = set()
    with WaveWriter(args.wav_wspecifier) as w:
        for rec, wave in SequentialWaveReader(args.wav_rspecifier):
            seen_recs.add(rec)
            freq = wave.samp_freq
            num_samp = wave.data.shape[1]
            for seg, _, start, end, chan in by_rec.get(rec, ()):
                if chan < 0:
                    if wave.data.shape[0] > 1:
                        WARN(f"extract-segments: {seg}: recording {rec} "
                             f"has {wave.data.shape[0]} channels but the "
                             f"segment names none; using channel 0")
                    chan = 0
                if chan >= wave.data.shape[0]:
                    WARN(f"extract-segments: {seg}: no channel {chan} "
                         f"in {rec}")
                    n_err += 1
                    continue
                s0 = int(round(start * freq))
                s1 = num_samp if end <= 0 else int(round(end * freq))
                if s1 > num_samp:
                    if (s1 - num_samp) / freq > args.max_overshoot:
                        WARN(f"extract-segments: {seg}: end {end} "
                             f"overshoots recording ({num_samp / freq:.2f}"
                             f" s) by more than {args.max_overshoot} s")
                        n_err += 1
                        continue
                    s1 = num_samp
                if s0 >= s1 or (s1 - s0) / freq < args.min_segment_length:
                    WARN(f"extract-segments: {seg}: segment too short")
                    n_err += 1
                    continue
                w.write(seg, freq, wave.data[chan, s0:s1])
                n_done += 1
    for rec, segs_of_rec in by_rec.items():
        if rec not in seen_recs:
            for seg, *_ in segs_of_rec:
                WARN(f"extract-segments: {seg}: recording {rec} not "
                     f"present in the wav table")
                n_err += 1
    LOG(f"Extracted {n_done} segments; {n_err} errors")
    return 0 if n_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
