"""Convert transition-id alignments to phone sequences — upstream
bin/ali-to-phones, the recipe tool that feeds phone-level scoring,
silence-phone discovery and MPE preparation. Host code.

    python -m kaldi_lstm_tpu_torch.tools.ali_to_phones final.mdl \\
        ark:ali.ark ark,t:phones.ark [--per-frame | --write-lengths]

Default: one phone id per phone instance (SplitToPhones segmentation).
--per-frame: one phone id per frame. --write-lengths: text
"phone duration ; phone duration ..." pairs (upstream format).
--ctm-output: phone-level CTM lines "utt 1 start dur phone"
(--frame-shift seconds per frame), the forced-alignment timing export.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    SequentialIntVectorReader,
    TableWriter,
    write_int_vector,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.tools.nnet_forward import _flag
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert model-level alignments to phone sequences")
    p.add_argument("model")
    p.add_argument("ali_rspecifier")
    p.add_argument("phones_wspecifier")
    p.add_argument("--per-frame", default="false",
                   help="write one phone per frame")
    p.add_argument("--write-lengths", default="false",
                   help="write text 'phone duration ;' pairs")
    p.add_argument("--ctm-output", default="false",
                   help="write phone-level CTM lines instead")
    p.add_argument("--frame-shift", type=float, default=0.01,
                   help="seconds per frame for --ctm-output")
    args = p.parse_args(argv)
    per_frame = _flag(args.per_frame)
    write_lengths = _flag(args.write_lengths)
    ctm = _flag(args.ctm_output)
    if per_frame + write_lengths + ctm > 1:
        print("ali_to_phones: --per-frame / --write-lengths / "
              "--ctm-output are exclusive", file=sys.stderr)
        return 1

    tm = TransitionModel.load(args.model)
    reader = SequentialIntVectorReader(args.ali_rspecifier)
    if reader.kind != "ark":
        print("ali_to_phones: only ark: input supported", file=sys.stderr)
        return 1

    def write_pairs(out, pairs):
        out.stream.write((" ; ".join(f"{p} {d}" for p, d in pairs)
                          + "\n").encode())

    n = 0
    if ctm:
        out = sys.stdout if args.phones_wspecifier == "-" \
            else open(args.phones_wspecifier, "w")
        fs = args.frame_shift
        try:
            for key, ali in reader:
                t = 0
                for s in tm.split_to_phones(ali):
                    out.write(f"{key} 1 {t * fs:.2f} {len(s) * fs:.2f} "
                              f"{int(tm.id2phone[s[0]])}\n")
                    t += len(s)
                n += 1
        finally:
            if out is not sys.stdout:
                out.close()
        LOG(f"Done {n} utterances")
        return 0

    writer = TableWriter(args.phones_wspecifier,
                         write_pairs if write_lengths
                         else write_int_vector)
    with writer as w:
        for key, ali in reader:
            if per_frame:
                w.write(key, tm.transition_ids_to_phones(ali))
            else:
                segs = tm.split_to_phones(ali)
                if write_lengths:
                    w.write(key, [(int(tm.id2phone[s[0]]), len(s))
                                  for s in segs])
                else:
                    w.write(key, np.asarray(
                        [tm.id2phone[s[0]] for s in segs], np.int32))
            n += 1
    LOG(f"Done {n} utterances")
    return 0


if __name__ == "__main__":
    sys.exit(main())
