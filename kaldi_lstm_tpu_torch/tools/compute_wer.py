"""Score hypothesis transcripts against references — upstream
compute-wer; this package's copy of
``kaldi_lstm_tpu.tools.compute_wer``. Inputs are text tables:
`key sym1 sym2 ...` per line.

    python -m kaldi_lstm_tpu_torch.tools.compute_wer ref.txt hyp.txt
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.wer import EditStats, edit_distance, wer_report
from kaldi_lstm_tpu_torch.io.lang import read_text_table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compute WER/PER between "
                                "reference and hypothesis text tables")
    p.add_argument("ref")
    p.add_argument("hyp")
    p.add_argument("--mode", choices=["strict", "present"],
                   default="strict",
                   help="strict: missing hypotheses are an error; "
                        "present: score only utterances present in hyp")
    args = p.parse_args(argv)

    ref = read_text_table(args.ref)
    hyp = read_text_table(args.hyp)
    total = EditStats()
    missing = 0
    for key, rwords in ref.items():
        if key not in hyp:
            missing += 1
            if args.mode == "strict":
                total.add(EditStats(errors=len(rwords),
                                    ref_len=len(rwords),
                                    dele=len(rwords), num_utts=1))
            continue
        total.add(edit_distance(rwords, hyp[key]))
    if missing:
        print(f"compute_wer: {missing} utterances missing from "
              f"hypothesis ({args.mode} mode)", file=sys.stderr)
    print(wer_report(total))
    # %SER over the same utterance set the WER used: strict counts
    # missing hypotheses as errors, present scores only scored utts
    if args.mode == "strict":
        scored = list(ref)
    else:
        scored = [k for k in ref if k in hyp]
    err = sum(1 for k in scored if hyp.get(k) != ref[k])
    print(f"%SER {100.0 * err / max(len(scored), 1):.2f} "
          f"[ {err} / {len(scored)} ]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
