"""Convert transition-id alignments to pdf-id alignments using a
transition model — upstream `ali-to-pdf`, the first stage of the target
pipeline (`ali-to-pdf final.mdl ark:ali.ark ark:- | ali-to-post ark:-
ark:-`). Host code.

    python -m kaldi_lstm_tpu_torch.tools.ali_to_pdf final.mdl \\
        ark:ali.ark ark:pdf_ali.ark
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    SequentialIntVectorReader,
    TableWriter,
    write_int_vector,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Converts alignments (containing transition-ids) to "
                    "pdf-id sequences")
    p.add_argument("model")
    p.add_argument("ali_rspecifier")
    p.add_argument("pdf_wspecifier")
    args = p.parse_args(argv)

    tm = TransitionModel.load(args.model)
    reader = SequentialIntVectorReader(args.ali_rspecifier)
    if reader.kind != "ark":
        print("ali_to_pdf: only ark: input supported", file=sys.stderr)
        return 1

    n = 0
    with TableWriter(args.pdf_wspecifier, write_int_vector) as w:
        for key, ali in reader:
            w.write(key, tm.transition_ids_to_pdfs(ali))
            n += 1
    LOG(f"Converted {n} alignments to pdf sequences "
        f"(model: {tm.num_pdfs} pdfs, "
        f"{tm.num_transition_ids} transition-ids)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
