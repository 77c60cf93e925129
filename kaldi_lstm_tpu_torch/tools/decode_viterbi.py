"""Phone-loop Viterbi decoder: scaled log-likelihood matrices (from
nnet_forward --apply-log=true --class-frame-counts) + a transition model
-> best phone sequences; the self-contained decoder for phone-level
scoring (PER on synthetic or lexicon-free tasks). Host numpy.

    python -m kaldi_lstm_tpu_torch.tools.decode_viterbi final.mdl \\
        ark:loglik.ark ark,t:hyp.ark --acoustic-scale=1.0
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.viterbi import PhoneLoopGraph, viterbi_decode
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.utils import LOG


def _write_int_line(out, vec) -> None:
    out.stream.write((" ".join(str(int(v)) for v in vec) + "\n").encode())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Viterbi phone-loop decoding of log-likelihood "
                    "matrices")
    p.add_argument("model")
    p.add_argument("loglik_rspecifier")
    p.add_argument("trans_wspecifier")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--phone-insertion-penalty", type=float, default=0.0)
    args = p.parse_args(argv)

    tm = TransitionModel.load(args.model)
    graph = PhoneLoopGraph.from_transition_model(
        tm, args.phone_insertion_penalty)

    n = 0
    total_frames = 0
    total_logp = 0.0
    with TableWriter(args.trans_wspecifier, _write_int_line,
                     binary=False) as w:
        for key, mat in SequentialMatrixReader(args.loglik_rspecifier):
            if mat.shape[1] < tm.num_pdfs:
                print(f"decode_viterbi: {key}: loglik dim {mat.shape[1]} "
                      f"< model pdfs {tm.num_pdfs}", file=sys.stderr)
                return 1
            phones, logp = viterbi_decode(graph, mat,
                                          args.acoustic_scale)
            w.write(key, phones)
            n += 1
            total_frames += mat.shape[0]
            total_logp += logp
    LOG(f"Decoded {n} utterances, avg log-prob per frame "
        f"{total_logp / max(total_frames, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
