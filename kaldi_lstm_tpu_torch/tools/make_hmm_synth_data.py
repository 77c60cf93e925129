"""Generate an HMM-structured synthetic corpus: a monophone transition
model, utterances sampled from it (phone sequences -> state paths ->
Gaussian emissions), TRANSITION-ID alignments, and reference phone
transcripts.

Unlike make_synth_data (frame-level labels), this drives the full
reference pipeline shape end to end:

    ali-to-pdf final.mdl ark:ali.ark ark:- | ali-to-post ark:- ark:post
    train -> class counts -> nnet-forward -> decode-viterbi -> compute-wer

    python -m kaldi_lstm_tpu_torch.tools.make_hmm_synth_data --dir data/hmm \\
        --num-phones 8 --feat-dim 20 --num-utts 60

This package's copy of ``kaldi_lstm_tpu.tools.make_hmm_synth_data``:
host numpy on the port's io/kaldi_io.py, the same arguments, log lines
and output bytes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    TableWriter,
    write_int_vector,
)
from kaldi_lstm_tpu_torch.io.lang import write_text_line
from kaldi_lstm_tpu_torch.io.transition_model import (
    make_monophone_transition_model,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate an HMM-structured "
                                "synthetic corpus with transition-id "
                                "alignments")
    p.add_argument("--dir", required=True)
    p.add_argument("--num-phones", type=int, default=8)
    p.add_argument("--states-per-phone", type=int, default=3)
    p.add_argument("--num-utts", type=int, default=60)
    p.add_argument("--feat-dim", type=int, default=20)
    p.add_argument("--min-phones", type=int, default=4)
    p.add_argument("--max-phones", type=int, default=12)
    p.add_argument("--self-loop-prob", type=float, default=0.6)
    p.add_argument("--emission-noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mean-seed", type=int, default=42,
                   help="Seed of the per-pdf emission means — keep it "
                        "the SAME across train/test splits")
    args = p.parse_args(argv)

    os.makedirs(args.dir, exist_ok=True)
    tm = make_monophone_transition_model(args.num_phones,
                                         args.states_per_phone,
                                         args.self_loop_prob)
    tm.dump(os.path.join(args.dir, "final.mdl"))

    mean_rng = np.random.RandomState(args.mean_seed)
    means = mean_rng.randn(tm.num_pdfs, args.feat_dim).astype(np.float32)
    rng = np.random.RandomState(args.seed)

    d = args.dir
    frames = 0
    with MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as fw, \
            TableWriter(f"ark:{d}/ali.ark", write_int_vector) as aw, \
            TableWriter(f"ark,t:{d}/text", write_text_line,
                        binary=False) as tw:
        for i in range(args.num_utts):
            nph = rng.randint(args.min_phones, args.max_phones + 1)
            phone_seq = rng.randint(1, args.num_phones + 1, nph)
            tids = []
            pdfs = []
            for ph in phone_seq:
                for s in range(args.states_per_phone):
                    ts = (ph - 1) * args.states_per_phone + s + 1
                    base = tm.state2id[ts]
                    pdf = (ph - 1) * args.states_per_phone + s
                    # geometric dwell: self-loop (transition index 0)
                    # then forward (index 1)
                    while rng.rand() < args.self_loop_prob:
                        tids.append(base + 0)
                        pdfs.append(pdf)
                    tids.append(base + 1)
                    pdfs.append(pdf)
            pdfs = np.asarray(pdfs)
            feats = (means[pdfs]
                     + rng.randn(len(pdfs), args.feat_dim).astype(
                         np.float32) * args.emission_noise)
            key = f"utt{i:05d}"
            fw.write(key, feats.astype(np.float32))
            aw.write(key, np.asarray(tids, np.int32))
            tw.write(key, phone_seq.tolist())
            frames += len(pdfs)
    LOG(f"Wrote {args.num_utts} HMM utterances ({frames} frames) + "
        f"final.mdl ({tm.num_pdfs} pdfs) to {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
