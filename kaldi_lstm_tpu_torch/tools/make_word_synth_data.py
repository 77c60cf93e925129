"""Generate a word-level synthetic corpus: random lexicon + bigram LM,
word sequences sampled from the LM, expanded through the lexicon and a
monophone transition model into transition-id alignments and Gaussian
emissions. Drives the FULL word-level pipeline end to end:

    make_word_synth_data -> train -> nnet-forward -> decode_faster
        -> compute_wer   (real %WER, not just PER)

Outputs in --dir: final.mdl, words.txt, lexicon.txt, lm.arpa,
feats.{ark,scp}, ali.ark, text (word transcripts). This package's copy
of ``kaldi_lstm_tpu.tools.make_word_synth_data``: at the same flags and
seed it writes the same bytes.

    python -m kaldi_lstm_tpu_torch.tools.make_word_synth_data \\
        --dir data/words --num-words 10 --num-phones 12 --num-utts 80
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.arpa import ArpaBigram
from kaldi_lstm_tpu_torch.io.kaldi_io import MatrixWriter, TableWriter, \
    write_int_vector
from kaldi_lstm_tpu_torch.io.lang import write_text_line, SymbolTable, write_lexicon
from kaldi_lstm_tpu_torch.io.transition_model import \
    make_monophone_transition_model
from kaldi_lstm_tpu_torch.utils import LOG

BOS, EOS, SIL = "<s>", "</s>", "<sil>"


def make_lexicon(rng, num_words: int, num_phones: int,
                 min_pron: int, max_pron: int) -> dict:
    lex: dict[str, list[list[int]]] = {}
    seen = set()
    for i in range(num_words):
        while True:
            n = rng.randint(min_pron, max_pron + 1)
            pron = tuple(rng.randint(2, num_phones + 1, n))  # phone 1=sil
            if pron not in seen:
                seen.add(pron)
                break
        lex[f"w{i:03d}"] = [list(pron)]
    return lex


def make_language(rng, num_words: int, num_phones: int,
                  min_pron: int, max_pron: int, eos_prob: float
                  ) -> tuple[dict, ArpaBigram]:
    """Random unique pronunciations + a random normalized bigram LM with
    full bigram coverage (so decoding with it is exact). DENSE: O(V^2)
    entries — fine to ~1k words; LVCSR scale uses the sparse process
    below (--lm-order 3)."""
    lex = make_lexicon(rng, num_words, num_phones, min_pron, max_pron)
    vocab = sorted(lex)

    lm = ArpaBigram()
    # unigrams: LM marginals are immaterial for generation (we sample
    # from the bigrams); give uniform mass + tiny backoff
    uni = -np.log(num_words + 1)
    for w in vocab + [EOS]:
        lm.unigram[w] = (float(uni), float(np.log(0.1)))
    lm.unigram[BOS] = (-99.0 * np.log(10.0), float(np.log(0.1)))
    for v in [BOS] + vocab:
        probs = rng.dirichlet(np.ones(num_words)) * (1.0 - eos_prob)
        for w, p in zip(vocab, probs):
            lm.bigram[(v, w)] = float(np.log(max(p, 1e-8)))
        if v != BOS:
            lm.bigram[(v, EOS)] = float(np.log(eos_prob))
    return lex, lm


def sample_sentence(rng, lm: ArpaBigram, vocab: list[str],
                    max_words: int) -> list[str]:
    out: list[str] = []
    hist = BOS
    while len(out) < max_words:
        cand = vocab + ([EOS] if hist != BOS else [])
        logps = np.array([lm.bigram[(hist, w)] for w in cand])
        probs = np.exp(logps - logps.max())
        probs /= probs.sum()
        w = cand[rng.choice(len(cand), p=probs)]
        if w == EOS:
            break
        out.append(w)
        hist = w
    return out


def make_sparse_process(rng, vocab: list[str], branch: int):
    """Sparse Markov word process: each word (and BOS) transitions to
    only `branch` successors with Dirichlet weights — the word-sequence
    statistics an estimated n-gram LM can actually model at LVCSR
    vocabulary sizes (a dense random bigram over 10-20k words is both
    O(V^2) and unlearnable)."""
    succ = {}
    for w in [BOS] + vocab:
        ids = rng.choice(len(vocab), branch, replace=False)
        probs = rng.dirichlet(np.ones(branch) * 0.5)
        succ[w] = ([vocab[i] for i in ids], np.asarray(probs))
    return succ


def sample_sentence_sparse(rng, succ, eos_prob: float,
                           max_words: int) -> list[str]:
    out: list[str] = []
    hist = BOS
    while len(out) < max_words:
        if out and rng.rand() < eos_prob:
            break
        ws, ps = succ[hist]
        hist = ws[rng.choice(len(ws), p=ps)]
        out.append(hist)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate a word-level "
                                "synthetic corpus (lexicon + bigram LM)")
    p.add_argument("--dir", required=True)
    p.add_argument("--num-words", type=int, default=10)
    p.add_argument("--num-phones", type=int, default=12,
                   help="phone 1 is reserved for optional silence")
    p.add_argument("--states-per-phone", type=int, default=3)
    p.add_argument("--num-utts", type=int, default=80)
    p.add_argument("--feat-dim", type=int, default=20)
    p.add_argument("--min-pron", type=int, default=2)
    p.add_argument("--max-pron", type=int, default=4)
    p.add_argument("--max-words", type=int, default=12)
    p.add_argument("--eos-prob", type=float, default=0.2)
    p.add_argument("--sil-prob", type=float, default=0.0,
                   help="probability of silence between words")
    p.add_argument("--self-loop-prob", type=float, default=0.6)
    p.add_argument("--emission-noise", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mean-seed", type=int, default=42)
    p.add_argument("--lm-order", type=int, default=2, choices=(2, 3),
                   help="2 = dense random bigram (exact, <=~1k words); "
                        "3 = LVCSR mode: sparse Markov word process + "
                        "COUNTED Witten-Bell trigram ARPA estimated "
                        "from --lm-train-sents samples (real "
                        "estimation mismatch, scales to 10-20k words)")
    p.add_argument("--lm-branch", type=int, default=16,
                   help="successors per word in the sparse process "
                        "(--lm-order 3)")
    p.add_argument("--lm-train-sents", type=int, default=30000,
                   help="sampled sentences the trigram is counted from")
    args = p.parse_args(argv)

    os.makedirs(args.dir, exist_ok=True)
    d = args.dir
    rng = np.random.RandomState(args.seed)

    if args.lm_order == 3:
        from kaldi_lstm_tpu_torch.io.arpa import write_counted_arpa
        lex = make_lexicon(rng, args.num_words, args.num_phones,
                           args.min_pron, args.max_pron)
        vocab = sorted(lex)
        succ = make_sparse_process(rng, vocab, args.lm_branch)
        lm_sents = [sample_sentence_sparse(rng, succ, args.eos_prob,
                                           args.max_words)
                    for _ in range(args.lm_train_sents)]
        # unigram coverage so every word decodes (standard OOV guard)
        lm_sents += [[w] for w in vocab]
        counts = write_counted_arpa(f"{d}/lm.arpa", lm_sents, order=3)
        LOG(f"counted trigram LM: {counts}")
        lm = None
    else:
        lex, lm = make_language(rng, args.num_words, args.num_phones,
                                args.min_pron, args.max_pron,
                                args.eos_prob)
        vocab = sorted(lex)
        succ = None
    write_lexicon(f"{d}/lexicon.txt", lex)
    if lm is not None:
        lm.save(f"{d}/lm.arpa")
    words = SymbolTable()
    words.add("<eps>", 0)
    for w in vocab:
        words.add(w)
    words.save(f"{d}/words.txt")

    tm = make_monophone_transition_model(args.num_phones,
                                         args.states_per_phone,
                                         args.self_loop_prob)
    tm.dump(f"{d}/final.mdl")

    mean_rng = np.random.RandomState(args.mean_seed)
    means = mean_rng.randn(tm.num_pdfs, args.feat_dim).astype(np.float32)

    def phone_frames(ph: int, tids: list, pdfs: list) -> None:
        for s in range(args.states_per_phone):
            ts = (ph - 1) * args.states_per_phone + s + 1
            base = tm.state2id[ts]
            pdf = (ph - 1) * args.states_per_phone + s
            while rng.rand() < args.self_loop_prob:
                tids.append(base + 0)
                pdfs.append(pdf)
            tids.append(base + 1)
            pdfs.append(pdf)

    frames = 0
    with MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as fw, \
            TableWriter(f"ark:{d}/ali.ark", write_int_vector) as aw, \
            TableWriter(f"ark,t:{d}/text", write_text_line,
                        binary=False) as tw:
        def draw():
            if succ is not None:
                return sample_sentence_sparse(rng, succ, args.eos_prob,
                                              args.max_words)
            return sample_sentence(rng, lm, vocab, args.max_words)

        for i in range(args.num_utts):
            sent = draw()
            while not sent:  # decoder targets need >= 1 word
                sent = draw()
            tids: list[int] = []
            pdfs: list[int] = []
            for j, w in enumerate(sent):
                if args.sil_prob > 0 and rng.rand() < args.sil_prob:
                    phone_frames(1, tids, pdfs)
                pron = lex[w][rng.randint(len(lex[w]))]
                for ph in pron:
                    phone_frames(ph, tids, pdfs)
            if args.sil_prob > 0 and rng.rand() < args.sil_prob:
                phone_frames(1, tids, pdfs)
            pdfs_arr = np.asarray(pdfs)
            feats = (means[pdfs_arr]
                     + rng.randn(len(pdfs), args.feat_dim).astype(
                         np.float32) * args.emission_noise)
            key = f"utt{i:05d}"
            fw.write(key, feats.astype(np.float32))
            aw.write(key, np.asarray(tids, np.int32))
            tw.write(key, sent)
            frames += len(pdfs)
    LOG(f"Wrote {args.num_utts} word-level utterances ({frames} frames), "
        f"{args.num_words}-word lexicon, "
        f"{'counted trigram' if args.lm_order == 3 else 'bigram'} LM, "
        f"final.mdl ({tm.num_pdfs} pdfs) to {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
