"""Word-level Viterbi beam decoding of scaled log-likelihood matrices
(from nnet_forward) — upstream `decode-faster-mapped`, self-contained;
this package's copy of ``kaldi_lstm_tpu.tools.decode_faster``:

    python -m kaldi_lstm_tpu_torch.tools.decode_faster final.mdl \\
        lexicon.txt lm.arpa ark:loglik.ark ark,t:hyp.txt \\
        --word-symbol-table=words.txt --acoustic-scale=0.1 --beam=16

With --word-symbol-table the output transcripts are word strings,
otherwise word ids. `lm.arpa` may be "none" for a uniform-unigram
grammar over the lexicon. The search runs on the host, in the native
core (csrc/kltdecode.cc), which needs g++ and never falls back to numpy
on its own (`KLT_DECODE_IMPL=python` asks for the numpy decoder).
"""

from __future__ import annotations

import argparse
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from kaldi_lstm_tpu_torch.decode.faster import compile_graph, decode_faster
from kaldi_lstm_tpu_torch.decode.graph import (
    build_decoding_graph,
    build_graph_from_arpa,
)
from kaldi_lstm_tpu_torch.io.arpa import uniform_unigram
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.lang import SymbolTable, read_lexicon, write_text_line
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.utils import LOG


def add_graph_args(p: argparse.ArgumentParser) -> None:
    """The shared graph-building positionals/flags of the word decoders
    (decode_faster / latgen_faster / the fused nnet_decode)."""
    p.add_argument("model")
    p.add_argument("lexicon")
    p.add_argument("arpa", help='ARPA LM file, or "none" for a uniform '
                                "unigram grammar")
    p.add_argument("--word-symbol-table", default="",
                   help="words.txt; output becomes word strings")
    p.add_argument("--sil-phone", type=int, default=0)
    p.add_argument("--sil-prob", type=float, default=0.0)


def graph_from_args(args):
    """(TransitionModel, DecodingGraph) from add_graph_args flags."""
    tm = TransitionModel.load(args.model)
    lexicon = read_lexicon(args.lexicon)
    words = (SymbolTable.load(args.word_symbol_table)
             if args.word_symbol_table else None)
    if args.arpa == "none":
        graph = build_decoding_graph(tm, lexicon,
                                     uniform_unigram(sorted(lexicon)),
                                     words=words,
                                     sil_phone=args.sil_phone,
                                     sil_prob=args.sil_prob)
    else:
        # any ARPA order: <=2 via the bigram builder, higher via the
        # n-gram history expansion (build_decoding_graph_ngram)
        graph = build_graph_from_arpa(tm, lexicon, args.arpa,
                                      words=words,
                                      sil_phone=args.sil_phone,
                                      sil_prob=args.sil_prob, log_fn=LOG)
    LOG(f"decoding graph: {graph.num_states} states, "
        f"{graph.num_arcs()} arcs")
    return tm, graph


def bounded_map(fn, it, num_threads: int, graph):
    """Map fn over (key, mat) items with a bounded-window thread pool
    (the native decoder core releases the GIL), results in input order;
    serial map when num_threads <= 1. At most 2 * num_threads items are
    in flight, so only a few loglik matrices are in memory (Executor.map
    would read the whole source); the pool shuts down when the results
    are exhausted or the generator is closed."""
    if num_threads <= 1:
        return map(fn, it)
    compile_graph(graph)  # build the CSR once, not racily per thread

    def bounded():
        futs: deque = deque()
        with ThreadPoolExecutor(num_threads) as pool:
            for item in it:
                futs.append(pool.submit(fn, item))
                if len(futs) >= 2 * num_threads:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    return bounded()


def decode_source(tm, graph, source, *, acoustic_scale: float,
                  beam: float, max_active: int, trans_wspecifier: str,
                  word_strings: bool, num_threads: int = 1) -> int:
    """Viterbi-decode a stream of (key, loglik-matrix) pairs and write
    transcripts — the tool core, shared by the ark-reading CLI and the
    fused score->decode path (nnet_decode.py), which feeds AmScorer
    output here directly with no intermediate loglik ark."""
    n, total_frames, total_logp, no_final = 0, 0, 0.0, 0
    id2sym = graph.words.id2sym

    def _decode_one(item):
        key, mat = item
        if mat.shape[1] < tm.num_pdfs:
            raise ValueError(
                f"decode_faster: {key}: loglik dim {mat.shape[1]} "
                f"< model pdfs {tm.num_pdfs}")
        return key, mat.shape[0], decode_faster(
            graph, mat, acoustic_scale, beam, max_active)

    results = bounded_map(_decode_one, source, num_threads, graph)
    try:
        with TableWriter(trans_wspecifier, write_text_line,
                         binary=False) as w:
            for key, nframes, res in results:
                if word_strings:
                    w.write(key, [id2sym[i] for i in res.words])
                else:
                    w.write(key, res.words)
                n += 1
                total_frames += nframes
                total_logp += res.score
                no_final += 0 if res.reached_final else 1
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    LOG(f"Decoded {n} utterances, avg log-prob per frame "
        f"{total_logp / max(total_frames, 1):.4f}"
        + (f"; {no_final} did not reach a final state" if no_final else ""))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Word-level Viterbi beam decoding over an "
                    "HCLG graph built from model + lexicon + ARPA LM")
    add_graph_args(p)
    p.add_argument("loglik_rspecifier")
    p.add_argument("trans_wspecifier")
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-active", type=int, default=0)
    p.add_argument("--num-threads", type=int, default=1,
                   help="decode this many utterances concurrently (the "
                        "native core releases the GIL; ~linear in host "
                        "cores)")
    args = p.parse_args(argv)

    tm, graph = graph_from_args(args)
    return decode_source(
        tm, graph, SequentialMatrixReader(args.loglik_rspecifier),
        acoustic_scale=args.acoustic_scale, beam=args.beam,
        max_active=args.max_active,
        trans_wspecifier=args.trans_wspecifier,
        word_strings=bool(args.word_symbol_table),
        num_threads=args.num_threads)


if __name__ == "__main__":
    sys.exit(main())
