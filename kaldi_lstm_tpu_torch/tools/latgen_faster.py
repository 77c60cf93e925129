"""Lattice-generating word decoder — upstream `latgen-faster-mapped`,
self-contained; this package's copy of
``kaldi_lstm_tpu.tools.latgen_faster``:

    python -m kaldi_lstm_tpu_torch.tools.latgen_faster final.mdl \\
        lexicon.txt lm.arpa ark:loglik.ark ark:lat.ark \\
        --transcript-wspecifier=ark,t:hyp.txt \\
        --acoustic-scale=0.1 --beam=16 --lattice-beam=8

Writes CompactLattice arks in the upstream wire format (binary by
default, `ark,t:` for text) readable by Kaldi's lattice-* tools, plus
optional best-path transcripts. The lattice forward runs in the native
core (csrc/kltdecode.cc), which needs g++ and never falls back to numpy
on its own (`KLT_DECODE_IMPL=python` asks for the numpy forward).
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.determinize import (
    DeterminizeError,
    determinize_lattice,
)
from kaldi_lstm_tpu_torch.decode.lattice_faster import decode_lattice_faster
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.lang import write_text_line
from kaldi_lstm_tpu_torch.io.lattice import LatticeWriter, lattice_best_path
from kaldi_lstm_tpu_torch.tools.decode_faster import (
    add_graph_args,
    bounded_map,
    graph_from_args,
)
from kaldi_lstm_tpu_torch.utils import LOG


def add_latgen_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--transcript-wspecifier", default="",
                   help="also write best-path transcripts")
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--lattice-beam", type=float, default=8.0)
    p.add_argument("--max-active", type=int, default=0)
    p.add_argument("--raw", action="store_true",
                   help="write state-level Lattices instead of "
                        "CompactLattices")
    p.add_argument("--determinize-lattice", default="true",
                   help="keep only the best alignment per word sequence "
                        "(upstream latgen default); false = raw "
                        "state-level structure, arc-converted")
    p.add_argument("--max-det-states", type=int, default=200000)
    p.add_argument("--num-threads", type=int, default=1,
                   help="generate this many lattices concurrently (the "
                        "native forward releases the GIL; determinize "
                        "and lattice build stay Python)")


def latgen_source(tm, graph, source, args) -> int:
    """Lattice-generate over a stream of (key, loglik-matrix) pairs —
    the tool core, shared by the ark-reading CLI and the fused
    score->decode path (nnet_decode.py). `args` carries the
    add_latgen_args flags plus lattice_wspecifier/word_symbol_table."""
    determinize = (str(args.determinize_lattice).lower()
                   in ("true", "1", "yes")) and not args.raw
    tw = None
    if args.transcript_wspecifier:
        tw = TableWriter(args.transcript_wspecifier, write_text_line,
                         binary=False)
    n, total_frames, total_cost, no_final = 0, 0, 0.0, 0
    id2sym = graph.words.id2sym

    def _gen_one(item):
        key, mat = item
        if mat.shape[1] < tm.num_pdfs:
            raise ValueError(
                f"latgen_faster: {key}: loglik dim {mat.shape[1]} "
                f"< model pdfs {tm.num_pdfs}")
        lat = decode_lattice_faster(
            graph, mat, args.acoustic_scale, args.beam,
            args.lattice_beam, args.max_active)
        out_lat = lat
        if determinize:
            try:
                out_lat = determinize_lattice(
                    lat, max_states=args.max_det_states)
            except DeterminizeError as e:
                # upstream convention: warn and keep the raw lattice
                LOG(f"WARNING: {key}: {e}; writing raw lattice")
                out_lat = lat
        return key, mat.shape[0], lat, out_lat

    results = bounded_map(_gen_one, source, args.num_threads, graph)
    try:
        with LatticeWriter(args.lattice_wspecifier,
                           compact=not args.raw) as lw:
            for key, nframes, lat, out_lat in results:
                lw.write(key, out_lat)
                if tw is not None:
                    wids, _tids, cost = lattice_best_path(lat)
                    tw.write(key, [id2sym[i] for i in wids]
                             if args.word_symbol_table else wids)
                    total_cost += cost
                n += 1
                total_frames += nframes
                no_final += 0 if lat.reached_final else 1
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if tw is not None:
        tw.close()
        LOG(f"best-path avg cost per frame "
            f"{total_cost / max(total_frames, 1):.4f}")
    LOG(f"Generated lattices for {n} utterances"
        + (f"; {no_final} did not reach a final state" if no_final else ""))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Lattice-generating Viterbi decoding over an HCLG "
                    "graph built from model + lexicon + ARPA LM")
    add_graph_args(p)
    p.add_argument("loglik_rspecifier")
    p.add_argument("lattice_wspecifier")
    add_latgen_args(p)
    args = p.parse_args(argv)

    tm, graph = graph_from_args(args)
    return latgen_source(
        tm, graph, SequentialMatrixReader(args.loglik_rspecifier), args)


if __name__ == "__main__":
    sys.exit(main())
