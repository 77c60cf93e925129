"""Oracle word-error rate of lattices — upstream lattice-oracle: the
minimum edit distance between the reference transcript and ANY path
through the lattice (how good the lattice is, independent of scores).

    python -m kaldi_lstm_tpu_torch.tools.lattice_oracle ark:lat.ark \\
        ark,t:text [--word-symbol-table words.txt] \\
        [--oracle-wspecifier ark,t:oracle.txt]
"""

from __future__ import annotations

import argparse
import heapq
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import TableWriter
from kaldi_lstm_tpu_torch.io.lang import (
    SymbolTable,
    read_text_table,
    write_text_line,
)
from kaldi_lstm_tpu_torch.io.lattice import (
    CompactLattice,
    SequentialLatticeReader,
)
from kaldi_lstm_tpu_torch.utils import LOG


def lattice_oracle(lat, ref: list) -> tuple:
    """Minimum-edit-distance path: returns (errors, oracle word ids).
    Works on Lattice (words on olabel) or CompactLattice (label).
    Dijkstra over (lattice state, reference position) with unit
    substitution/insertion/deletion costs."""
    compact = isinstance(lat, CompactLattice)
    n_ref = len(ref)
    start = (lat.start, 0)
    dist = {start: 0}
    back: dict = {start: None}
    heap = [(0, lat.start, 0)]
    finals = lat.final
    best_end = None

    def relax(cost, node, prev, word):
        if cost < dist.get(node, 1 << 30):
            dist[node] = cost
            back[node] = (prev, word)
            heapq.heappush(heap, (cost, node[0], node[1]))

    while heap:
        c, s, j = heapq.heappop(heap)
        if c > dist.get((s, j), 1 << 30):
            continue
        if s in finals and j == n_ref:
            best_end = (s, j)
            break
        if j < n_ref:                       # deletion of ref[j]
            relax(c + 1, (s, j + 1), (s, j), 0)
        for a in lat.arcs[s]:
            w = a.label if compact else a.olabel
            if w == 0:
                relax(c, (a.dst, j), (s, j), 0)
                continue
            if j < n_ref:                   # match / substitution
                step = 0 if ref[j] == w else 1
                relax(c + step, (a.dst, j + 1), (s, j), w)
            relax(c + 1, (a.dst, j), (s, j), w)   # insertion of w
    if best_end is None:
        raise RuntimeError("lattice_oracle: no final state reachable")
    words = []
    node = best_end
    while back[node] is not None:
        prev, w = back[node]
        if w:
            words.append(w)
        node = prev
    words.reverse()
    return dist[best_end], words


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Oracle %WER: best path through each lattice "
                    "against the reference transcript")
    p.add_argument("lattice_rspecifier")
    p.add_argument("reference", help="text file: key word word ...")
    p.add_argument("--word-symbol-table", default="",
                   help="required when references are word strings")
    p.add_argument("--oracle-wspecifier", default="",
                   help="also write the oracle transcripts")
    args = p.parse_args(argv)

    words = (SymbolTable.load(args.word_symbol_table)
             if args.word_symbol_table else None)
    refs = read_text_table(args.reference)
    ow = (TableWriter(args.oracle_wspecifier, write_text_line,
                      binary=False) if args.oracle_wspecifier else None)

    n = no_ref = 0
    errs = ref_words = 0
    for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
        ref = refs.get(key)
        if ref is None:
            LOG(f"WARNING: {key}: no reference, skipping")
            no_ref += 1
            continue
        if words is not None:
            ref_ids = [words[w] for w in ref]
        else:
            ref_ids = [int(w) for w in ref]
        e, oracle = lattice_oracle(lat, ref_ids)
        errs += e
        ref_words += len(ref_ids)
        n += 1
        if ow is not None:
            ow.write(key, [words.id2sym[i] for i in oracle]
                     if words is not None else oracle)
    if ow is not None:
        ow.close()
    pct = 100.0 * errs / max(ref_words, 1)
    print(f"%WER {pct:.2f} [ {errs} / {ref_words} ] (oracle, "
          f"{n} lattices)")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
