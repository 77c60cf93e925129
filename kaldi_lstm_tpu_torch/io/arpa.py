"""ARPA n-gram language model reader/writer (unigram + bigram with
backoff), natural-log API over the format's log10 fields.

Supplies the G side of the decoding graph (upstream Kaldi compiles an
ARPA file into G.fst). This package's copy of the part of
``kaldi_lstm_tpu.io.arpa`` that the decoders and the word corpus
generator use, and the LM-rescoring checks: `ArpaBigram` writes (and
`load`s) the dense random bigram; `ArpaLM` reads any order, and
decode/graph.py's build_decoding_graph_ngram expands it into history
states — the decoder CLIs dispatch on the file's order
(build_graph_from_arpa).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

LN10 = math.log(10.0)
NEG = -1e30  # "no probability" sentinel in natural log


@dataclass
class ArpaBigram:
    # word -> (ln P(word), ln backoff weight)
    unigram: dict = field(default_factory=dict)
    # (w1, w2) -> ln P(w2 | w1)
    bigram: dict = field(default_factory=dict)

    @property
    def vocab(self) -> list:
        return sorted(self.unigram)

    def logp_unigram(self, w: str) -> float:
        return self.unigram.get(w, (NEG, 0.0))[0]

    def backoff(self, w: str) -> float:
        return self.unigram.get(w, (NEG, 0.0))[1]

    def logp(self, hist: str, w: str) -> float:
        """ln P(w | hist) with standard backoff:
        bigram if present, else backoff(hist) + unigram(w)."""
        p = self.bigram.get((hist, w))
        if p is not None:
            return p
        return self.backoff(hist) + self.logp_unigram(w)

    def score_sentence(self, words: list[str],
                       bos: str = "<s>", eos: str = "</s>") -> float:
        """ln P(words </s> | <s>) — the quantity G contributes to a
        decoding path."""
        total, hist = 0.0, bos
        for w in list(words) + [eos]:
            total += self.logp(hist, w)
            hist = w
        return total

    # -- serialization -----------------------------------------------------
    def save(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write("\\data\\\n")
            f.write(f"ngram 1={len(self.unigram)}\n")
            f.write(f"ngram 2={len(self.bigram)}\n")
            f.write("\n\\1-grams:\n")
            for w in sorted(self.unigram):
                lp, bo = self.unigram[w]
                if bo != 0.0:
                    f.write(f"{lp / LN10:.6f}\t{w}\t{bo / LN10:.6f}\n")
                else:
                    f.write(f"{lp / LN10:.6f}\t{w}\n")
            f.write("\n\\2-grams:\n")
            for (w1, w2) in sorted(self.bigram):
                f.write(f"{self.bigram[(w1, w2)] / LN10:.6f}\t{w1} {w2}\n")
            f.write("\n\\end\\\n")

    @classmethod
    def load(cls, filename: str, log_fn=None) -> "ArpaBigram":
        lm = cls()
        section = None
        truncated = 0
        with open(filename, errors="replace") as f:
            for ln, raw in enumerate(f, 1):
                line = raw.strip()
                if not line:
                    continue
                low = line.lower()
                if low == "\\data\\":
                    section = "data"
                    continue
                if low.endswith("-grams:") and low.startswith("\\"):
                    section = int(line[1:line.index("-")])
                    continue
                if low == "\\end\\":
                    section = "end"
                    continue
                if section == "data" or section == "end":
                    continue
                if section is None:
                    continue  # header junk before \data\
                parts = line.split()
                if section == 1:
                    if len(parts) not in (2, 3):
                        raise ValueError(
                            f"{filename}:{ln}: bad 1-gram line {line!r}")
                    lp = float(parts[0]) * LN10
                    bo = float(parts[2]) * LN10 if len(parts) == 3 else 0.0
                    lm.unigram[parts[1]] = (lp, bo)
                elif section == 2:
                    # bigram backoff weights (4th field) belong to
                    # trigrams; drop them with the truncation warning
                    if len(parts) not in (3, 4):
                        raise ValueError(
                            f"{filename}:{ln}: bad 2-gram line {line!r}")
                    lm.bigram[(parts[1], parts[2])] = float(parts[0]) * LN10
                    if len(parts) == 4:
                        truncated += 1
                else:
                    truncated += 1
        if truncated and log_fn is not None:
            log_fn(f"ArpaBigram: dropped {truncated} n-gram entries above "
                   f"order 2 (decoder graph is bigram)")
        if not lm.unigram:
            raise ValueError(f"{filename}: no unigrams found — not an "
                             "ARPA file?")
        return lm


def uniform_unigram(words: list[str], eos: str = "</s>") -> ArpaBigram:
    """Uniform unigram LM over `words` + sentence end — the no-LM decoding
    grammar (every word equally likely, any length)."""
    vocab = list(dict.fromkeys(list(words) + [eos]))  # dedupe, keep order
    lp = -math.log(len(vocab))
    lm = ArpaBigram()
    for w in vocab:
        lm.unigram[w] = (lp, 0.0)
    return lm


@dataclass
class ArpaLM:
    """General-order ARPA n-gram LM (natural-log API), read by the
    decoder CLIs (decode/graph.py build_graph_from_arpa: order <= 2
    through the bigram builder, higher orders through the n-gram
    history expansion).

    ngrams[k] maps a k-tuple of words to (ln prob, ln backoff); backoff
    is 0.0 when absent (standard ARPA semantics).
    """
    order: int = 0
    ngrams: dict = field(default_factory=dict)  # k -> {tuple: (lp, bo)}

    @property
    def vocab(self) -> list:
        return sorted(w for (w,) in self.ngrams.get(1, {}))

    def cond_logp(self, hist: tuple, w: str) -> float:
        """ln P(w | hist) with standard recursive backoff. `hist` is a
        tuple of preceding words (any length; only the last order-1
        matter)."""
        hist = tuple(hist)[-(self.order - 1):] if self.order > 1 else ()
        ent = self.ngrams.get(len(hist) + 1, {}).get(hist + (w,))
        if ent is not None:
            return ent[0]
        if not hist:
            return NEG  # OOV
        # back off: drop the oldest history word, pay hist's backoff
        bo = self.ngrams.get(len(hist), {}).get(hist, (0.0, 0.0))[1]
        return bo + self.cond_logp(hist[1:], w)

    def score_sentence(self, words: list, bos: str = "<s>",
                       eos: str = "</s>") -> float:
        total = 0.0
        hist: tuple = (bos,)
        for w in list(words) + [eos]:
            total += self.cond_logp(hist, w)
            hist = hist + (w,)
        return total

    @classmethod
    def load(cls, filename: str, log_fn=None) -> "ArpaLM":
        lm = cls()
        section = None
        with open(filename, errors="replace") as f:
            for ln, raw in enumerate(f, 1):
                line = raw.strip()
                if not line:
                    continue
                low = line.lower()
                if low == "\\data\\":
                    section = "data"
                    continue
                if low.endswith("-grams:") and low.startswith("\\"):
                    section = int(line[1:line.index("-")])
                    lm.order = max(lm.order, section)
                    lm.ngrams.setdefault(section, {})
                    continue
                if low == "\\end\\":
                    section = "end"
                    continue
                if section in ("data", "end", None):
                    continue
                parts = line.split()
                k = section
                if len(parts) == k + 1:
                    lp, bo = float(parts[0]) * LN10, 0.0
                elif len(parts) == k + 2:
                    lp, bo = (float(parts[0]) * LN10,
                              float(parts[-1]) * LN10)
                else:
                    raise ValueError(
                        f"{filename}:{ln}: bad {k}-gram line {line!r}")
                lm.ngrams[k][tuple(parts[1:k + 1])] = (lp, bo)
        if not lm.ngrams.get(1):
            raise ValueError(f"{filename}: no unigrams found — not an "
                             "ARPA file?")
        if log_fn is not None:
            counts = {k: len(v) for k, v in lm.ngrams.items()}
            log_fn(f"ArpaLM: order {lm.order}, counts {counts}")
        return lm


def write_counted_arpa(path: str, sents: list, order: int = 3,
                       gamma: float = 0.15, bos: str = "<s>",
                       eos: str = "</s>") -> dict:
    """Estimate a backoff n-gram LM (Witten-Bell-flavoured constant
    discount) from tokenized sentences and write standard ARPA.

    This is the LVCSR-scale counterpart of make_word_synth_data's dense
    random bigram (which is O(V^2) entries and unusable past ~1k
    words): counts are SPARSE, so a 10-20k-word trigram stays in the
    millions of entries like a real estimated LM. Backoff weights are
    mass-normalized per history:

        p(w|h)  = (1 - gamma) * c(hw)/c(h)       for seen continuations
        bo(h)   = gamma / (1 - sum_seen p_lower(w|h'))

    Returns {order: num_entries} for logging."""
    assert order in (2, 3)
    c1: dict = {}
    c2: dict = {}
    c3: dict = {}
    ntok = 0
    for s in sents:
        toks = [bos] + list(s) + [eos]
        for w in toks[1:]:
            c1[w] = c1.get(w, 0) + 1
            ntok += 1
        for a, b in zip(toks, toks[1:]):
            c2[(a, b)] = c2.get((a, b), 0) + 1
        if order >= 3:
            for a, b, c in zip(toks, toks[1:], toks[2:]):
                c3[(a, b, c)] = c3.get((a, b, c), 0) + 1

    uni_p = {w: c / ntok for w, c in c1.items()}
    h2: dict = {}
    for (a, _b), c in c2.items():
        h2[a] = h2.get(a, 0) + c
    # per-history backoff: leftover mass over the lower order's mass of
    # this history's SEEN continuations
    seen2: dict = {}
    for (a, b) in c2:
        seen2.setdefault(a, []).append(b)
    bo2 = {}
    for a, ws in seen2.items():
        s_low = sum(uni_p.get(w, 0.0) for w in ws)
        bo2[a] = gamma / max(1e-9, 1.0 - min(0.999, s_low))

    def p2(a, b):
        c = c2.get((a, b))
        if c:
            return (1 - gamma) * c / h2[a]
        return bo2.get(a, gamma) * uni_p.get(b, 1e-12)

    h3: dict = {}
    bo3: dict = {}
    if order >= 3:
        for (a, b, _c), n in c3.items():
            h3[(a, b)] = h3.get((a, b), 0) + n
        seen3: dict = {}
        for (a, b, c) in c3:
            seen3.setdefault((a, b), []).append(c)
        for (a, b), ws in seen3.items():
            s_low = sum(p2(b, w) for w in ws)
            bo3[(a, b)] = gamma / max(1e-9, 1.0 - min(0.999, s_low))

    lines = ["\\data\\", f"ngram 1={len(c1) + 1}",
             f"ngram 2={len(c2)}"]
    if order >= 3:
        lines.append(f"ngram 3={len(c3)}")
    lines += ["", "\\1-grams:",
              f"-99\t{bos}\t{math.log10(bo2.get(bos, gamma)):.6f}"]
    for w, p in uni_p.items():
        line = f"{math.log10(max(p * (1 - gamma), 1e-12)):.6f}\t{w}"
        if w in bo2:
            line += f"\t{math.log10(bo2[w]):.6f}"
        lines.append(line)
    lines += ["", "\\2-grams:"]
    for (a, b), c in c2.items():
        line = f"{math.log10((1 - gamma) * c / h2[a]):.6f}\t{a} {b}"
        if order >= 3 and (a, b) in bo3:
            line += f"\t{math.log10(bo3[(a, b)]):.6f}"
        lines.append(line)
    if order >= 3:
        lines += ["", "\\3-grams:"]
        for (a, b, c), n in c3.items():
            lines.append(f"{math.log10((1 - gamma) * n / h3[(a, b)]):.6f}"
                         f"\t{a} {b} {c}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    out = {1: len(c1) + 1, 2: len(c2)}
    if order >= 3:
        out[3] = len(c3)
    return out


def bigram_as_arpalm(bg: ArpaBigram) -> ArpaLM:
    """View an ArpaBigram through the general interface (ArpaLM keys
    are WORD TUPLES at every order, including unigrams)."""
    lm = ArpaLM(order=2)
    lm.ngrams[1] = {(w,): v for w, v in bg.unigram.items()}
    lm.ngrams[2] = {k: (v, 0.0) for k, v in bg.bigram.items()}
    return lm


def write_counted_arpa(path: str, sents: list, order: int = 3,
                       gamma: float = 0.15, bos: str = "<s>",
                       eos: str = "</s>") -> dict:
    """Estimate a backoff n-gram LM (Witten-Bell-flavoured constant
    discount) from tokenized sentences and write standard ARPA.

    This is the LVCSR-scale counterpart of make_word_synth_data's dense
    random bigram (which is O(V^2) entries and unusable past ~1k
    words): counts are SPARSE, so a 10-20k-word trigram stays in the
    millions of entries like a real estimated LM. Backoff weights are
    mass-normalized per history:

        p(w|h)  = (1 - gamma) * c(hw)/c(h)       for seen continuations
        bo(h)   = gamma / (1 - sum_seen p_lower(w|h'))

    Returns {order: num_entries} for logging."""
    assert order in (2, 3)
    c1: dict = {}
    c2: dict = {}
    c3: dict = {}
    ntok = 0
    for s in sents:
        toks = [bos] + list(s) + [eos]
        for w in toks[1:]:
            c1[w] = c1.get(w, 0) + 1
            ntok += 1
        for a, b in zip(toks, toks[1:]):
            c2[(a, b)] = c2.get((a, b), 0) + 1
        if order >= 3:
            for a, b, c in zip(toks, toks[1:], toks[2:]):
                c3[(a, b, c)] = c3.get((a, b, c), 0) + 1

    uni_p = {w: c / ntok for w, c in c1.items()}
    h2: dict = {}
    for (a, _b), c in c2.items():
        h2[a] = h2.get(a, 0) + c
    # per-history backoff: leftover mass over the lower order's mass of
    # this history's SEEN continuations
    seen2: dict = {}
    for (a, b) in c2:
        seen2.setdefault(a, []).append(b)
    bo2 = {}
    for a, ws in seen2.items():
        s_low = sum(uni_p.get(w, 0.0) for w in ws)
        bo2[a] = gamma / max(1e-9, 1.0 - min(0.999, s_low))

    def p2(a, b):
        c = c2.get((a, b))
        if c:
            return (1 - gamma) * c / h2[a]
        return bo2.get(a, gamma) * uni_p.get(b, 1e-12)

    h3: dict = {}
    bo3: dict = {}
    if order >= 3:
        for (a, b, _c), n in c3.items():
            h3[(a, b)] = h3.get((a, b), 0) + n
        seen3: dict = {}
        for (a, b, c) in c3:
            seen3.setdefault((a, b), []).append(c)
        for (a, b), ws in seen3.items():
            s_low = sum(p2(b, w) for w in ws)
            bo3[(a, b)] = gamma / max(1e-9, 1.0 - min(0.999, s_low))

    lines = ["\\data\\", f"ngram 1={len(c1) + 1}",
             f"ngram 2={len(c2)}"]
    if order >= 3:
        lines.append(f"ngram 3={len(c3)}")
    lines += ["", "\\1-grams:",
              f"-99\t{bos}\t{math.log10(bo2.get(bos, gamma)):.6f}"]
    for w, p in uni_p.items():
        line = f"{math.log10(max(p * (1 - gamma), 1e-12)):.6f}\t{w}"
        if w in bo2:
            line += f"\t{math.log10(bo2[w]):.6f}"
        lines.append(line)
    lines += ["", "\\2-grams:"]
    for (a, b), c in c2.items():
        line = f"{math.log10((1 - gamma) * c / h2[a]):.6f}\t{a} {b}"
        if order >= 3 and (a, b) in bo3:
            line += f"\t{math.log10(bo3[(a, b)]):.6f}"
        lines.append(line)
    if order >= 3:
        lines += ["", "\\3-grams:"]
        for (a, b, c), n in c3.items():
            lines.append(f"{math.log10((1 - gamma) * n / h3[(a, b)]):.6f}"
                         f"\t{a} {b} {c}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    out = {1: len(c1) + 1, 2: len(c2)}
    if order >= 3:
        out[3] = len(c3)
    return out
