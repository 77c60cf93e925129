"""Language resources for word-level decoding: symbol tables and the
pronunciation lexicon — this package's copy of
``kaldi_lstm_tpu.io.lang``.

Upstream Kaldi keeps these in its lang directory (`words.txt`,
`L.fst`); these are self-contained equivalents in the upstream text
formats, so real Kaldi lang files cross-load.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SymbolTable:
    """OpenFst-style symbol table (`words.txt`: "<symbol> <id>" lines).
    id 0 is conventionally <eps>."""

    sym2id: dict = field(default_factory=dict)
    id2sym: dict = field(default_factory=dict)
    # one past the largest id, so that `add` is O(1): a 10k-word table
    # is built for every utterance an alignment graph is made for
    _next: int = field(default=0, init=False, repr=False, compare=False)

    def __post_init__(self):
        self._next = max(self.id2sym, default=-1) + 1

    def add(self, sym: str, idx: int | None = None) -> int:
        if sym in self.sym2id:
            return self.sym2id[sym]
        if idx is None:
            idx = self._next
        if idx in self.id2sym:
            raise ValueError(f"duplicate symbol id {idx}")
        self.sym2id[sym] = idx
        self.id2sym[idx] = sym
        self._next = max(self._next, idx + 1)
        return idx

    def __contains__(self, sym: str) -> bool:
        return sym in self.sym2id

    def __getitem__(self, sym: str) -> int:
        return self.sym2id[sym]

    def save(self, filename: str) -> None:
        with open(filename, "w") as f:
            for idx in sorted(self.id2sym):
                f.write(f"{self.id2sym[idx]} {idx}\n")

    @classmethod
    def load(cls, filename: str) -> "SymbolTable":
        t = cls()
        with open(filename) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) != 2:
                    raise ValueError(f"bad symbol-table line: {line!r}")
                t.add(parts[0], int(parts[1]))
        return t


def read_lexicon(filename: str, phones: SymbolTable | None = None
                 ) -> dict[str, list[list[int]]]:
    """`lexicon.txt`: "word phone1 phone2 ..." (multiple lines = multiple
    pronunciations). Phones are integer ids unless a phone symbol table is
    given. Returns word -> list of pronunciations (phone-id lists)."""
    lex: dict[str, list[list[int]]] = {}
    with open(filename) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(
                    f"{filename}:{ln}: lexicon entry with no phones")
            word = parts[0]
            if phones is not None:
                pron = [phones[p] for p in parts[1:]]
            else:
                pron = [int(p) for p in parts[1:]]
            lex.setdefault(word, []).append(pron)
    return lex


def write_lexicon(filename: str, lex: dict[str, list[list[int]]]) -> None:
    with open(filename, "w") as f:
        for word in sorted(lex):
            for pron in lex[word]:
                f.write(word + " " + " ".join(str(p) for p in pron)
                        + "\n")


def read_text_table(path: str) -> dict:
    """`key word word ...` text table (transcripts / references).
    Accepts a plain path or an `ark[,t]:path` rspecifier."""
    if ":" in path and path.split(":", 1)[0].split(",")[0] in ("ark",
                                                              "scp"):
        path = path.split(":", 1)[1]
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def write_text_line(out, words) -> None:
    """TableWriter value callback for text transcript tables."""
    out.stream.write((" ".join(str(w) for w in words) + "\n").encode())
