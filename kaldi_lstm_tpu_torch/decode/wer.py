"""Word/phone error rate (this package's copy of
``kaldi_lstm_tpu.decode.wer``): Levenshtein alignment with insertion /
deletion / substitution counts, reported in upstream compute-wer's
format (`%WER 12.34 [ 56 / 454, 10 ins, 20 del, 26 sub ]`) so recipe
scripts can grep the same line."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class EditStats:
    errors: int = 0
    ref_len: int = 0
    ins: int = 0
    dele: int = 0
    sub: int = 0
    num_utts: int = 0

    def add(self, other: "EditStats") -> None:
        self.errors += other.errors
        self.ref_len += other.ref_len
        self.ins += other.ins
        self.dele += other.dele
        self.sub += other.sub
        self.num_utts += other.num_utts

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_len, 1)


def edit_distance(ref: Sequence, hyp: Sequence) -> EditStats:
    """Minimum-edit alignment; on ties prefers substitution, then
    deletion, then insertion (upstream LevenshteinEditDistance order)."""
    nr, nh = len(ref), len(hyp)
    # dp[i][j] = (errors, ins, del, sub) best for ref[:i], hyp[:j]
    INF = 1 << 30
    dp = [[(INF, 0, 0, 0)] * (nh + 1) for _ in range(nr + 1)]
    dp[0][0] = (0, 0, 0, 0)
    for j in range(1, nh + 1):
        e, i_, d_, s_ = dp[0][j - 1]
        dp[0][j] = (e + 1, i_ + 1, d_, s_)
    for i in range(1, nr + 1):
        e, i_, d_, s_ = dp[i - 1][0]
        dp[i][0] = (e + 1, i_, d_ + 1, s_)
        for j in range(1, nh + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            e, i_, d_, s_ = dp[i - 1][j - 1]
            best = (e + cost, i_, d_, s_ + cost)
            e, i_, d_, s_ = dp[i - 1][j]
            cand = (e + 1, i_, d_ + 1, s_)
            if cand[0] < best[0]:
                best = cand
            e, i_, d_, s_ = dp[i][j - 1]
            cand = (e + 1, i_ + 1, d_, s_)
            if cand[0] < best[0]:
                best = cand
            dp[i][j] = best
    e, i_, d_, s_ = dp[nr][nh]
    return EditStats(errors=e, ref_len=nr, ins=i_, dele=d_, sub=s_,
                     num_utts=1)


def wer_report(stats: EditStats, what: str = "WER") -> str:
    return (f"%{what} {stats.wer:.2f} [ {stats.errors} / "
            f"{stats.ref_len}, {stats.ins} ins, {stats.dele} del, "
            f"{stats.sub} sub ]")
