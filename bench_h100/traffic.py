"""The one generator of the benchmark's traffic: a mix is a JSON file of
parameters under `traffic/`, and everything a run feeds the program is
drawn here from `--seed`.

An utterance pool holds `pool` utterances whose lengths are the pool's
quantiles of a log-normal law (median `median_frames`, log-spread
`sigma`, clipped to [`min_frames`, `max_frames`]): every seed gets the
same set of lengths, in its own order, so seeds change the data and
not the amount of work. Features are standard normal, `input_dim`
wide; targets are pdf ids in runs of `run_min`..`run_max` frames, as
alignments have. A training feed cycles the pool, each pass in a fresh
seeded order; a scoring feed cycles it in its seeded order, whose
batches hold the same lengths for every seed.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import numpy as np


def rng_for(seed: int, tag: str) -> np.random.Generator:
    """An independent generator per purpose, all from the one seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64] + [ord(c) for c in tag]))


def pool_lengths(spec: dict) -> np.ndarray:
    """The pool's lengths in frames, sorted (the same for every seed)."""
    n = int(spec["pool"])
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    L = np.exp(np.log(spec["median_frames"]) + spec["sigma"] * z)
    return np.clip(np.rint(L), spec["min_frames"],
                   spec["max_frames"]).astype(np.int64)


class Pool(NamedTuple):
    lengths: np.ndarray   # [n] frames, in the seed's order
    feats: list           # [L_u, D] float32 each
    ids: list             # [L_u] int32 each


def seed_order(n: int, group: int, rng: np.random.Generator) -> np.ndarray:
    """An order of the sorted pool: with `group` > 1 the pool is cut once,
    the same way for every seed, into groups of `group` (a fixed shuffle),
    and the seed orders the groups and each group's members, so every
    seed's batches hold the same lengths."""
    if group <= 1:
        return rng.permutation(n)
    canon = np.random.default_rng(0).permutation(n)
    groups = [canon[i:i + group] for i in range(0, n, group)]
    return np.concatenate([groups[g][rng.permutation(len(groups[g]))]
                           for g in rng.permutation(len(groups))])


def make_pool(spec: dict, input_dim: int, num_pdfs: int, seed: int,
              group: int = 1) -> Pool:
    """The seed's utterances, in the seed's order (`seed_order`): one draw
    for all features, one for all target runs."""
    rng = rng_for(seed, "pool")
    lengths = pool_lengths(spec)[seed_order(int(spec["pool"]), group, rng)]
    total = int(lengths.sum())
    flat = rng.standard_normal((total, input_dim), dtype=np.float32)
    lo, hi = int(spec["run_min"]), int(spec["run_max"])
    runs = rng.integers(lo, hi + 1, size=total // lo + 1)
    pdfs = rng.integers(0, num_pdfs, size=runs.shape[0]).astype(np.int32)
    ids = np.repeat(pdfs, runs)[:total]
    cuts = np.cumsum(lengths)[:-1]
    return Pool(lengths, np.split(flat, cuts), np.split(ids, cuts))


class Targets:
    """The targets as the stream scheduler reads them: one pdf a frame,
    weight 1, by utterance key."""

    def __init__(self, pool: Pool):
        self.pool = pool

    @staticmethod
    def index(key: str) -> int:
        return int(key.rsplit("-", 1)[1])

    def has_key(self, key: str) -> bool:
        return True

    def value_dense(self, key: str, K: int):
        ids = self.pool.ids[self.index(key)]
        out = np.zeros((ids.shape[0], K), np.int32)
        w = np.zeros((ids.shape[0], K), np.float32)
        out[:, 0] = ids
        w[:, 0] = 1.0
        return out, w


class TrainSource:
    """(key, feats) pairs for the stream scheduler: the pool cycled
    without end, each pass in a fresh seeded order."""

    def __init__(self, pool: Pool, seed: int):
        self.pool = pool
        self.rng = rng_for(seed, "order")
        self.order: list = []
        self.handed = 0

    def __iter__(self):
        return self

    def __next__(self):
        if not self.order:
            self.order = list(self.rng.permutation(len(self.pool.lengths)))
        u = int(self.order.pop())
        self.handed += 1
        return f"utt{self.handed}-{u}", self.pool.feats[u]


def class_counts(num_pdfs: int, seed: int) -> np.ndarray:
    """Seeded frame counts per pdf, as `analyze-counts` writes them: a
    skewed law (a few pdfs, like silence, take many frames), none 0."""
    rng = rng_for(seed, "counts")
    return np.floor(rng.lognormal(6.0, 1.5, size=num_pdfs)) + 1.0
