"""The numbers that decide `correct`, each held to its limit from the
cell's `workloads/<cell>.json`.

Training is judged by the worst leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf (some gradients are all but
zero). Leaves whose first gradient in the reference is under a
thousandth of the median leaf's move by round-off alone and are left
out of the change.
"""

from __future__ import annotations

import math

import numpy as np

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(prog, ref, keep=None) -> np.ndarray:
    """Each leaf's gap of norms over the larger of its own reference norm
    and the median leaf's; inf where the program's norms are unusable."""
    prog, ref = np.asarray(prog, float), np.asarray(ref, float)
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return np.array([math.inf])
    return np.abs(prog - ref) / np.maximum(ref, float(np.median(ref)))


def train_numbers(prog: dict, ref: dict, change_at: int) -> dict:
    """loss_gap: the largest relative gap of a step's loss (xent per
    valid frame); grad_gap: the first gradient's worst leaf; change_gap:
    the worst leaf's change after `change_at` steps; and the next-worst
    leaf of each (`.next`), for a cell whose worst leaf is one whose
    float32 sums are noisier than a lower precision's products."""
    lp, lr = np.asarray(prog["loss"], float), np.asarray(ref["loss"], float)
    loss_gap = (float(np.max(np.abs(lp - lr) / np.abs(lr)))
                if lp.shape == lr.shape and np.all(np.isfinite(lp))
                else math.inf)
    g = np.asarray(ref["grad0"], float)
    keep = g >= NEGLIGIBLE_GRAD * float(np.median(g))
    grad = np.sort(_leaf_gaps(prog["grad0"], ref["grad0"]))
    change = np.sort(_leaf_gaps(prog["change"][change_at],
                                ref["change"][change_at], keep))
    return {"loss_gap": loss_gap,
            "grad_gap": float(grad[-1]),
            "change_gap": float(change[-1]),
            "grad_gap.next": float(grad[-2 if grad.size > 1 else -1]),
            "change_gap.next": float(change[-2 if change.size > 1 else -1])}


def score_gap(rows: list, ref: list, log_prior: np.ndarray) -> float:
    """The widest gap of a score from the reference's, over the RMS of
    the reference's logits (scores plus log priors) of that utterance;
    the largest over the utterances compared."""
    worst = 0.0
    for y, r in zip(rows, ref):
        if y.shape != r.shape or not np.all(np.isfinite(y)):
            return math.inf
        rms = float(np.sqrt(np.mean((r + log_prior) ** 2)))
        worst = max(worst, float(np.max(np.abs(y - r))) / rms)
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell's file gives a limit within it, {name:
    {"value", "limit"}}); a limit whose number the run lacks fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = value <= limit
        ok = ok and good
        out[name] = {"value": value if math.isfinite(value) else str(value),
                     "limit": limit}
    return ok, out
