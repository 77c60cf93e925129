"""Masked losses over sparse posterior targets and the running
statistics, PyTorch edition of ``kaldi_lstm_tpu.train.loss``.

Targets stay sparse: per frame a fixed-width list of (pdf-id, weight)
pairs. Cross-entropy takes pre-softmax logits, so autograd of the summed
loss gives the combined softmax + xent gradient (softmax - t) * mask.
Scalars (xent, entropy, correct, frames) are reduced on the device; the
host-side `LossStats` accumulator prints the reference's report lines
(`AvgLoss`, `ProgressLoss[h/h]`, `FRAME_ACCURACY >> x% <<`) character
for character as the JAX package does.

Shapes: logits [S, T, K]; tgt_ids/tgt_weights [S, T, Kmax]; mask [S, T].
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import Posterior


class LossAux(NamedTuple):
    """Per-batch statistics (0-d device tensors, or floats on the host)."""
    xent: Any      # sum of -t*log(y) over valid frames
    entropy: Any   # sum of -t*log(t) over valid frames
    correct: Any   # frames where argmax(net) == argmax(target)
    frames: Any    # number (weighted sum) of valid frames


def posterior_to_sparse(posts: Sequence[Posterior], max_entries: int = 1
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-stream Posteriors to fixed-shape [S, T, Kmax] id/weight arrays.
    T is the longest; shorter streams are padded with weight 0."""
    S = len(posts)
    T = max((len(p) for p in posts), default=0)
    ids = np.zeros((S, T, max_entries), np.int32)
    weights = np.zeros((S, T, max_entries), np.float32)
    for s, post in enumerate(posts):
        for t, frame in enumerate(post):
            for k, (pdf, w) in enumerate(frame[:max_entries]):
                ids[s, t, k] = pdf
                weights[s, t, k] = w
    return ids, weights


def target_entropy(tw: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """-sum t log t over valid frames (zero weights contribute 0)."""
    return -torch.sum(torch.sum(torch.where(
        tw > 0, tw * torch.log(torch.clamp(tw, min=1e-20)),
        torch.zeros((), dtype=tw.dtype, device=tw.device)), -1) * m)


def target_best(tgt_ids: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The id of each frame's largest-weight target entry (the first on
    ties; with Kmax == 1 the only entry, whatever its weight)."""
    if tgt_ids.shape[-1] == 1:
        return tgt_ids[..., 0]
    masked = torch.where(tw > 0, tw, torch.full_like(tw, -float("inf")))
    return torch.gather(tgt_ids, -1,
                        torch.argmax(masked, -1, keepdim=True))[..., 0]


def masked_xent_loss(logits: torch.Tensor, tgt_ids: torch.Tensor,
                     tgt_weights: torch.Tensor, mask: torch.Tensor
                     ) -> tuple[torch.Tensor, LossAux]:
    """Cross-entropy vs sparse targets with a 0/1 (or weighted) frame
    mask. Returns (summed masked xent, stats); its gradient in `logits`
    is (softmax(logits) * sum(t) - t) * mask."""
    K = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, K), dim=-1) \
        .reshape(logits.shape)
    picked = torch.gather(logp, -1, tgt_ids.long())
    m = mask.to(logits.dtype)
    xent = -torch.sum(torch.sum(tgt_weights * picked, -1) * m)
    ent = target_entropy(tgt_weights, m)
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum((pred == target_best(tgt_ids, tgt_weights))
                        .to(logits.dtype) * m)
    frames = torch.sum(m)
    return xent, LossAux(xent=xent.detach(), entropy=ent.detach(),
                         correct=correct, frames=frames)


def masked_mse_loss(y: torch.Tensor, tgt_ids: torch.Tensor,
                    tgt_weights: torch.Tensor, mask: torch.Tensor
                    ) -> tuple[torch.Tensor, LossAux]:
    """0.5 * ||(y - t) * mask||^2 on the net output as it is, with sparse
    targets: ||y - t||^2 = ||y||^2 - 2 sum w y[id] + sum w^2."""
    picked = torch.gather(y, -1, tgt_ids.long())
    sq = (torch.sum(y * y, -1)
          - 2.0 * torch.sum(tgt_weights * picked, -1)
          + torch.sum(tgt_weights * tgt_weights, -1))
    m = mask.to(y.dtype)
    loss = 0.5 * torch.sum(sq * m)
    aux = LossAux(xent=loss.detach(),
                  entropy=torch.zeros((), dtype=y.dtype, device=y.device),
                  correct=torch.full((), -1.0, dtype=y.dtype,
                                     device=y.device),
                  frames=torch.sum(m))
    return loss, aux


class LossStats:
    """Host-side running/progressive accumulator with the reference's
    report formats (nnet-loss.cc:144-163, 293-307)."""

    # 6 minutes of 100 fps audio; the Mse variant logs every 1e6 samples
    PROGRESS_STEP = 3600 * 100 // 10
    PROGRESS_STEP_MSE = 1_000_000

    def __init__(self, name: str = "Xent"):
        self.name = name
        if name == "Mse":
            self.PROGRESS_STEP = self.PROGRESS_STEP_MSE
        self.loss = 0.0
        self.entropy = 0.0
        self.correct = 0.0   # weighted counts (fractional frame weights)
        self.frames = 0.0
        self.loss_progress = 0.0
        self.entropy_progress = 0.0
        self.correct_progress = 0.0
        self.frames_progress = 0.0
        self.loss_vec: list[float] = []

    def add(self, aux: LossAux, log_fn=None) -> None:
        xent = float(aux.xent)
        ent = float(aux.entropy)
        cor = float(aux.correct)
        frm = float(aux.frames)
        self.loss += xent
        self.entropy += ent
        self.correct += cor
        self.frames += frm
        self.loss_progress += xent
        self.entropy_progress += ent
        self.correct_progress += cor
        self.frames_progress += frm
        if self.frames_progress > self.PROGRESS_STEP:
            avg = ((self.loss_progress - self.entropy_progress)
                   / self.frames_progress)
            if log_fn is not None:
                log_fn(f"ProgressLoss[{self.frames_progress / 100 / 3600:g}h/"
                       f"{self.frames / 100 / 3600:g}h]: {avg:g} "
                       f"({self.name})")
                if self.correct_progress >= 0:  # Mse reports no accuracy
                    log_fn(f"FrameAccuracy[{self.correct_progress / self.frames_progress:g}]")
            self.loss_vec.append(avg)
            self.loss_progress = 0.0
            self.entropy_progress = 0.0
            self.correct_progress = 0
            self.frames_progress = 0

    def avg_loss(self) -> float:
        """AvgLoss as reported: (xent - target entropy) / frames, the
        value the recipe's newbob scheduler parses."""
        return (self.loss - self.entropy) / max(self.frames, 1)

    def report(self) -> str:
        frames = max(self.frames, 1)
        lines = [f"AvgLoss: {(self.loss - self.entropy) / frames:g} "
                 f"({self.name}), [AvgXent: {self.loss / frames:g}, "
                 f"AvgTargetEnt: {self.entropy / frames:g}]"]
        if self.loss_vec:
            lines.append("progress: [" +
                         " ".join(f"{v:g}" for v in self.loss_vec) + " ]")
        if self.correct >= 0:
            lines.append(f"\nFRAME_ACCURACY >> "
                         f"{100.0 * self.correct / frames:g}% <<")
        return "\n".join(lines)
