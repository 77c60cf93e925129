"""Plain PyTorch float32 reference of the benchmark's models: projected
LSTM layers (Sak et al. 2014, as Kaldi's nnet1 LstmProjectedStreams
computes them), the senone affine layer, softmax cross-entropy against
one-hot frame targets, SGD with classical momentum (Kaldi nnet1), and
scoring with the log priors subtracted (`nnet-forward --no-softmax
--class-frame-counts`).

It imports nothing of the program and takes nothing the program made:
the harness hands it the weights, features and targets it made itself.
TF32 is off unless a caller asks for it (`tf32=True` is the control:
the reference one precision below float32).

Weights: {"lstmp": [layer, ...], "affine": {"linearity": [K, R],
"bias": [K]}}, a layer {"w_gifo_x": [4C, I], "w_gifo_r": [4C, R],
"bias": [4C], "peephole_i_c", "peephole_f_c", "peephole_o_c": [C],
"w_r_m": [R, C]}, gate order g, i, f, o along 4C.

    gifo = x Wx^T + bias + r_{t-1} Wr^T
    i = sigmoid(i_pre + c_{t-1} p_i),  f = sigmoid(f_pre + c_{t-1} p_f)
    c = clip(tanh(g_pre) i + c_{t-1} f, +-50)   (the backward ignores it)
    o = sigmoid(o_pre + c p_o),  r = (tanh(c) o) Wrm^T
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

CELL_CLIP = 50.0
LEAF_NAMES = ("w_gifo_x", "w_gifo_r", "bias", "peephole_i_c",
              "peephole_f_c", "peephole_o_c", "w_r_m")


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in float32 (TF32 off) or, with `tf32`, in TF32."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def lstmp_layer(p: dict, x: torch.Tensor, c: torch.Tensor, r: torch.Tensor):
    """One layer over x [S, T, I] from the state (c [S, C], r [S, R]);
    returns (outputs [S, T, R], c, r)."""
    S, T, I = x.shape
    C = p["peephole_i_c"].shape[0]
    xw = (x.reshape(S * T, I) @ p["w_gifo_x"].T).reshape(S, T, 4 * C) \
        + p["bias"]
    outs = []
    for t in range(T):
        gifo = xw[:, t] + r @ p["w_gifo_r"].T
        g_pre, i_pre, f_pre, o_pre = gifo.split(C, dim=1)
        i = torch.sigmoid(i_pre + c * p["peephole_i_c"])
        f = torch.sigmoid(f_pre + c * p["peephole_f_c"])
        c_new = torch.tanh(g_pre) * i + c * f
        c_new = c_new + (torch.clamp(c_new, -CELL_CLIP, CELL_CLIP)
                         - c_new).detach()
        o = torch.sigmoid(o_pre + c_new * p["peephole_o_c"])
        r = (torch.tanh(c_new) * o) @ p["w_r_m"].T
        c = c_new
        outs.append(r)
    return torch.stack(outs, 1), c, r


def trunk(w: dict, x: torch.Tensor, states):
    """All LSTMP layers; returns (top outputs, new states)."""
    new = []
    for p, (c, r) in zip(w["lstmp"], states):
        x, c, r = lstmp_layer(p, x, c, r)
        new.append((c, r))
    return x, new


def zero_states(w: dict, S: int, device):
    return [(torch.zeros(S, p["peephole_i_c"].shape[0], device=device),
             torch.zeros(S, p["w_r_m"].shape[0], device=device))
            for p in w["lstmp"]]


def leaves(w: dict) -> list:
    """(name, tensor) of every weight, in a fixed order."""
    out = []
    for n, p in enumerate(w["lstmp"]):
        out += [(f"lstmp{n}.{k}", p[k]) for k in LEAF_NAMES]
    out += [("affine.linearity", w["affine"]["linearity"]),
            ("affine.bias", w["affine"]["bias"])]
    return out


def _with_leaves(w: dict, ts: list) -> dict:
    it = iter(ts)
    return {"lstmp": [{k: next(it) for k in LEAF_NAMES} for _ in w["lstmp"]],
            "affine": {"linearity": next(it), "bias": next(it)}}


def train_steps(weights: dict, batches: list, epoch_starts: set,
                learn_rate: float, momentum: float, device,
                snap_at=(), tf32: bool = False) -> dict:
    """Follow the trainer over `batches` (dicts of numpy feats [S, T, D],
    ids [S, T], mask [S, T], reset [S]): the carried state is zeroed at
    each index in `epoch_starts` and, per stream, where `reset` is 1;
    loss = -sum mask log softmax(logits)[id]; the update is Kaldi's
    corr = grad + momentum corr, w -= lr corr, gradients summed over the
    frames. Returns {"loss": [xent / frames per step], "grad0": [norm of
    each leaf's first gradient], "change": {k: [norm of each leaf's
    change after k steps] for k in `snap_at`}, "names": [leaf names]}."""
    names = [n for n, _ in leaves(weights)]
    p = [t.detach().clone().to(device) for _, t in leaves(weights)]
    p0 = [t.clone() for t in p]
    corr = [torch.zeros_like(t) for t in p]
    states = None
    losses, grad0, change = [], None, {}
    with precision(tf32):
        for n, b in enumerate(batches):
            S = b["feats"].shape[0]
            live = [t.detach().requires_grad_(True) for t in p]
            w = _with_leaves(weights, live)
            if states is None or n in epoch_starts:
                states = zero_states(w, S, device)
            keep = 1.0 - torch.as_tensor(b["reset"], dtype=torch.float32,
                                         device=device)[:, None]
            states = [(c * keep, r * keep) for c, r in states]
            x = torch.as_tensor(b["feats"], device=device)
            y, new = trunk(w, x, states)
            logits = y.reshape(-1, y.shape[-1]) @ w["affine"]["linearity"].T \
                + w["affine"]["bias"]
            logp = torch.log_softmax(logits, dim=-1)
            ids = torch.as_tensor(b["ids"], device=device).reshape(-1, 1)
            mask = torch.as_tensor(b["mask"], device=device).reshape(-1)
            xent = -(logp.gather(1, ids.long())[:, 0] * mask).sum()
            grads = torch.autograd.grad(xent, live)
            losses.append(float(xent.detach()) / float(mask.sum()))
            if grad0 is None:
                grad0 = [float(g.norm()) for g in grads]
            with torch.no_grad():
                for t, c, g in zip(p, corr, grads):
                    c.mul_(momentum).add_(g)
                    t.sub_(learn_rate * c)
            states = [(c.detach(), r.detach()) for c, r in new]
            if n + 1 in snap_at:
                change[n + 1] = [float((a - a0).norm())
                                 for a, a0 in zip(p, p0)]
    return {"loss": losses, "grad0": grad0, "change": change,
            "names": names}


def log_priors(counts: np.ndarray, floor: float = 1e-10) -> np.ndarray:
    """log(counts / sum), floored: Kaldi's --class-frame-counts priors."""
    c = np.asarray(counts, np.float64)
    return np.log(np.maximum(c / max(c.sum(), 1.0), floor))


@torch.no_grad()
def score(weights: dict, feats: list, counts: np.ndarray, device,
          tf32: bool = False) -> list:
    """Scores of whole utterances from a zero state: logits minus the
    log priors, [T_u, K] float32 numpy each. The utterances run as one
    batch padded with zeros at their ends: the net is causal, so no
    padded frame reaches a row that is kept."""
    lp = torch.as_tensor(log_priors(counts), dtype=torch.float32,
                         device=device)
    T = max(f.shape[0] for f in feats)
    x = torch.zeros(len(feats), T, feats[0].shape[1], device=device)
    for n, f in enumerate(feats):
        x[n, :f.shape[0]] = torch.as_tensor(f, device=device)
    w = {"lstmp": [{k: t.to(device) for k, t in p.items()}
                   for p in weights["lstmp"]],
         "affine": {k: t.to(device) for k, t in weights["affine"].items()}}
    out = []
    with precision(tf32):
        y, _ = trunk(w, x, zero_states(w, len(feats), device))
        for n, f in enumerate(feats):
            logits = y[n, :f.shape[0]] @ w["affine"]["linearity"].T \
                + w["affine"]["bias"]
            out.append((logits - lp).cpu().numpy())
    return out
