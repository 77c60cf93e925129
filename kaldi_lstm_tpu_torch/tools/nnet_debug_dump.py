"""Per-frame LSTM activation/derivative dump, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_debug_dump``: the reference's ``int DEBUG``
blocks as a CLI.

The reference compiles per-frame tensor prints into the component
(bd-nnet-lstm-projected-streams.h:314-324 forward, 443-453 backward,
489-498 gradients) behind an ``int DEBUG`` switch. Here the same
tensors (YG..YR activations, DG..DR derivatives, per-weight gradient
sums) come from the host reference (`ops/lstm_grad_variants.py`) on one
real minibatch, with the upstream derivative taken from the network's
own loss by autograd on ``--device`` (K1/K2 and K5 on the card), so the
dump shows what training's backward sees. Frames print as moment
summaries (``--print-frames`` full tensors) and every tensor is saved
to ``<dump-dir>/layer<i>.<token>.npz``, the JAX tool's layout.

``--variant`` selects the reference's gradient version (1 = precise
live version, 2 = Graves, 3 = Gers truncation, …streams.h:388-405).
Without ``--targets`` the derivative comes from a fixed random
functional of the net output, drawn with numpy (the JAX tool draws it
with jax.random, so those dumps differ between the packages).

Usage:
  python -m kaldi_lstm_tpu_torch.tools.nnet_debug_dump <model> \\
      <feature-rspecifier> <dump-dir> [--targets <posterior-rspec>] ...
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    RandomAccessPosteriorReader,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import (
    _LstmBase,
    moment_statistics,
)
from kaldi_lstm_tpu_torch.ops.lstm_grad_variants import (
    backward_variant,
    forward_full,
)
from kaldi_lstm_tpu_torch.utils import LOG, device_from_arg

TOOL = "nnet-debug-dump"


def load_chunk(feats_rspec, targets_rspec, num_stream, batch_size,
               feat_dim):
    """First minibatch: [S, T, I] features + [S, T] target ids (zeros
    when no targets are given)."""
    feats, ids = [], []
    targets = (RandomAccessPosteriorReader(targets_rspec)
               if targets_rspec else None)
    for key, mat in SequentialMatrixReader(feats_rspec):
        if mat.shape[1] != feat_dim:
            continue
        post = None
        if targets is not None:
            if not targets.has_key(key):
                continue
            post = targets.value(key)
        feats.append(mat)
        if post is not None:
            ids.append([max(fr, key=lambda e: e[1])[0] if fr else 0
                        for fr in post])
        if len(feats) >= num_stream:
            break
    if not feats:
        raise RuntimeError("no usable utterances for the debug dump")
    T = min(batch_size, min(m.shape[0] for m in feats))
    if ids:
        T = min(T, min(len(i) for i in ids))
    x = np.stack([m[:T] for m in feats]).astype(np.float32)
    y = (np.stack([np.asarray(i[:T], np.int32) for i in ids])
         if ids else np.zeros(x.shape[:2], np.int32))
    return x, y


def _apply(c, p, h, s):
    if getattr(c, "uses_rng", False):
        return c.apply(p, h, s, rng=None, train=False)[0]
    return c.apply(p, h, s)[0]


def debug_dump(nnet: Nnet, params, x, ids, dump_dir, variant=1,
               print_frames=3, have_targets=False, out=None):
    """Dump per-frame tensors for every LSTM layer of `nnet` on the
    chunk x [S, T, I] / ids [S, T] (numpy), on the device the params
    live on; the moment lines go to `out` (default stderr). Returns the
    number of LSTM layers dumped."""
    out = sys.stderr if out is None else out
    os.makedirs(dump_dir, exist_ok=True)
    S = x.shape[0]
    leaves = [t for p in params for t in
              (p.values() if isinstance(p, dict) else p)]
    device = leaves[0].device if leaves else torch.device("cpu")

    # per-layer inputs (fresh zero states)
    states = nnet.init_states(S, device)
    acts = []
    with torch.no_grad():
        h = torch.from_numpy(np.asarray(x, np.float32)).to(device)
        for c, p, s in zip(nnet.components, params, states):
            acts.append(h)
            h = _apply(c, p, h, s)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(device)

    def tail_loss(y_i, layer):
        """The network loss as a function of layer `layer`'s output
        (xent on the targets when given, else a fixed random functional
        so the derivative structure is still real)."""
        h = y_i
        for c, p, s in list(zip(nnet.components, params, states))[
                layer + 1:]:
            h = _apply(c, p, h, s)
        if have_targets:
            logp = torch.log(torch.clamp(h, min=1e-20))
            return -torch.sum(torch.gather(logp, -1, ids_t[..., None]))
        probe = torch.from_numpy(np.random.RandomState(0).randn(
            h.shape[-1]).astype(np.float32)).to(device)
        return torch.sum(h * probe)

    n_lstm = 0
    for li, (c, p) in enumerate(zip(nnet.components, params)):
        if not isinstance(c, _LstmBase):
            continue
        n_lstm += 1
        x_in = acts[li]
        with torch.enable_grad():
            y_out = _apply(c, p, x_in, states[li]).detach() \
                .requires_grad_(True)
            d_out = torch.autograd.grad(tail_loss(y_out, li), y_out)[0]
        # the variants module is time-major
        x_tm = x_in.cpu().numpy().swapaxes(0, 1)
        d_tm = d_out.cpu().numpy().astype(np.float32).swapaxes(0, 1)
        c0 = np.zeros((S, c.cell_dim), np.float32)
        r0 = np.zeros((S, c.recur_dim), np.float32)
        Y = forward_full(p, x_tm, c0, r0, c.cell_clip)
        D, G = backward_variant(p, x_tm, c0, r0, d_tm, variant,
                                c.cell_clip)

        T = x_tm.shape[0]
        shown = T if print_frames < 0 else min(print_frames, T)
        for t in range(shown):
            print(f"[layer {li} {c.token}] forward-pass frame {t}",
                  file=out)
            for nm in ("g", "i", "f", "o", "c", "h", "m", "r"):
                print("  " + moment_statistics(f"y_{nm}",
                                               getattr(Y, nm)[t]), file=out)
        for t in range(shown - 1, -1, -1):
            print(f"[layer {li} {c.token}] backward-pass frame {t} "
                  f"(variant {variant})", file=out)
            for nm in ("r", "m", "h", "o", "c", "f", "i", "g"):
                print("  " + moment_statistics(f"d_{nm}",
                                               getattr(D, nm)[t]), file=out)
        for nm in ("w_gifo_x", "w_gifo_r", "bias", "peephole_i_c",
                   "peephole_f_c", "peephole_o_c", "w_r_m"):
            print("  " + moment_statistics(f"{nm}_corr", getattr(G, nm)),
                  file=out)

        path = os.path.join(dump_dir, f"layer{li}.{c.token}.npz")
        np.savez(path,
                 **{f"y_{nm}": getattr(Y, nm) for nm in Y._fields},
                 **{f"d_{nm}": getattr(D, nm) for nm in D._fields},
                 **{f"grad_{nm}": getattr(G, nm) for nm in G._fields})
        LOG(f"debug dump: wrote {path} (x {x_tm.shape}, variant {variant})")
    if n_lstm == 0:
        LOG("debug dump: model has no LSTM layers, nothing dumped")
    return n_lstm


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model_in")
    p.add_argument("feature_rspecifier")
    p.add_argument("dump_dir")
    p.add_argument("--targets", default="",
                   help="posterior rspecifier; when given the dumped "
                        "derivatives come from the real xent loss")
    p.add_argument("--num-stream", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--variant", type=int, default=1, choices=(1, 2, 3),
                   help="reference gradient version "
                        "(bd-nnet-lstm-projected-streams.h:388-405)")
    p.add_argument("--print-frames", type=int, default=3,
                   help="frames to print moment lines for (-1 = all)")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default, exits 1 when CUDA is missing) or "
                        "cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1
    nnet, params = Nnet.read(args.model_in, device)
    transf = tp = None
    if args.feature_transform:
        transf, tp = Nnet.read(args.feature_transform, device)
    raw_dim = transf.input_dim if transf else nnet.input_dim
    x, ids = load_chunk(args.feature_rspecifier, args.targets,
                        args.num_stream, args.batch_size, raw_dim)
    if transf is not None:
        with torch.no_grad():
            x = transf.feedforward(
                tp, torch.from_numpy(x).to(device)).cpu().numpy()
    debug_dump(nnet, params, x, ids, args.dump_dir, args.variant,
               args.print_frames, have_targets=bool(args.targets))
    return 0


if __name__ == "__main__":
    sys.exit(main())
