"""The training step and the epoch loop, PyTorch edition of
``kaldi_lstm_tpu.train.trainer``.

One step, as the reference does it per minibatch
(bd-nnet-train-lstm-streams.cc:209-229):

    (params, opt_state, carry_states, batch, learn_rate)
        -> (params', opt_state', carry_states', stats)

per-stream state reset (a mask multiply *before* the chunk), feature
transform, forward, masked loss, BPTT by autograd through the kernels'
Functions (K1/K2 for the LSTMs, K3/K4 for the fused senone loss on the
card), then the SGD + momentum update in place. The carried state is
detached between chunks. `learn_rate` is a 0-d device tensor, so the
filler-batch guard (lr 0, momentum 1 when a batch has no frames) and the
statistics need no host sync inside a step.

The epoch loop (`run_epoch`) adds the host side: the stream scheduler
on a prefetch thread, pinned non-blocking uploads, statistics kept on the
device and fetched once per `STATS_FLUSH` batches (with the non-finite
check at each fetch), progress logs and periodic model dumps.

Not in this module yet (ROADMAP.md): the grouped step
(`make_grouped_train_step`, a CUDA-graph capture here), the first-batch
moment dumps of `--verbose >= 1`, and the sharded path.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.models.components import AffineTransform, Softmax
from kaldi_lstm_tpu_torch.models.nnet import Nnet
from kaldi_lstm_tpu_torch.ops.xent_affine import fused_affine_xent
from kaldi_lstm_tpu_torch.train.loss import (
    LossAux,
    LossStats,
    masked_mse_loss,
    masked_xent_loss,
)
from kaldi_lstm_tpu_torch.train.optim import (
    MomentumState,
    init_momentum,
    momentum_update,
)
from kaldi_lstm_tpu_torch.train.streams import (
    PrefetchIterator,
    StreamBatch,
    StreamScheduler,
)
from kaldi_lstm_tpu_torch.utils import VLOG
from kaldi_lstm_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


class TrainOptions(NamedTuple):
    """NnetTrainOptions equivalent (nnet-trnopts.h upstream)."""
    learn_rate: float = 1e-5
    momentum: float = 0.9
    grad_clip: float = 0.0    # 50.0 reproduces the standard variant
    l1_penalty: float = 0.0   # upstream --l1-penalty (affine linearity)
    l2_penalty: float = 0.0   # upstream --l2-penalty (affine linearity)
    objective: str = "xent"   # xent | mse
    # fuse the senone AffineTransform + Softmax + xent (K3/K4; logits
    # never formed; needs a net that ends in [AffineTransform, Softmax]
    # and the xent objective). None = auto: on for CUDA tensors.
    fused_xent: Optional[bool] = None


def _tail_is_affine_softmax(nnet: Nnet) -> bool:
    return (len(nnet.components) >= 2
            and isinstance(nnet.components[-2], AffineTransform)
            and isinstance(nnet.components[-1], Softmax))


_LOSS_FNS = {"xent": masked_xent_loss, "mse": masked_mse_loss}


def trunk_supports_time_major(nnet: Nnet) -> bool:
    """True when every component before the [Affine, Softmax] tail either
    ignores the [S, T] axis order (elementwise) or accepts
    time_major=True (the LSTMs)."""
    return all(getattr(c, "axis_invariant", False)
               or getattr(c, "supports_time_major", False)
               for c in nnet.components[:-2])


def make_objective(nnet: Nnet, loss_fn, use_fused: bool, train: bool,
                   time_major: bool = False, want_logits: bool = True):
    """objective(params, x, states, tgt_ids, tgt_weights, mask, rng)
    -> (loss, (aux, new_states)). With `use_fused`, runs the stack up to
    the senone affine and hands the [N, R] frames to
    `fused_affine_xent(r, w, b, ids, tw, mask)` (K3/K4 on the card)
    instead of forming logits. With `time_major` (fused
    only) the batch is transposed to [T, S, .] once at entry and the
    trunk runs in the LSTM kernels' own layout; the loss is a frame sum,
    so the flattening order is immaterial."""

    def objective(params, x, states, tgt_ids, tgt_weights, mask, rng):
        if use_fused:
            tm = time_major
            y = x.transpose(0, 1) if tm else x
            new_states = []
            for i, (c, p, s) in enumerate(
                    zip(nnet.components[:-2], params[:-2], states)):
                kwargs = {}
                if tm and getattr(c, "supports_time_major", False):
                    kwargs["time_major"] = True
                if (train
                        and getattr(c, "accepts_input_grad_flag", False)
                        and not any(getattr(cc, "updatable", False)
                                    for cc in nnet.components[:i])):
                    # nothing trainable below this layer: its input
                    # gradient would be discarded, so K2 skips dx
                    kwargs["input_grad"] = False
                if getattr(c, "uses_rng", False):
                    y, s2 = c.apply(p, y, s, rng=rng, train=train,
                                    **kwargs)
                else:
                    y, s2 = c.apply(p, y, s, **kwargs)
                new_states.append(s2)
            new_states += [None, None]
            n = y.shape[0] * y.shape[1]
            aff = params[-2]
            ids_f = tgt_ids.transpose(0, 1) if tm else tgt_ids
            tw_f = tgt_weights.transpose(0, 1) if tm else tgt_weights
            mask_f = mask.transpose(0, 1) if tm else mask
            loss, aux = fused_affine_xent(
                y.reshape(n, y.shape[2]), aff["linearity"], aff["bias"],
                ids_f.reshape(n, -1), tw_f.reshape(n, -1), mask_f.reshape(n))
            return loss, (aux, tuple(new_states))
        # xent takes pre-softmax logits (autograd gives the combined
        # softmax+xent backward); mse takes the net output as it is
        logits, new_states = nnet.propagate(params, x, states,
                                            logits=want_logits, rng=rng,
                                            train=train)
        loss, aux = loss_fn(logits, tgt_ids, tgt_weights, mask)
        return loss, (aux, new_states)

    return objective


def build_lr_scale(nnet: Nnet, params):
    """Per-leaf learn-rate multipliers from component config: nnet1's
    <LearnRateCoef>/<BiasLearnRateCoef> (0 freezes a tensor)."""
    out = []
    for c, p in zip(nnet.components, params):
        if isinstance(c, AffineTransform):
            out.append({"linearity": float(c.learn_rate_coef),
                        "bias": float(c.bias_learn_rate_coef)})
        else:
            coef = float(getattr(c, "learn_rate_coef", 1.0))
            out.append(tree_map(lambda _: coef, p))
    return tuple(out)


def build_reg_mask(nnet: Nnet, params):
    """Per-leaf 0/1 markers for where nnet1 applies --l1/--l2-penalty:
    only AffineTransform linearity."""
    out = []
    for c, p in zip(nnet.components, params):
        if isinstance(c, AffineTransform):
            out.append({"linearity": 1.0, "bias": 0.0})
        else:
            out.append(tree_map(lambda _: 0.0, p))
    return tuple(out)


@torch.no_grad()
def apply_max_norm(nnet: Nnet, params):
    """Per-neuron max-norm projection after the update, in place: rows of
    an AffineTransform's linearity whose L2 norm exceeds <MaxNorm> are
    scaled back onto the sphere. No-op for max_norm == 0."""
    for c, p in zip(nnet.components, params):
        mn = float(getattr(c, "max_norm", 0.0) or 0.0)
        if isinstance(c, AffineTransform) and mn > 0.0:
            w = p["linearity"]
            l2 = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
            w.div_(torch.clamp(l2 / mn, min=1.0))
    return params


def nnet_has_max_norm(nnet: Nnet) -> bool:
    return any(float(getattr(c, "max_norm", 0.0) or 0.0) > 0.0
               for c in nnet.components)


def default_use_fused(nnet: Nnet, opts: TrainOptions, device) -> bool:
    """The fused senone loss is on by default for CUDA tensors (the JAX
    package turns it on for a TPU) and needs the xent objective and an
    [AffineTransform, Softmax] tail."""
    fused_wanted = (torch.device(device).type == "cuda"
                    if opts.fused_xent is None else opts.fused_xent)
    return (fused_wanted and opts.objective == "xent"
            and _tail_is_affine_softmax(nnet))


def _make_step_fn(nnet: Nnet, opts: TrainOptions, transf: Optional[Nnet],
                  crossvalidate: bool, device):
    """The single-step computation for tensors on `device`."""
    use_fused = default_use_fused(nnet, opts, device)
    objective_fn = make_objective(
        nnet, _LOSS_FNS[opts.objective], use_fused, train=not crossvalidate,
        time_major=use_fused and trunk_supports_time_major(nnet),
        want_logits=opts.objective == "xent")

    def step(params, opt_state, states, transf_params, feats, tgt_ids,
             tgt_weights, mask, reset_flags, learn_rate, rng=None):
        # reset BEFORE the chunk; the carried state arrives detached
        states = nnet.reset_states(states, reset_flags)
        x = feats
        if transf is not None:
            with torch.no_grad():
                x = transf.feedforward(transf_params, x)

        if crossvalidate:
            with torch.no_grad():
                _, (aux, new_states) = objective_fn(
                    params, x, states, tgt_ids, tgt_weights, mask, rng)
            return params, opt_state, new_states, aux

        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, (aux, new_states) = objective_fn(
                live, x, states, tgt_ids, tgt_weights, mask, rng)
            flat = tree_leaves(live)
            flat_g = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, flat_g)])
        new_states = tree_map(lambda t: t.detach(), new_states)
        # A fully-masked filler batch must be an exact no-op on params
        # and momentum: lr 0 and momentum 1 carry both through unchanged
        # (device scalars, no host sync).
        real = aux.frames > 0
        lr_eff = learn_rate * real.to(torch.float32)
        mmt_eff = torch.where(real, opts.momentum, 1.0)
        params, opt_state = momentum_update(
            params, grads, opt_state, lr_eff, mmt_eff, opts.grad_clip,
            lr_scale=build_lr_scale(nnet, params),
            l1_penalty=opts.l1_penalty, l2_penalty=opts.l2_penalty,
            num_frames=feats.shape[0] * feats.shape[1],
            reg_mask=build_reg_mask(nnet, params))
        if nnet_has_max_norm(nnet):
            apply_max_norm(nnet, params)
        return params, opt_state, new_states, aux

    return step


def make_train_step(nnet: Nnet, opts: TrainOptions,
                    transf: Optional[Nnet] = None,
                    crossvalidate: bool = False, *, device):
    """The step for tensors on `device`. `transf` is the feature-transform
    net (CMVN); its params are passed per call. The step updates params
    and momentum in place and returns them."""
    return _make_step_fn(nnet, opts, transf, crossvalidate, device)


class EpochResult(NamedTuple):
    params: Any
    opt_state: MomentumState
    stats: LossStats
    num_done: int
    total_frames: float
    elapsed: float


STATS_FLUSH = 32  # batches of device stats fetched per host transfer


def _pack_aux(aux: LossAux) -> torch.Tensor:
    """[1, 4] float32 device row (xent, entropy, correct, frames)."""
    return torch.stack([torch.as_tensor(v).to(torch.float32).reshape(())
                        for v in aux]).reshape(1, 4)


def _flush_stats(pending: list, stats: LossStats, scheduler,
                 total_frames: float) -> float:
    """Feed the buffered per-batch stats to the host accumulator with
    one concatenation and one device-to-host copy, and stop on a
    non-finite loss."""
    if not pending:
        return total_frames
    block = torch.cat(pending).cpu().numpy()
    pending.clear()
    for xent, ent, correct, frames in block:
        if not np.isfinite(xent):
            raise FloatingPointError(
                f"non-finite loss after {scheduler.num_done} utterances "
                f"— learning rate too high or corrupt input; "
                f"xent={xent}")
        stats.add(LossAux(xent=float(xent), entropy=float(ent),
                          correct=float(correct), frames=float(frames)),
                  log_fn=lambda m: VLOG(1, m))
        total_frames += float(frames)
    return total_frames


def place_batch(b: StreamBatch, device) -> tuple[torch.Tensor, ...]:
    """(feats, tgt_ids, tgt_weights, mask, reset_flags) on `device`; to a
    card through pinned buffers and non-blocking copies."""
    arrs = (b.feats, b.tgt_ids, b.tgt_weights, b.mask, b.reset_flags)
    if torch.device(device).type != "cuda":
        return tuple(torch.from_numpy(a) for a in arrs)
    return tuple(torch.from_numpy(a).pin_memory().to(device,
                                                     non_blocking=True)
                 for a in arrs)


def _params_device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def run_epoch(nnet: Nnet, params, scheduler: StreamScheduler,
              opts: TrainOptions,
              transf: Optional[Nnet] = None, transf_params=(),
              crossvalidate: bool = False,
              opt_state: Optional[MomentumState] = None,
              dump_interval: int = 0, dump_fn=None) -> EpochResult:
    """One pass over the utterance source (one `bd-nnet-train-lstm-streams`
    invocation) on the device the params live on. `dump_fn(params,
    num_done)` is called every `dump_interval` utterances."""
    device = _params_device(params)
    step = make_train_step(nnet, opts, transf, crossvalidate, device=device)
    if opt_state is None:
        opt_state = init_momentum(params)
    states = nnet.init_states(scheduler.S, device)
    lr = torch.tensor(opts.learn_rate, dtype=torch.float32, device=device)
    stats = LossStats("Xent" if opts.objective == "xent" else "Mse")
    use_dropout = (not crossvalidate and any(
        getattr(c, "dropout_rate", 0.0) > 0 for c in nnet.components))
    rng = torch.Generator(device=device).manual_seed(777) \
        if use_dropout else None

    t_start = time.perf_counter()
    total_frames = 0.0
    consumed_done = 0   # utterances in trained batches (the scheduler
    last_report_done = 0  # runs ahead by the prefetch depth)
    last_dump_done = 0
    pending: list = []
    for b in PrefetchIterator(scheduler, depth=2):
        placed = place_batch(b, device)
        params, opt_state, states, aux = step(
            params, opt_state, states, transf_params, *placed, lr, rng=rng)
        pending.append(_pack_aux(aux))
        consumed_done += b.num_new_utts
        if len(pending) >= STATS_FLUSH:
            total_frames = _flush_stats(pending, stats, scheduler,
                                        total_frames)
        # speed report every 1000 utterances
        if consumed_done - last_report_done >= 1000:
            total_frames = _flush_stats(pending, stats, scheduler,
                                        total_frames)
            last_report_done = consumed_done - consumed_done % 1000
            t = time.perf_counter() - t_start
            VLOG(1, f"After {consumed_done} utterances: time elapsed = "
                    f"{t / 60:.2f} min; processed {total_frames / t:.0f} "
                    f"frames per second.")
        if (dump_interval > 0 and dump_fn is not None
                and consumed_done - last_dump_done >= dump_interval):
            last_dump_done = consumed_done - consumed_done % dump_interval
            if not crossvalidate:
                dump_fn(params, consumed_done)
    total_frames = _flush_stats(pending, stats, scheduler, total_frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return EpochResult(params=params, opt_state=opt_state, stats=stats,
                       num_done=scheduler.num_done,
                       total_frames=total_frames,
                       elapsed=time.perf_counter() - t_start)
