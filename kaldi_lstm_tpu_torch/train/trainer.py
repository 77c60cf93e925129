"""The training step, the grouped step and the epoch loop, PyTorch
edition of ``kaldi_lstm_tpu.train.trainer``.

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

The grouped step (`make_grouped_train_step`, the reference's lax.scan
device loop) runs B steps per call: on the card as one CUDA-graph
replay of the B steps, which takes the per-launch host cost of the ~100
kernels a step out of the loop; on the CPU as a loop.

The epoch loop (`run_epoch`) adds the host side: the stream scheduler
on a prefetch thread, the stacking and pinning of the next group on a
second one, non-blocking uploads on the compute stream, statistics kept
on the device and fetched once per `STATS_FLUSH` blocks (with the
non-finite check at each fetch), progress logs, periodic model dumps,
the `--verbose` moment dumps (`make_monitor_fn`) and the epoch profile:
the spans and counters it and the grouped step feed to the process-wide
registry (`utils.timer.PROFILE`), returned per epoch in
`EpochResult.profile`.
With a `plan` it runs the sharded steps of ``parallel/`` on this rank's
part of a ('data', 'model') mesh.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.models.components import (
    AffineTransform,
    Moments,
    Softmax,
    moment_statistics,
)
from kaldi_lstm_tpu_torch.models.nnet import Nnet
from kaldi_lstm_tpu_torch.ops.counts import add_counts, launch_counts
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
from kaldi_lstm_tpu_torch.utils import LOG, VLOG
from kaldi_lstm_tpu_torch.utils.timer import PROFILE
from kaldi_lstm_tpu_torch.utils.tree import (
    params_device,
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
                   time_major: bool = False, want_logits: bool = True,
                   fused_fn=None):
    """objective(params, x, states, tgt_ids, tgt_weights, mask, rng)
    -> (loss, (aux, new_states)). With `use_fused`, runs the stack up to
    the senone affine and hands the [N, R] frames to
    `fused_fn(r, w, b, ids, tw, mask, compute_dtype=)` (default
    `fused_affine_xent`, K3/K4 on the card; the sharded step passes the
    tensor-parallel loss) instead of forming logits. With `time_major` (fused
    only) the batch is transposed to [T, S, .] once at entry and the
    trunk runs in the LSTM kernels' own layout; the loss is a frame sum,
    so the flattening order is immaterial."""

    if fused_fn is None:
        fused_fn = fused_affine_xent

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
            loss, aux = fused_fn(
                y.reshape(n, y.shape[2]), aff["linearity"], aff["bias"],
                ids_f.reshape(n, -1), tw_f.reshape(n, -1), mask_f.reshape(n),
                compute_dtype=nnet.components[-2].matmul_dtype)
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
                  crossvalidate: bool, device, *,
                  use_fused: Optional[bool] = None, fused_fn=None,
                  reduce_fn=None, data_parallel: int = 1):
    """The single-step computation for tensors on `device`, shared by the
    plain, grouped and sharded (parallel/sharded_trainer.py) steps. It
    reads nothing back to the host and copies nothing from it, so a CUDA
    graph can capture it (`make_grouped_train_step`).

    The sharded step overrides `use_fused`/`fused_fn` (the
    tensor-parallel loss) and passes `reduce_fn(grads, aux) -> (grads,
    aux)`, which sums the gradients (None in cross-validation) and the
    statistics over the data ranks before the update, and
    `data_parallel`, the number of data ranks, so that the penalties'
    frame count is the global batch's."""
    if use_fused is None:
        use_fused = default_use_fused(nnet, opts, device)
    objective_fn = make_objective(
        nnet, _LOSS_FNS[opts.objective], use_fused, train=not crossvalidate,
        time_major=use_fused and trunk_supports_time_major(nnet),
        want_logits=opts.objective == "xent", fused_fn=fused_fn)
    # the filler guard's momentum pair as device constants, made once
    mmt_real = torch.tensor(opts.momentum, dtype=torch.float32, device=device)
    mmt_filler = torch.ones((), dtype=torch.float32, device=device)

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
                if reduce_fn is not None:
                    _, aux = reduce_fn(None, aux)
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
        if reduce_fn is not None:
            grads, aux = reduce_fn(grads, aux)
        # A fully-masked filler batch must be an exact no-op on params
        # and momentum: lr 0 and momentum 1 carry both through unchanged
        # (device scalars, no host sync).
        real = aux.frames > 0
        lr_eff = learn_rate * real.to(torch.float32)
        mmt_eff = torch.where(real, mmt_real, mmt_filler)
        params, opt_state = momentum_update(
            params, grads, opt_state, lr_eff, mmt_eff, opts.grad_clip,
            lr_scale=build_lr_scale(nnet, params),
            l1_penalty=opts.l1_penalty, l2_penalty=opts.l2_penalty,
            num_frames=feats.shape[0] * feats.shape[1] * data_parallel,
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


def pack_aux(aux: LossAux) -> torch.Tensor:
    """[1, 4] float32 device row (xent, entropy, correct, frames)."""
    return torch.stack([torch.as_tensor(v).to(torch.float32).reshape(())
                        for v in aux]).reshape(1, 4)


def flush_aux(pending: list, stats: LossStats, log_fn=None) -> np.ndarray:
    """Feed the `pack_aux` rows in `pending` to `stats`, in order, with
    one device-to-host copy, and clear `pending`: the epoch loop and the
    per-utterance and per-minibatch tools fetch their statistics in
    blocks instead of syncing on every step. Returns the rows fed."""
    if not pending:
        return np.zeros((0, 4), np.float32)
    block = torch.cat(pending).cpu().numpy()
    pending.clear()
    for xent, ent, correct, frames in block:
        stats.add(LossAux(xent=float(xent), entropy=float(ent),
                          correct=float(correct), frames=float(frames)),
                  log_fn=log_fn)
    return block


class _GroupedStep:
    """B consecutive steps per call, over batch tensors with a leading
    [B] axis: (params, opt_state, states, transf_params, feats, tgt_ids,
    tgt_weights, mask, reset_flags, learn_rate, rng) -> (params,
    opt_state, states, aux [B, 4] float32 rows of (xent, entropy,
    correct, frames)).

    On the CPU the B steps run as a loop. On CUDA the object owns static
    device buffers for the B batches, the lr, the carried state and the
    [B, 4] aux block; its first call runs the B steps eagerly on a side
    stream (the warm-up: a real group of the epoch, so nothing is undone
    after it); its second call captures the B steps in one
    `torch.cuda.CUDAGraph` and every call from then on copies the group
    into the buffers on the current stream and replays the graph. The
    graph binds the live params, momentum and feature-transform tensors
    (the step updates them in place), so every call must pass those same
    tensors. A dropout generator is registered with the graph, so every
    replay draws fresh masks, the ones the plain steps would draw.

    `capture_ms` and `pool_bytes` say what the capture cost: its wall
    time and the device memory the graph's private pool took. On the
    card each call is timed in `utils.timer.PROFILE`'s spans
    `step.upload`, `step.warm_up`, `step.capture` and `step.replay`, and
    its counter `step.replays` counts the replays (a caller can show that
    a grouped epoch replayed and did not run eagerly); no span is opened
    inside the captured body."""

    def __init__(self, nnet: Nnet, opts: TrainOptions,
                 transf: Optional[Nnet], crossvalidate: bool, device,
                 group: int):
        if group < 1:
            raise ValueError(f"step group must be >= 1, got {group}")
        self.B = int(group)
        self.device = torch.device(device)
        self.step = _make_step_fn(nnet, opts, transf, crossvalidate,
                                  self.device)
        self.calls = 0
        self.graph = None
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._delta: dict = {}
        self._bound: list = []

    def _steps(self, params, opt_state, states, transf_params, batches,
               learn_rate, rng):
        rows = []
        for i in range(self.B):
            params, opt_state, states, aux = self.step(
                params, opt_state, states, transf_params,
                *(t[i] for t in batches), learn_rate, rng=rng)
            rows.append(pack_aux(aux))
        return params, opt_state, states, torch.cat(rows)

    def __call__(self, params, opt_state, states, transf_params, feats,
                 tgt_ids, tgt_weights, mask, reset_flags, learn_rate,
                 rng=None):
        batches = (feats, tgt_ids, tgt_weights, mask, reset_flags)
        if any(t.shape[0] != self.B for t in batches):
            raise ValueError(f"grouped step: every batch tensor needs a "
                             f"leading axis of {self.B}")
        self.calls += 1
        if self.device.type != "cuda":
            return self._steps(params, opt_state, states, transf_params,
                               batches, learn_rate, rng)
        if self.calls == 1:
            self._allocate(batches, states)
        with PROFILE.section("step.upload"):
            for buf, t in zip(self._inputs, batches):
                if buf.shape != t.shape or buf.dtype != t.dtype:
                    raise ValueError(
                        f"grouped step: batch {tuple(t.shape)} {t.dtype} "
                        f"differs from the captured {tuple(buf.shape)} "
                        f"{buf.dtype}")
                buf.copy_(t, non_blocking=True)
            self._lr.copy_(learn_rate)
            if states is not self._states:
                for dst, src in zip(tree_leaves(self._states),
                                    tree_leaves(states)):
                    dst.copy_(src)
        bound = tree_leaves((params, opt_state, transf_params))
        if self.calls == 1:
            self._bound = bound
            with PROFILE.section("step.warm_up"):
                self._warm_up(params, opt_state, transf_params, rng)
        else:
            if (len(bound) != len(self._bound)
                    or any(a is not b for a, b in zip(bound, self._bound))):
                raise ValueError("grouped step: the graph binds the params, "
                                 "momentum and transform tensors of its "
                                 "first call; pass those same tensors")
            if self.graph is None:
                with PROFILE.section("step.capture"):
                    self._capture(params, opt_state, transf_params, rng)
            with PROFILE.section("step.replay"):
                self.graph.replay()
            add_counts(self._delta)
            PROFILE.add("step.replays")
        return params, opt_state, self._states, self._aux.clone()

    def _allocate(self, batches, states) -> None:
        dev = self.device
        self._inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                        for t in batches]
        self._lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._states = tree_map(torch.empty_like, states)
        self._aux = torch.empty((self.B, 4), dtype=torch.float32,
                                device=dev)

    def _body(self, params, opt_state, transf_params, rng) -> None:
        """The B steps on the static buffers, their results written back
        into them: what the graph holds."""
        _, _, states, aux = self._steps(params, opt_state, self._states,
                                        transf_params, self._inputs,
                                        self._lr, rng)
        self._aux.copy_(aux)
        for dst, src in zip(tree_leaves(self._states), tree_leaves(states)):
            dst.copy_(src)

    def _warm_up(self, params, opt_state, transf_params, rng) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body(params, opt_state, transf_params, rng)
        main.wait_stream(side)

    def _capture(self, params, opt_state, transf_params, rng) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # a captured graph bumps the launch counters once, at capture;
        # take that back and add the capture's delta at every replay, so
        # the counts stay per launch
        before = launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if rng is not None:
            graph.register_generator_state(rng)
        # thread-local mode: the staging thread may pin host memory while
        # this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._body(params, opt_state, transf_params, rng)
        torch.cuda.synchronize(self.device)
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = launch_counts()
        self._delta = {k: after[k] - before[k] for k in after}
        add_counts({k: -d for k, d in self._delta.items()})
        self.graph = graph
        LOG(f"grouped step: {self.B} steps captured in one CUDA graph in "
            f"{self.capture_ms:.1f} ms; graph pool "
            f"{self.pool_bytes / 2**20:.1f} MB")


def make_grouped_train_step(nnet: Nnet, opts: TrainOptions,
                            transf: Optional[Nnet] = None,
                            crossvalidate: bool = False, *, device,
                            group: int) -> _GroupedStep:
    """`group` steps per call (a CUDA-graph replay on the card, a loop on
    the CPU): the reference's grouped step, whose lax.scan device loop
    amortises the per-step dispatch. `crossvalidate` groups the CV pass
    the same way (params pass through unchanged)."""
    return _GroupedStep(nnet, opts, transf, crossvalidate, device, group)


# ---------------------------------------------------------------------------
# first-batch moment dumps (--verbose >= 1)
# ---------------------------------------------------------------------------

def _moms4(a: torch.Tensor) -> torch.Tensor:
    """[min, max, mean, std] of a tensor as one tiny device tensor."""
    a32 = a.detach().to(torch.float32)
    return torch.stack([a32.min(), a32.max(), a32.mean(),
                        a32.std(correction=0)])


def make_monitor_fn(nnet: Nnet, opts: TrainOptions, transf: Optional[Nnet],
                    crossvalidate: bool, *, device):
    """The first-minibatch introspection (reference :232-239
    InfoPropagate/InfoGradient/InfoBackPropagate) as one function that
    returns ONE [N, 4] device tensor of moments: activation rows, then
    the gradient leaves in tree order, then the backprop rows (d loss /
    d input of each component). Every moment is reduced on the device,
    so the caller fetches N x 4 floats in one copy. The gradients come
    from the step's own objective (K1/K2 and K3/K4 on the card), the
    backprop rows from one cotangent chain over per-component autograd
    graphs."""
    loss_fn = _LOSS_FNS[opts.objective]
    comps = nnet.components
    # combined softmax+xent: the diff enters at the logits
    n_bp = len(comps) - (1 if isinstance(comps[-1], Softmax) else 0)
    objective_fn = make_objective(
        nnet, loss_fn, default_use_fused(nnet, opts, device), train=False,
        want_logits=opts.objective == "xent")

    def monitor(params, transf_params, x, states, ids, w, mask):
        if transf is not None:
            with torch.no_grad():
                x = transf.feedforward(transf_params, x)
        ins, acts = [], [x]
        with torch.set_grad_enabled(not crossvalidate):
            a = x
            for c, p, s in zip(comps, params, states):
                a = a.detach().requires_grad_(not crossvalidate)
                ins.append(a)
                a, _ = c.apply(p, a, s)
                acts.append(a)
        rows = [_moms4(t) for t in acts]
        if crossvalidate:
            return torch.stack(rows)

        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = objective_fn(live, x, states, ids, w, mask, None)
            flat = tree_leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            rows += [_moms4(torch.zeros_like(p) if g is None else g)
                     for p, g in zip(flat, grads)]
            y = acts[n_bp].detach().requires_grad_(True)
            cot = torch.autograd.grad(loss_fn(y, ids, w, mask)[0], y)[0]
            bp_m = [None] * n_bp
            for i in range(n_bp - 1, -1, -1):
                # d loss / d acts[i] = input of component i
                cot = torch.autograd.grad(acts[i + 1], ins[i], cot)[0]
                bp_m[i] = _moms4(cot)
        return torch.stack(rows + bp_m)

    return monitor


def _monitor_first_batch(nnet, params, transf, transf_params,
                         batch: StreamBatch, opts, crossvalidate,
                         total_frames: int = 0, level: int = 1) -> None:
    """Format and VLOG the moment dumps (reference :232-239 output layout
    at the first minibatch; :251-260 every-25k-frames repeat at vlog-2,
    `level=2`), from fresh zero states."""
    device = params_device(params)
    monitor = make_monitor_fn(nnet, opts, transf, crossvalidate,
                              device=device)
    S, T = batch.feats.shape[:2]
    feats, ids, w, mask, _ = place_batch(batch, device)
    # ONE [N, 4] tensor, fetched with one copy, split on the host (rows:
    # activations, gradient leaves, backprop diffs)
    packed = monitor(params, transf_params, feats,
                     nnet.init_states(S, device), ids, w, mask).cpu().numpy()
    n_act = len(nnet.components) + 1

    def moms(dim, m):
        return Moments((S, T, dim), m[0], m[1], m[2], m[3])

    comps = nnet.components
    in_dim = transf.output_dim if transf is not None else nnet.input_dim
    dims = [in_dim] + [c.output_dim for c in comps]
    VLOG(level, f"### After {total_frames} frames,")
    VLOG(level, nnet.propagate_text(
        [moms(d, m) for d, m in zip(dims, packed)]))
    if crossvalidate:
        return

    leaves = tree_leaves(params)
    grad_m = packed[n_act:n_act + len(leaves)]
    bp_m = packed[n_act + len(leaves):]
    mom_tree = tree_unflatten(params, [
        Moments(p.shape, *m) for p, m in zip(leaves, grad_m)])
    VLOG(level, nnet.info_gradient(mom_tree))
    lines = ["### Backward propagation buffer content :"]
    for c, m in zip(comps, bp_m):
        lines.append("  " + moment_statistics(
            f"[diff at input of {c.token[1:-1]}]", moms(c.input_dim, m)))
    VLOG(level, "\n".join(lines))


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

class EpochResult(NamedTuple):
    params: Any
    opt_state: MomentumState
    stats: LossStats
    num_done: int
    total_frames: float
    elapsed: float
    # the epoch's change in utils.timer.PROFILE: span seconds and counters
    profile: Optional[dict] = None


STATS_FLUSH = 32  # aux blocks of device stats fetched per host transfer
REPORT_EVERY = 1000  # utterances between speed reports (:263-267)


def _flush_stats(pending: list, stats: LossStats, scheduler,
                 total_frames: float) -> float:
    """Feed the buffered per-batch stats to the host accumulator
    (`flush_aux`) and stop on a non-finite loss."""
    block = flush_aux(pending, stats, log_fn=lambda m: VLOG(1, m))
    for xent, _, _, frames in block:
        if not np.isfinite(xent):
            raise FloatingPointError(
                f"non-finite loss after {scheduler.num_done} utterances "
                f"— learning rate too high or corrupt input; "
                f"xent={xent}")
        total_frames += float(frames)
    return total_frames


def _batch_arrays(b: StreamBatch) -> tuple:
    return (b.feats, b.tgt_ids, b.tgt_weights, b.mask, b.reset_flags)


def _host_tensors(arrays, pin: bool) -> tuple[torch.Tensor, ...]:
    """Host tensors over numpy arrays, in pinned memory for a card."""
    ts = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return _pinned(ts) if pin else ts


def _pinned(ts: tuple) -> tuple[torch.Tensor, ...]:
    return tuple(t.pin_memory() for t in ts)


def _to_device(host: tuple, device) -> tuple[torch.Tensor, ...]:
    if torch.device(device).type != "cuda":
        return host
    return tuple(t.to(device, non_blocking=True) for t in host)


def place_arrays(arrays, device) -> tuple[torch.Tensor, ...]:
    """Numpy arrays as tensors on `device`; to a card through pinned
    buffers and non-blocking copies."""
    cuda = torch.device(device).type == "cuda"
    return _to_device(_host_tensors(arrays, cuda), device)


def place_batch(b: StreamBatch, device) -> tuple[torch.Tensor, ...]:
    """(feats, tgt_ids, tgt_weights, mask, reset_flags) on `device`."""
    return place_arrays(_batch_arrays(b), device)


def _stage_group(group: list, pin: bool) -> tuple[torch.Tensor, ...]:
    """The group's batches stacked along a leading [B] axis, on the host
    (pinned for a card); the grouped step copies them in."""
    with PROFILE.section("stage.stack"):
        host = _host_tensors([np.stack(a) for a in zip(
            *(_batch_arrays(b) for b in group))], False)
    if not pin:
        return host
    with PROFILE.section("stage.pin"):
        return _pinned(host)


def _stage_batches(group: list, pin: bool) -> list:
    """Each batch of the group as its own host tensors (pinned for a
    card), for the per-batch step."""
    with PROFILE.section("stage.stack"):
        hosts = [_host_tensors(_batch_arrays(b), False) for b in group]
    if not pin:
        return hosts
    with PROFILE.section("stage.pin"):
        return [_pinned(h) for h in hosts]


def run_epoch(nnet: Nnet, params, scheduler: StreamScheduler,
              opts: TrainOptions,
              transf: Optional[Nnet] = None, transf_params=(),
              crossvalidate: bool = False,
              opt_state: Optional[MomentumState] = None,
              dump_interval: int = 0, dump_fn=None,
              monitor_verbose: int = 0,
              step_group: int = 1,
              plan=None, sync_every: int = 1) -> EpochResult:
    """One pass over the utterance source (one `bd-nnet-train-lstm-streams`
    invocation) on the device the params live on. `dump_fn(params,
    num_done)` is called every `dump_interval` utterances (:275-281).
    `monitor_verbose >= 1`
    prints the InfoPropagate/InfoGradient moment dumps at the first
    minibatch (:232-239), `>= 2` also every 25k frames (:251-260).
    `step_group > 1` runs that many batches per grouped step (one
    CUDA-graph replay on the card; identical math, dump and monitor
    checks at group granularity); a tail group shorter than that takes
    the plain step.

    `plan` (a parallel.MeshPlan) switches the epoch to the SHARDED steps
    on this rank's streams and parameters (`plan.place_params`; the
    params returned stay sharded: `plan.gather_params` before writing).
    The scheduler is wrapped in a SyncedScheduler (continue-flag
    agreement every `sync_every` steps), so every rank runs the same
    number of collective steps; the statistics are the global batch's
    (S_global = S x world / M streams). The grouped sharded step is a
    loop of sharded steps. With several processes the scheduler and the
    staging run on this thread (the continue flag is a collective and
    must interleave with the steps in one order), the dump trigger
    counts global steps (a local-utterance trigger could fire the
    collective gather on one rank only) and first-batch monitoring is
    skipped."""
    device = params_device(params)
    use_group = step_group > 1
    multiproc = False
    if plan is not None:
        from kaldi_lstm_tpu_torch.parallel.multihost import (
            SyncedScheduler,
        )
        from kaldi_lstm_tpu_torch.parallel.sharded_trainer import (
            make_sharded_grouped_train_step,
            make_sharded_train_step,
        )
        multiproc = plan.mesh.world > 1
        device = plan.mesh.device
        if not isinstance(scheduler, SyncedScheduler):
            scheduler = SyncedScheduler(scheduler,
                                        agree_every=max(1, sync_every))
        S_global = scheduler.S * plan.mesh.world // plan.mesh.shape["model"]
        global_states = nnet.init_states(S_global, "cpu")
        step = None if use_group else make_sharded_train_step(
            nnet, opts, plan, transf, crossvalidate,
            states_example=global_states)
        gstep = make_sharded_grouped_train_step(
            nnet, opts, plan, transf, crossvalidate,
            states_example=global_states) if use_group else None
        if opt_state is None:
            opt_state = init_momentum(params)
        params = plan.place_params(params)
        opt_state = plan.place_opt(opt_state)
        states = plan.place_states(global_states)
        if multiproc:
            monitor_verbose = 0
    else:
        step = None if use_group else make_train_step(
            nnet, opts, transf, crossvalidate, device=device)
        gstep = make_grouped_train_step(
            nnet, opts, transf, crossvalidate, device=device,
            group=step_group) if use_group else None
        if opt_state is None:
            opt_state = init_momentum(params)
        states = nnet.init_states(scheduler.S, device)
    cuda = device.type == "cuda"
    lr = torch.tensor(opts.learn_rate, dtype=torch.float32, device=device)
    stats = LossStats("Xent" if opts.objective == "xent" else "Mse")
    use_dropout = (not crossvalidate and any(
        getattr(c, "dropout_rate", 0.0) > 0 for c in nnet.components))
    # a mesh's model ranks of one data position draw the same masks
    seed = 777 + (plan.mesh.data_index if plan is not None else 0)
    rng = torch.Generator(device=device).manual_seed(seed) \
        if use_dropout else None

    before = PROFILE.snapshot()
    t_start = time.perf_counter()
    total_frames = 0.0
    consumed_done = 0   # utterances in trained batches (the scheduler
    last_report_done = 0  # runs ahead by the prefetch depth)
    last_dump_done = 0
    monitor_frames = 0  # host-side masked-frame count (:241 semantics)
    first_batch = True
    num_steps = 0
    pending: list = []  # [n, 4] device blocks of per-step stats

    def drain(trigger: str) -> None:
        """Fetch the pending stats (a wait for every queued kernel on a
        card) and, at the end, synchronize: the span `epoch.sync` and
        one count of `epoch.sync.<trigger>`, where there was anything to
        fetch or wait for."""
        nonlocal total_frames
        if not pending and trigger != "end":
            return
        with PROFILE.section("epoch.sync"):
            total_frames = _flush_stats(pending, stats, scheduler,
                                        total_frames)
            if trigger == "end" and cuda:
                torch.cuda.synchronize(device)
        PROFILE.add("epoch.sync." + trigger)

    def batched_source():
        """Lists of up to `step_group` StreamBatches; the scheduler runs
        on the first prefetch thread."""
        group: list = []
        # several processes: the continue-flag agreement is a collective,
        # so the scheduler runs on this thread, in step order
        it = scheduler if multiproc else PrefetchIterator(
            scheduler, depth=max(2, step_group + 1))
        for b in it:
            group.append(b)
            if len(group) >= step_group:
                yield group
                group = []
        if group:
            yield group

    def staged_source():
        """(group, kind, host tensors): kind 'g' is one grouped step,
        's' per-batch steps. Stacking and pinning are the spans
        `stage.stack` and `stage.pin`."""
        for group in batched_source():
            if use_group and len(group) == step_group:
                yield group, "g", _stage_group(group, cuda)
            else:
                yield group, "s", _stage_batches(group, cuda)

    # second pipeline stage: stacking and pinning run on their own
    # thread; the uploads stay on this thread's compute stream
    src_it = iter(staged_source() if multiproc
                  else PrefetchIterator(staged_source(), depth=2))

    while True:
        with PROFILE.section("epoch.wait"):
            item = next(src_it, None)
        if item is None:
            break
        if first_batch and monitor_verbose >= 1:
            _monitor_first_batch(nnet, params, transf, transf_params,
                                 item[0][0], opts, crossvalidate)
        first_batch = False
        # the group's bookkeeping, its step calls and their uploads; the
        # unpacking frees the last group's pinned buffers (the caching
        # host allocator records an event for each), which takes
        # milliseconds while the staging thread pins the next group
        with PROFILE.section("epoch.dispatch"):
            group, kind, staged = item
            prev_monitor_frames = monitor_frames
            monitor_frames += sum(int(g.mask.sum()) for g in group)
            consumed_done += sum(g.num_new_utts for g in group)
            if kind == "g":
                if plan is not None:  # the loop of sharded steps reads them
                    staged = _to_device(staged, device)
                params, opt_state, states, aux = gstep(
                    params, opt_state, states, transf_params, *staged, lr,
                    rng=rng)
                pending.append(aux)
            else:
                for host in staged:
                    if step is None and plan is not None:
                        step = make_sharded_train_step(
                            nnet, opts, plan, transf, crossvalidate,
                            states_example=global_states)
                    elif step is None:  # a grouped epoch's tail
                        step = make_train_step(nnet, opts, transf,
                                               crossvalidate, device=device)
                    params, opt_state, states, aux = step(
                        params, opt_state, states, transf_params,
                        *_to_device(host, device), lr, rng=rng)
                    # stats stay on the device and come back in blocks: a
                    # per-step copy would stall the host every step
                    pending.append(pack_aux(aux))
            num_steps += len(group)
            PROFILE.add("epoch.steps", len(group))

        if (monitor_verbose >= 2
                and prev_monitor_frames // 25000
                != monitor_frames // 25000):
            # every-25k-frames moment dump at vlog-2 (reference
            # :251-260): post-step params, post-increment frame label;
            # under grouping the dump lands at group granularity
            _monitor_first_batch(nnet, params, transf, transf_params,
                                 group[0], opts, crossvalidate,
                                 total_frames=monitor_frames, level=2)

        if len(pending) >= STATS_FLUSH:
            drain("block")
        # speed report every REPORT_EVERY utterances (:263-267)
        if consumed_done - last_report_done >= REPORT_EVERY:
            drain("report")
            last_report_done = consumed_done - consumed_done % REPORT_EVERY
            t = time.perf_counter() - t_start
            VLOG(1, f"After {consumed_done} utterances: time elapsed = "
                    f"{t / 60:.2f} min; processed {total_frames / t:.0f} "
                    f"frames per second.")
        # several processes: trigger on the global step count (the same
        # on every rank), since the gather inside dump_fn is collective
        dump_progress = num_steps if multiproc else consumed_done
        if (dump_interval > 0 and dump_fn is not None
                and dump_progress - last_dump_done >= dump_interval):
            last_dump_done = dump_progress - dump_progress % dump_interval
            if not crossvalidate:
                dump_fn(params, consumed_done)
    drain("end")
    elapsed = time.perf_counter() - t_start
    profile = PROFILE.since(before)
    if monitor_verbose >= 2:
        # `wait` is this thread starving on the staging thread,
        # `dispatch` the step calls with their uploads, `stats` the
        # blocking stats fetches; stacking and pinning overlap them
        wait, dispatch, sync = (profile.get(k, 0.0) for k in (
            "epoch.wait", "epoch.dispatch", "epoch.sync"))
        stage = profile.get("stage.stack", 0.0) + profile.get("stage.pin",
                                                              0.0)
        other = elapsed - wait - dispatch - sync
        graph = ""
        # the grouped sharded step is a loop, not a captured graph
        if getattr(gstep, "graph", None) is not None:
            graph = (f"; graph capture {gstep.capture_ms:.1f} ms, pool "
                     f"{gstep.pool_bytes / 2**20:.1f} MB")
        LOG(f"epoch profile ({profile['epoch.steps']} steps, {elapsed:.2f}s "
            f"wall): wait_data {wait:.2f}s, dispatch {dispatch:.2f}s, "
            f"stats_fetch {sync:.2f}s, other_host {other:.2f}s (stage+pin "
            f"{stage:.2f}s, overlapped){graph}")
    return EpochResult(params=params, opt_state=opt_state, stats=stats,
                       num_done=scheduler.num_done,
                       total_frames=total_frames, elapsed=elapsed,
                       profile=profile)
