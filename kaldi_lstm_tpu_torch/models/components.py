"""The component (layer) system, PyTorch edition of
``kaldi_lstm_tpu.models.components``.

A component object holds only static configuration (dims, cell size,
shift, ...); parameters and recurrent state are explicit values passed
to ``apply`` (tensors, a dict of tensors, or an ``LstmParams``), so a
net's parameters are one tuple that lives on one device. Serialization
follows the Kaldi token format byte for byte, so each package reads the
other's model files.

Batch layout is stream-major [S, T, D].
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.ops.lstm_cell import (
    LstmParams,
    LstmState,
    init_lstm_params,
    lstm_scan,
    zero_state,
)
from kaldi_lstm_tpu_torch.ops.lstm_infer import lstm_infer, needs_grad
from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_train

Params = Any   # component parameters ({} when parameter-free)
State = Any    # recurrent state (None when stateless)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def moment_statistics(name: str, arr) -> str:
    """Tensor moment summary for Info() monitoring (Kaldi's
    MomentStatistics)."""
    a = _np(arr)
    if a.size == 0:
        return f"{name} [empty]"
    return (f"{name} [dim {'x'.join(map(str, a.shape))}] "
            f"min {a.min():.6g} max {a.max():.6g} "
            f"mean {a.mean():.6g} stddev {a.std():.6g}")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


class Component:
    """Base: static config + functions over explicit params/state."""

    token: str = ""
    updatable: bool = False
    stateful: bool = False
    uses_rng: bool = False
    # apply() is elementwise along [S, T], so [T, S] input works as well
    axis_invariant: bool = True

    def __init__(self, input_dim: int, output_dim: int):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    # --- numerics ---------------------------------------------------------
    def init_params(self, generator: torch.Generator, device=None) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor,
              state: State = None) -> tuple[torch.Tensor, State]:
        raise NotImplementedError

    def init_state(self, nstream: int, device=None) -> State:
        return None

    # --- serialization ----------------------------------------------------
    def read_data(self, inp: kio.KaldiInput, device=None) -> Params:
        return {}

    def write_data(self, out: kio.KaldiOutput, params: Params) -> None:
        pass

    def init_from_config(self, tokens: dict, generator: torch.Generator,
                         device=None) -> Params:
        """Build params from `<NnetProto>` line options (nnet-initialize)."""
        return self.init_params(generator, device)

    # --- monitoring -------------------------------------------------------
    def info(self, params: Params) -> str:
        return ""

    def num_params(self, params: Params) -> int:
        leaves = params.values() if isinstance(params, dict) else params
        return sum(int(t.numel()) for t in leaves)

    def __repr__(self):
        return (f"{type(self).__name__}(in={self.input_dim}, "
                f"out={self.output_dim})")


_REGISTRY: dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.token] = cls
    return cls


def component_from_token(token: str, input_dim: int,
                         output_dim: int) -> Component:
    if token not in _REGISTRY:
        raise ValueError(f"unknown component marker {token!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[token](input_dim, output_dim)


def _skip_learn_rate_coef(inp) -> None:
    # tolerate the newer-nnet1 optional <LearnRateCoef>
    if kio.peek_token(inp.stream) == "<LearnRateCoef>":
        kio.read_token(inp)
        kio.read_float(inp)


def _shifted_time_index(T: int, offset: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(T, device=device) + offset, 0, T - 1)


# ---------------------------------------------------------------------------
# simple pass-through / shift components
# ---------------------------------------------------------------------------

@register
class Transmit(Component):
    """Identity placeholder; leading non-updatable component in
    multi-stream nets."""

    token = "<Transmit>"

    def apply(self, params, x, state=None):
        return x, state


@register
class TimeShift(Component):
    """Target delay at decode: out[t] = in[clamp(t + shift)] along time,
    with edge clamping."""

    token = "<TimeShift>"
    axis_invariant = False

    def __init__(self, input_dim, output_dim, shift: int = 0):
        super().__init__(input_dim, output_dim)
        self.shift = int(shift)

    def apply(self, params, x, state=None):
        src = _shifted_time_index(x.shape[1], self.shift, x.device)
        return x[:, src, :], state

    def read_data(self, inp, device=None):
        tok = kio.read_token(inp)
        if tok != "<Shift>":
            raise ValueError(f"TimeShift: expected <Shift>, got {tok!r}")
        self.shift = kio.read_int32(inp)
        return {}

    def write_data(self, out, params):
        kio.write_token(out, "<Shift>")
        kio.write_int32(out, self.shift)
        if not out.binary:
            out.stream.write(b"\n")

    def init_from_config(self, tokens, generator, device=None):
        self.shift = int(tokens.get("<Shift>", 0))
        return {}


@register
class AddShift(Component):
    """Per-dim additive shift (CMVN mean subtraction in the feature
    transform)."""

    token = "<AddShift>"

    def init_params(self, generator, device=None):
        return {"shift": torch.zeros(self.input_dim, device=device)}

    def apply(self, params, x, state=None):
        return x + params["shift"], state

    def read_data(self, inp, device=None):
        _skip_learn_rate_coef(inp)
        return {"shift": _tensor(kio.read_vector(inp), device)}

    def write_data(self, out, params):
        kio.write_vector(out, _np(params["shift"]))

    def info(self, params):
        return moment_statistics("shift", params["shift"])


@register
class Rescale(Component):
    """Per-dim multiplicative rescale (CMVN 1/std)."""

    token = "<Rescale>"

    def init_params(self, generator, device=None):
        return {"scale": torch.ones(self.input_dim, device=device)}

    def apply(self, params, x, state=None):
        return x * params["scale"], state

    def read_data(self, inp, device=None):
        _skip_learn_rate_coef(inp)
        return {"scale": _tensor(kio.read_vector(inp), device)}

    def write_data(self, out, params):
        kio.write_vector(out, _np(params["scale"]))

    def info(self, params):
        return moment_statistics("scale", params["scale"])


@register
class Splice(Component):
    """Frame splicing over a context window:
    out[t] = concat(in[clamp(t + off)] for off in offsets)."""

    token = "<Splice>"
    axis_invariant = False

    def __init__(self, input_dim, output_dim, offsets=None):
        super().__init__(input_dim, output_dim)
        self.offsets = list(offsets) if offsets is not None else []

    def apply(self, params, x, state=None):
        T = x.shape[1]
        cols = [x[:, _shifted_time_index(T, off, x.device), :]
                for off in self.offsets]
        return torch.cat(cols, dim=-1), state

    def read_data(self, inp, device=None):
        # Kaldi writes the offsets as an integer vector "[ -2 -1 0 1 2 ]"
        # (text) / int-vector (binary)
        if inp.binary:
            self.offsets = [int(v) for v in kio.read_int_vector(inp)]
        else:
            tok = kio.read_token(inp)
            if tok != "[":
                raise ValueError("Splice: expected '['")
            self.offsets = []
            while True:
                tok = kio.read_token(inp)
                if tok == "]":
                    break
                self.offsets.append(int(tok))
        return {}

    def write_data(self, out, params):
        if out.binary:
            kio.write_int_vector(out, np.asarray(self.offsets, np.int32))
        else:
            out.stream.write(b"[ " + " ".join(
                str(o) for o in self.offsets).encode() + b" ]\n")

    def init_from_config(self, tokens, generator, device=None):
        if "<BuildVector>" in tokens:
            self.offsets = [int(v) for v in
                            tokens["<BuildVector>"].split(":")]
        else:
            left = int(tokens.get("<LeftContext>", 0))
            right = int(tokens.get("<RightContext>", 0))
            self.offsets = list(range(-left, right + 1))
        return {}


# ---------------------------------------------------------------------------
# activations / affine
# ---------------------------------------------------------------------------

@register
class Sigmoid(Component):
    token = "<Sigmoid>"

    def apply(self, params, x, state=None):
        return torch.sigmoid(x), state


@register
class Tanh(Component):
    token = "<Tanh>"

    def apply(self, params, x, state=None):
        return torch.tanh(x), state


@register
class Softmax(Component):
    """Row softmax. `Nnet.propagate(..., logits=True)` skips a trailing
    Softmax so the caller can take the pre-softmax activations."""

    token = "<Softmax>"

    def apply(self, params, x, state=None):
        return torch.softmax(x, dim=-1), state


@register
class LogSoftmax(Component):
    token = "<LogSoftmax>"

    def apply(self, params, x, state=None):
        return torch.log_softmax(x, dim=-1), state


@register
class Dropout(Component):
    """Standalone dropout: inverted dropout in training, exact identity
    at test time. Reads either <DropoutRate> or upstream's
    <DropoutRetention>."""

    token = "<Dropout>"
    uses_rng = True

    def __init__(self, input_dim, output_dim, dropout_rate: float = 0.5):
        super().__init__(input_dim, output_dim)
        self.dropout_rate = float(dropout_rate)

    def apply(self, params, x, state=None, rng=None, train=False):
        keep = 1.0 - self.dropout_rate
        if not train or rng is None or self.dropout_rate <= 0.0:
            return x, state
        u = torch.rand(x.shape, generator=rng, device=rng.device)
        return x * (u.to(x.device) < keep).to(x.dtype) / keep, state

    def read_data(self, inp, device=None):
        tok = kio.peek_token(inp.stream)
        if tok == "<DropoutRate>":
            kio.read_token(inp)
            self.dropout_rate = kio.read_float(inp)
        elif tok == "<DropoutRetention>":
            kio.read_token(inp)
            self.dropout_rate = 1.0 - kio.read_float(inp)
        return {}

    def write_data(self, out, params):
        kio.write_token(out, "<DropoutRate>")
        kio.write_float(out, self.dropout_rate)
        if not out.binary:
            out.stream.write(b"\n")

    def init_from_config(self, tokens, generator, device=None):
        if "<DropoutRetention>" in tokens:
            self.dropout_rate = 1.0 - float(tokens["<DropoutRetention>"])
        else:
            self.dropout_rate = float(tokens.get("<DropoutRate>", 0.5))
        return {}


@register
class AffineTransform(Component):
    """y = x W^T + b with W [out, in] (Kaldi orientation). The senone
    output layer is one plain matrix product (the JAX package leaves it
    to XLA too)."""

    token = "<AffineTransform>"
    updatable = True

    def __init__(self, input_dim, output_dim):
        super().__init__(input_dim, output_dim)
        self.learn_rate_coef = 1.0
        self.bias_learn_rate_coef = 1.0
        self.max_norm = 0.0

    def init_params(self, generator, device=None, param_stddev: float = 0.1,
                    bias_mean: float = 0.0, bias_range: float = 0.0):
        gd = generator.device
        w = torch.randn((self.output_dim, self.input_dim),
                        generator=generator, device=gd) * param_stddev
        b = bias_mean + (torch.rand((self.output_dim,), generator=generator,
                                    device=gd) - 0.5) * bias_range
        return {"linearity": w.to(device), "bias": b.to(device)}

    def apply(self, params, x, state=None):
        return torch.nn.functional.linear(x, params["linearity"],
                                          params["bias"]), state

    def read_data(self, inp, device=None):
        while kio.peek_token(inp.stream) in ("<LearnRateCoef>",
                                             "<BiasLearnRateCoef>",
                                             "<MaxNorm>"):
            tok = kio.read_token(inp)
            val = kio.read_float(inp)
            if tok == "<LearnRateCoef>":
                self.learn_rate_coef = val
            elif tok == "<BiasLearnRateCoef>":
                self.bias_learn_rate_coef = val
            else:
                self.max_norm = val
        w = kio.read_matrix(inp)
        b = kio.read_vector(inp)
        return {"linearity": _tensor(w, device), "bias": _tensor(b, device)}

    def write_data(self, out, params):
        kio.write_token(out, "<LearnRateCoef>")
        kio.write_float(out, self.learn_rate_coef)
        kio.write_token(out, "<BiasLearnRateCoef>")
        kio.write_float(out, self.bias_learn_rate_coef)
        kio.write_token(out, "<MaxNorm>")
        kio.write_float(out, self.max_norm)
        kio.write_matrix(out, _np(params["linearity"]))
        kio.write_vector(out, _np(params["bias"]))

    def init_from_config(self, tokens, generator, device=None):
        self.learn_rate_coef = float(tokens.get("<LearnRateCoef>", 1.0))
        self.bias_learn_rate_coef = float(
            tokens.get("<BiasLearnRateCoef>", 1.0))
        self.max_norm = float(tokens.get("<MaxNorm>", 0.0))
        return self.init_params(
            generator, device,
            param_stddev=float(tokens.get("<ParamStddev>", 0.1)),
            bias_mean=float(tokens.get("<BiasMean>", 0.0)),
            bias_range=float(tokens.get("<BiasRange>", 0.0)),
        )

    def info(self, params):
        return (moment_statistics("linearity", params["linearity"]) + "\n  "
                + moment_statistics("bias", params["bias"]))


# ---------------------------------------------------------------------------
# projected LSTM components
# ---------------------------------------------------------------------------

class _LstmBase(Component):
    updatable = True
    uses_rng = True
    axis_invariant = False
    # apply() accepts input_grad=False: the backward skips dx when the
    # layer's input needs no gradient (first layer over the features)
    accepts_input_grad_flag = True
    # apply() accepts time_major=True ([T, S, .] in and out), the
    # kernels' own layout, so the fused train step needs no transposes
    supports_time_major = True

    def __init__(self, input_dim, output_dim, cell_dim: int = 0,
                 param_scale: float = 0.02):
        super().__init__(input_dim, output_dim)
        self.cell_dim = int(cell_dim)
        self.recur_dim = int(output_dim)
        self.param_scale = float(param_scale)
        self.cell_clip = 50.0
        # newer-nnet1 <LearnRateCoef>: per-component LR multiplier
        self.learn_rate_coef = 1.0
        # forward-connection (gate pre-activation) dropout rate
        self.dropout_rate = 0.0

    def _dropout_mask(self, rng, x):
        """Bool KEEP mask [*, *, 4C] (layout-shaped) drawn from the
        component's generator ``rng`` on its own device; None when
        dropout is off."""
        if self.dropout_rate <= 0.0 or rng is None:
            return None
        keep = 1.0 - self.dropout_rate
        d0, d1, _ = x.shape  # [S,T] or [T,S]
        u = torch.rand((d0, d1, 4 * self.cell_dim), generator=rng,
                       device=rng.device)
        return (u < keep).to(x.device)

    def _run_scan(self, params, x, state, dropout_mask=None,
                  time_major=False, input_grad=True, advance_mask=None):
        """Dispatch on the call, the same for both devices: a training
        call (a gradient is needed, or a dropout mask is given) goes to
        ``lstm_train`` (K1/K2 on CUDA), an inference call to
        ``lstm_infer`` (K5 on CUDA); each takes its plain version for a
        CPU tensor. ``advance_mask`` runs the eager scan on the CPU only.
        """
        keep = 1.0 - self.dropout_rate
        if advance_mask is not None:
            if x.device.type == "cuda":
                raise NotImplementedError(
                    "advance_mask on CUDA: per-frame state gating in the "
                    "kernel is ROADMAP queue A item 3 (streaming scoring)")
            gate_mult = None if dropout_mask is None else \
                dropout_mask.to(x.dtype) / keep
            return lstm_scan(params, x, state, self.cell_clip,
                             gate_dropout_mask=gate_mult,
                             time_major=time_major,
                             advance_mask=advance_mask)
        if dropout_mask is not None or needs_grad(params, x, state):
            return lstm_train(params, x, state, self.cell_clip,
                              time_major=time_major,
                              gate_keep_mask=dropout_mask, keep_prob=keep,
                              need_input_grad=input_grad)
        return lstm_infer(params, x, state, self.cell_clip,
                          time_major=time_major)

    def init_params(self, generator, device=None) -> LstmParams:
        return init_lstm_params(generator, self.input_dim, self.cell_dim,
                                self.recur_dim, self.param_scale,
                                device=device)

    def _read_tensors(self, inp, device) -> LstmParams:
        return LstmParams(
            w_gifo_x=_tensor(kio.read_matrix(inp), device),
            w_gifo_r=_tensor(kio.read_matrix(inp), device),
            bias=_tensor(kio.read_vector(inp), device),
            peephole_i_c=_tensor(kio.read_vector(inp), device),
            peephole_f_c=_tensor(kio.read_vector(inp), device),
            peephole_o_c=_tensor(kio.read_vector(inp), device),
            w_r_m=_tensor(kio.read_matrix(inp), device),
        )

    def _write_tensors(self, out, p: LstmParams) -> None:
        kio.write_matrix(out, _np(p.w_gifo_x))
        kio.write_matrix(out, _np(p.w_gifo_r))
        kio.write_vector(out, _np(p.bias))
        kio.write_vector(out, _np(p.peephole_i_c))
        kio.write_vector(out, _np(p.peephole_f_c))
        kio.write_vector(out, _np(p.peephole_o_c))
        kio.write_matrix(out, _np(p.w_r_m))

    def _read_options(self, inp) -> None:
        while kio.peek_token(inp.stream) in ("<DropoutRate>",
                                             "<LearnRateCoef>"):
            tok = kio.read_token(inp)
            val = kio.read_float(inp)
            if tok == "<DropoutRate>":
                self.dropout_rate = val
            else:
                self.learn_rate_coef = val

    def _write_options(self, out) -> None:
        if self.dropout_rate > 0:
            kio.write_token(out, "<DropoutRate>")
            kio.write_float(out, self.dropout_rate)
        if self.learn_rate_coef != 1.0:
            kio.write_token(out, "<LearnRateCoef>")
            kio.write_float(out, self.learn_rate_coef)

    def _config_options(self, tokens) -> None:
        self.cell_dim = int(tokens["<CellDim>"])
        self.param_scale = float(tokens.get("<ParamScale>", 0.02))
        self.dropout_rate = float(tokens.get("<DropoutRate>", 0.0))
        self.learn_rate_coef = float(tokens.get("<LearnRateCoef>", 1.0))

    def info(self, p: LstmParams):
        return "\n  ".join(
            moment_statistics(f"{name}_", getattr(p, name))
            for name in LstmParams._fields)


@register
class LstmProjected(_LstmBase):
    """Single-sequence LSTMP: each call covers a whole utterance with zero
    initial state, no carry (the standard decode form)."""

    token = "<LstmProjected>"

    def apply(self, params: LstmParams, x, state=None, rng=None,
              train=False, time_major=False, input_grad=True):
        S = x.shape[1] if time_major else x.shape[0]
        st = zero_state(S, self.cell_dim, self.recur_dim, x.dtype, x.device)
        mask = self._dropout_mask(rng, x) if train else None
        out, _ = self._run_scan(params, x, st, mask, time_major=time_major,
                                input_grad=input_grad)
        return out, None

    def read_data(self, inp, device=None):
        tok = kio.read_token(inp)
        if tok != "<CellDim>":
            raise ValueError(f"LstmProjected: expected <CellDim>, got {tok!r}")
        self.cell_dim = kio.read_int32(inp)
        self._read_options(inp)
        return self._read_tensors(inp, device)

    def write_data(self, out, params):
        kio.write_token(out, "<CellDim>")
        kio.write_int32(out, self.cell_dim)
        self._write_options(out)
        self._write_tensors(out, params)

    def init_from_config(self, tokens, generator, device=None):
        self._config_options(tokens)
        return self.init_params(generator, device)


@register
class LstmProjectedStreams(_LstmBase):
    """Multi-stream LSTMP with cross-chunk state carry. `apply` takes
    and returns the (c, r) state; per-stream resets are applied by the
    caller *before* the chunk (`Nnet.reset_states`)."""

    token = "<LstmProjectedStreams>"
    stateful = True

    def __init__(self, input_dim, output_dim, cell_dim: int = 0,
                 nstream: int = 4, param_scale: float = 0.02):
        super().__init__(input_dim, output_dim, cell_dim, param_scale)
        self.nstream = int(nstream)

    def init_state(self, nstream: int, device=None) -> LstmState:
        return zero_state(nstream, self.cell_dim, self.recur_dim,
                          device=device)

    def apply(self, params: LstmParams, x, state: Optional[LstmState] = None,
              rng=None, train=False, time_major=False, input_grad=True,
              advance_mask=None):
        if state is None:
            nstream = x.shape[1] if time_major else x.shape[0]
            state = zero_state(nstream, self.cell_dim, self.recur_dim,
                               x.dtype, x.device)
        mask = self._dropout_mask(rng, x) if train else None
        return self._run_scan(params, x, state, mask, time_major=time_major,
                              input_grad=input_grad,
                              advance_mask=advance_mask)

    def read_data(self, inp, device=None):
        tok = kio.read_token(inp)
        if tok != "<CellDim>":
            raise ValueError(
                f"LstmProjectedStreams: expected <CellDim>, got {tok!r}")
        self.cell_dim = kio.read_int32(inp)
        tok = kio.read_token(inp)
        if tok != "<NumStream>":
            raise ValueError(
                f"LstmProjectedStreams: expected <NumStream>, got {tok!r}")
        self.nstream = kio.read_int32(inp)
        self._read_options(inp)
        return self._read_tensors(inp, device)

    def write_data(self, out, params):
        kio.write_token(out, "<CellDim>")
        kio.write_int32(out, self.cell_dim)
        kio.write_token(out, "<NumStream>")
        kio.write_int32(out, self.nstream)
        self._write_options(out)
        self._write_tensors(out, params)

    def init_from_config(self, tokens, generator, device=None):
        self._config_options(tokens)
        self.nstream = int(tokens.get("<NumStream>", 4))
        return self.init_params(generator, device)
