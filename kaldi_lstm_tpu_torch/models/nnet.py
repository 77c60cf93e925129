"""Sequential Nnet container: propagate + Kaldi serialization, PyTorch
edition of ``kaldi_lstm_tpu.models.nnet``.

The container holds the static component stack; parameters and
recurrent states are explicit tuples (one entry per component) whose
tensors live on one device. Serialization: `<Nnet>` ... per-component
`<Marker> out_dim in_dim` + component data ... `</Nnet>`, in Kaldi text
or binary mode, byte-compatible with the JAX package.
"""

from __future__ import annotations

import io
from typing import Any, List, Optional

import torch

from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import components as comp
from kaldi_lstm_tpu_torch.models.components import Component, Softmax
from kaldi_lstm_tpu_torch.ops.lstm_infer import check_compute_dtype

ParamsList = Any  # tuple of per-component params
StatesList = Any  # tuple of per-component states (None if stateless)


class Nnet:
    """Static component stack. Params/states live outside the object."""

    def __init__(self, components: Optional[List[Component]] = None):
        self.components: List[Component] = components or []

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------
    @property
    def input_dim(self) -> int:
        return self.components[0].input_dim if self.components else 0

    @property
    def output_dim(self) -> int:
        return self.components[-1].output_dim if self.components else 0

    def append(self, component: Component) -> None:
        self.components.append(component)

    def set_matmul_dtype(self, dtype) -> None:
        """Set every matmul component's ``matmul_dtype`` (the reference's
        global ``set_matmul_dtype``, here a property of the net): None
        for float32 products, torch.bfloat16 for bf16 operands with
        float32 sums."""
        check_compute_dtype(dtype, "set_matmul_dtype")
        for c in self.components:
            if hasattr(c, "matmul_dtype"):
                c.matmul_dtype = dtype

    def __len__(self):
        return len(self.components)

    # ------------------------------------------------------------------
    # numerics
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    device=None) -> ParamsList:
        return tuple(c.init_params(generator, device)
                     for c in self.components)

    def init_states(self, nstream: int, device=None) -> StatesList:
        return tuple(c.init_state(nstream, device) for c in self.components)

    def propagate(self, params: ParamsList, x: torch.Tensor,
                  states: Optional[StatesList] = None,
                  logits: bool = False,
                  rng: Optional[torch.Generator] = None,
                  train: bool = False,
                  advance_mask: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, StatesList]:
        """Forward through all components ([S, T, D] activations).

        With ``logits=True`` a trailing Softmax is skipped so the caller
        gets pre-softmax activations. ``rng``/``train`` feed stochastic
        components (dropout). ``advance_mask`` ([S, T] 0/1) freezes the
        carried state of stateful components at masked frames.
        """
        if states is None:
            states = tuple(None for _ in self.components)
        new_states = []
        for i, (c, p, s) in enumerate(zip(self.components, params, states)):
            if logits and i == len(self.components) - 1 and \
                    isinstance(c, Softmax):
                new_states.append(s)
                break
            kwargs = {}
            if advance_mask is not None and c.stateful:
                kwargs["advance_mask"] = advance_mask
            if c.uses_rng:
                x, s2 = c.apply(p, x, s, rng=rng, train=train, **kwargs)
            else:
                x, s2 = c.apply(p, x, s, **kwargs)
            new_states.append(s2)
        return x, tuple(new_states)

    def feedforward(self, params: ParamsList,
                    x: torch.Tensor) -> torch.Tensor:
        """Propagate without carrying state (decode / feature transform)."""
        y, _ = self.propagate(params, x)
        return y

    def reset_states(self, states: StatesList,
                     reset_flags: torch.Tensor) -> StatesList:
        """Zero the state rows of streams whose flag is 1 (`reset_flags`
        is [S]; 1 = new utterance in that stream)."""
        keep = 1.0 - reset_flags.to(torch.float32)

        def mask_leaf(leaf):
            return leaf * keep.to(leaf.device).reshape(
                (-1,) + (1,) * (leaf.dim() - 1))

        return tuple(
            None if s is None else type(s)(*(mask_leaf(t) for t in s))
            for s in states)

    # ------------------------------------------------------------------
    # monitoring
    # ------------------------------------------------------------------
    def num_params(self, params: ParamsList) -> int:
        return sum(c.num_params(p)
                   for c, p in zip(self.components, params))

    def info(self, params: ParamsList) -> str:
        lines = [f"num-components {len(self.components)}",
                 f"input-dim {self.input_dim}",
                 f"output-dim {self.output_dim}",
                 f"number-of-parameters {self.num_params(params) / 1e6:.4g} "
                 f"millions"]
        for i, (c, p) in enumerate(zip(self.components, params)):
            lines.append(f"component {i + 1} : {c.token[1:-1]}, "
                         f"input-dim {c.input_dim}, "
                         f"output-dim {c.output_dim}")
            s = c.info(p)
            if s:
                lines.append("  " + s)
        return "\n".join(lines)

    @torch.no_grad()
    def info_propagate(self, params: ParamsList, x: torch.Tensor,
                       states: Optional[StatesList] = None) -> str:
        """Per-component activation moment statistics (the reference's
        InfoPropagate dump at the first minibatch and every 25k frames,
        bd-nnet-train-lstm-streams.cc:232-260)."""
        if states is None:
            states = tuple(None for _ in self.components)
        acts = [x]
        for c, p, s in zip(self.components, params, states):
            x, _ = c.apply(p, x, s)
            acts.append(x)
        return self.propagate_text(acts)

    def propagate_text(self, acts) -> str:
        """The forward-propagation dump of the input and each component's
        output; `acts` holds tensors or `Moments`."""
        lines = ["### Forward propagation buffer content :",
                 "  " + comp.moment_statistics("[input]", acts[0])]
        for c, a in zip(self.components, acts[1:]):
            lines.append("  " + comp.moment_statistics(
                f"[output of {c.token[1:-1]}]", a))
        return "\n".join(lines)

    def info_gradient(self, grads: ParamsList) -> str:
        """Per-component gradient moment statistics; `grads` holds
        tensors or `Moments` in the params' shape."""
        lines = []
        for c, g in zip(self.components, grads):
            s = c.info_gradient(g)
            if s:
                lines.append(f"{c.token[1:-1]}:\n  {s}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def write(self, filename: str, params: ParamsList,
              binary: bool = True) -> None:
        kio.check_output_path(filename, "model file")
        with open(filename, "wb") as f:
            self.write_stream(f, params, binary)

    def write_stream(self, stream, params: ParamsList,
                     binary: bool = True) -> None:
        out = kio.KaldiOutput(stream, binary=binary)
        kio.write_token(out, "<Nnet>")
        if not binary:
            stream.write(b"\n")
        for c, p in zip(self.components, params):
            kio.write_token(out, c.token)
            kio.write_int32(out, c.output_dim)
            kio.write_int32(out, c.input_dim)
            c.write_data(out, p)
            if not binary:
                stream.write(b"\n")
        kio.write_token(out, "</Nnet>")
        if not binary:
            stream.write(b"\n")

    @classmethod
    def read(cls, filename: str,
             device=None) -> tuple["Nnet", ParamsList]:
        with open(filename, "rb") as f:
            return cls.read_stream(io.BufferedReader(
                io.FileIO(f.fileno(), closefd=False)), device)

    @classmethod
    def read_stream(cls, stream,
                    device=None) -> tuple["Nnet", ParamsList]:
        inp = kio.KaldiInput(stream)
        tok = kio.read_token(inp)
        if tok != "<Nnet>":
            raise ValueError(f"Nnet.read: expected <Nnet>, got {tok!r}")
        nnet = cls()
        params = []
        while True:
            tok = kio.read_token(inp)
            if tok == "</Nnet>":
                break
            if tok == "<!EndOfComponent>":
                continue
            out_dim = kio.read_int32(inp)
            in_dim = kio.read_int32(inp)
            c = comp.component_from_token(tok, in_dim, out_dim)
            params.append(c.read_data(inp, device))
            nnet.append(c)
        return nnet, tuple(params)

    # ------------------------------------------------------------------
    # proto init (nnet-initialize equivalent)
    # ------------------------------------------------------------------
    @classmethod
    def init_from_proto(cls, proto_text: str, generator: torch.Generator,
                        device=None) -> tuple["Nnet", ParamsList]:
        """Parse an `<NnetProto>` topology description, e.g.

            <NnetProto>
            <Transmit> <InputDim> 40 <OutputDim> 40
            <LstmProjectedStreams> <InputDim> 40 <OutputDim> 512 \
                <CellDim> 800 <ParamScale> 0.01 <NumStream> 4
            ...
            </NnetProto>

        Parameters are drawn from ``generator`` in component order, so
        one seed gives one model (not the JAX package's model: its
        random streams differ).
        """
        nnet = cls()
        params = []
        for line in proto_text.splitlines():
            line = line.strip()
            if not line or line in ("<NnetProto>", "</NnetProto>"):
                continue
            toks = line.split()
            opts: dict[str, str] = {}
            i = 1
            while i < len(toks):
                if toks[i].startswith("<") and i + 1 < len(toks):
                    opts[toks[i]] = toks[i + 1]
                    i += 2
                else:
                    i += 1
            in_dim = int(opts.pop("<InputDim>"))
            out_dim = int(opts.pop("<OutputDim>"))
            c = comp.component_from_token(toks[0], in_dim, out_dim)
            params.append(c.init_from_config(opts, generator, device))
            nnet.append(c)
        return nnet, tuple(params)

    # ------------------------------------------------------------------
    # model surgery helpers
    # ------------------------------------------------------------------
    def to_standard(self) -> "Nnet":
        """Convert a multi-stream net (Transmit + LstmProjectedStreams) to
        the standard decode form (TimeShift + LstmProjected). Parameters
        are unchanged (same layout)."""
        out = Nnet()
        for c in self.components:
            if isinstance(c, comp.Transmit):
                out.append(comp.TimeShift(c.input_dim, c.output_dim))
            elif isinstance(c, comp.LstmProjectedStreams):
                lp = comp.LstmProjected(c.input_dim, c.output_dim,
                                        cell_dim=c.cell_dim,
                                        param_scale=c.param_scale)
                lp.dropout_rate = c.dropout_rate
                out.append(lp)
            else:
                out.append(c)
        return out

    def to_streams(self) -> "Nnet":
        """Inverse of `to_standard`: TimeShift -> Transmit and
        LstmProjected -> LstmProjectedStreams so state carries across
        chunks. Parameters are unchanged."""
        out = Nnet()
        for c in self.components:
            if isinstance(c, comp.TimeShift):
                out.append(comp.Transmit(c.input_dim, c.output_dim))
            elif isinstance(c, comp.LstmProjected):
                ls = comp.LstmProjectedStreams(
                    c.input_dim, c.output_dim, cell_dim=c.cell_dim,
                    param_scale=c.param_scale)
                ls.dropout_rate = c.dropout_rate
                out.append(ls)
            else:
                out.append(c)
        return out
