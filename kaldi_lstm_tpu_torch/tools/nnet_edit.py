"""Model surgery — insert, remove, freeze or set dropout on components;
PyTorch edition of ``kaldi_lstm_tpu.tools.nnet_edit`` with the same
flags, messages and exit codes. The layer-stacking recipe uses it to put
a fresh LSTMP layer and senone affine above a trained trunk:

    # insert a freshly initialized component before index 2
    python -m kaldi_lstm_tpu_torch.tools.nnet_edit nnet.in nnet.out \\
        --insert-at 2 --proto-line "<LstmProjectedStreams> <InputDim> 512 \\
        <OutputDim> 512 <CellDim> 800 <NumStream> 4 <ParamScale> 0.01"

    # remove component 0
    python -m kaldi_lstm_tpu_torch.tools.nnet_edit nnet.in nnet.out \\
        --remove-at 0

Inserted components draw their parameters from a CPU
``torch.Generator`` seeded with ``--seed``, so their weights differ from
the JAX tool's; every other byte of the output model is the same. A host
tool: the model is read into CPU memory.
"""

from __future__ import annotations

import argparse
import sys

import torch

from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.utils import LOG


def _index(spec: str, flag: str, n: int, convert) -> tuple | str:
    """(index, value) from an IDX=VALUE spec, or the error message. A
    typo'd index must not wrap onto another layer (a coef edit is
    invisible in the net summary); negative indexing stays supported."""
    idx_s, _, val_s = spec.partition("=")
    want = "IDX=COEF" if flag == "--set-learn-rate-coef" else "IDX=RATE"
    try:
        idx, val = int(idx_s), convert(val_s)
    except ValueError:
        return f"error: bad {flag} {spec!r} (want {want})"
    if not -n <= idx < n:
        return (f"error: {flag} index {idx} out of range for {n} "
                f"components")
    return idx, val


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Edit an Nnet: insert or "
                                "remove components (model surgery)")
    p.add_argument("model_in")
    p.add_argument("model_out")
    p.add_argument("--binary", default="true")
    p.add_argument("--insert-at", type=int, default=None,
                   help="Component index to insert --proto-line before "
                        "(negative counts from the end)")
    p.add_argument("--proto-line", default="",
                   help="One <NnetProto>-style component line to insert")
    p.add_argument("--remove-at", type=int, default=None)
    p.add_argument("--set-learn-rate-coef", action="append", default=[],
                   metavar="IDX=COEF",
                   help="Set a component's <LearnRateCoef> (repeatable; "
                        "0 freezes the layer — e.g. freeze the "
                        "pretrained trunk while a newly stacked layer "
                        "trains). Applied after insert/remove, so "
                        "indices refer to the FINAL component list.")
    p.add_argument("--set-dropout", action="append", default=[],
                   metavar="IDX=RATE",
                   help="Set a component's <DropoutRate> (repeatable; "
                        "gate dropout on the LSTM components — training "
                        "regularization; inference is unaffected). "
                        "Applied after insert/remove like "
                        "--set-learn-rate-coef.")
    p.add_argument("--seed", type=int, default=777)
    args = p.parse_args(argv)

    nnet, params = Nnet.read(args.model_in)
    params = list(params)

    if args.remove_at is not None:
        idx = args.remove_at % len(nnet.components)
        c = nnet.components.pop(idx)
        params.pop(idx)
        LOG(f"removed component {idx} ({c.token})")

    if args.insert_at is not None:
        if not args.proto_line:
            print("error: --insert-at requires --proto-line",
                  file=sys.stderr)
            return 1
        sub, sub_params = Nnet.init_from_proto(
            args.proto_line, torch.Generator().manual_seed(args.seed))
        idx = args.insert_at % (len(nnet.components) + 1) \
            if args.insert_at >= 0 else \
            len(nnet.components) + 1 + args.insert_at
        for j, (c, pp) in enumerate(zip(sub.components, sub_params)):
            nnet.components.insert(idx + j, c)
            params.insert(idx + j, pp)
            LOG(f"inserted {c.token} at {idx + j}")

    n = len(nnet.components)
    for spec in args.set_learn_rate_coef:
        got = _index(spec, "--set-learn-rate-coef", n, float)
        if isinstance(got, str):
            print(got, file=sys.stderr)
            return 1
        idx, coef = got
        c = nnet.components[idx % n]
        if not getattr(c, "updatable", False):
            print(f"error: component {idx} ({c.token}) is not updatable",
                  file=sys.stderr)
            return 1
        c.learn_rate_coef = coef
        if hasattr(c, "bias_learn_rate_coef"):
            c.bias_learn_rate_coef = coef
        LOG(f"set {c.token} at {idx % n} LearnRateCoef {coef:g}")

    for spec in args.set_dropout:
        got = _index(spec, "--set-dropout", n, float)
        if isinstance(got, str):
            print(got, file=sys.stderr)
            return 1
        idx, rate = got
        c = nnet.components[idx % n]
        if not hasattr(c, "dropout_rate"):
            print(f"error: component {idx} ({c.token}) has no "
                  f"dropout", file=sys.stderr)
            return 1
        if not 0.0 <= rate < 1.0:
            print(f"error: --set-dropout rate {rate} outside [0, 1)",
                  file=sys.stderr)
            return 1
        c.dropout_rate = rate
        LOG(f"set {c.token} at {idx % n} DropoutRate {rate:g}")

    # dimension sanity
    for a, b in zip(nnet.components, nnet.components[1:]):
        if a.output_dim != b.input_dim:
            print(f"warning: dim mismatch {a.token}({a.output_dim}) -> "
                  f"{b.token}({b.input_dim})", file=sys.stderr)

    nnet.write(args.model_out, tuple(params),
               binary=str(args.binary).lower() in ("true", "1", "yes"))
    LOG(f"Written model to {args.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
