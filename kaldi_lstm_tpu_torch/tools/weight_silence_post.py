"""Down-weight silence frames in transition-id posteriors — upstream
bin/weight-silence-post, the standard step between ali-to-post and
discriminative / weighted training (the reference's recipe pipes
alignment posteriors straight into the trainer,
train_lstm_streams.sh:36; upstream recipes insert this tool to zero or
shrink silence supervision).

    python -m kaldi_lstm_tpu_torch.tools.weight_silence_post 0.0 1:2:3 \\
        final.mdl ark:post_in.ark ark:post_out.ark

Posterior entries whose transition-id maps to a listed silence phone
are scaled by <silence-weight>; entries scaled to zero are removed
(upstream semantics). With --distribute=true the weight reduction is
instead renormalized over the frame's remaining entries.

This package's copy of ``kaldi_lstm_tpu.tools.weight_silence_post``:
host code on the port's io/kaldi_io.py, the same arguments, log lines
and output bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    PosteriorWriter,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_posterior,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.utils import LOG
from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import _bool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Apply weight to silence phones in posteriors")
    p.add_argument("silence_weight", type=float)
    p.add_argument("silence_phones",
                   help="colon-separated phone ids")
    p.add_argument("model")
    p.add_argument("post_rspecifier")
    p.add_argument("post_wspecifier")
    p.add_argument("--distribute", default="false",
                   help="renormalize each frame instead of just scaling")
    args = p.parse_args(argv)
    sil = frozenset(int(x) for x in args.silence_phones.split(":") if x)
    distribute = _bool(args.distribute)
    w_sil = args.silence_weight

    tm = TransitionModel.load(args.model)
    kind, stream = _open_rspecifier(args.post_rspecifier)
    if kind != "ark":
        print("weight_silence_post: only ark: input supported",
              file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)

    n = 0
    with PosteriorWriter(args.post_wspecifier) as w:
        while True:
            key = _read_key(buffered)
            if key is None:
                break
            post = read_posterior(_read_value_header(buffered))
            out = []
            for frame in post:
                before = sum(wt for _t, wt in frame)
                nf = []
                for tid, wt in frame:
                    if int(tm.id2phone[tid]) in sil:
                        wt *= w_sil
                    if wt != 0.0:
                        nf.append((tid, wt))
                if distribute and nf:
                    after = sum(wt for _t, wt in nf)
                    if after > 0:
                        nf = [(t, wt * before / after) for t, wt in nf]
                out.append(nf)
            w.write(key, out)
            n += 1
    LOG(f"Done {n} posteriors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
