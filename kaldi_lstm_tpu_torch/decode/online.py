"""Online (streaming) recognition: chunk-by-chunk AM scoring with carried
LSTM state and an incremental Viterbi search; this package's copy of
``kaldi_lstm_tpu.decode.online``.

* `OnlineDecoder` — the incremental `decode_faster`: takes scaled
  log-likelihood chunks as they arrive, keeps the search state in the
  native core's stream session (``klt_stream_*`` of csrc/kltdecode.cc)
  and the dense per-frame backpointer rows on the host, and gives a
  partial hypothesis at any frame. `finalize()` equals the offline
  decoder on the same rows, words and score.
* `OnlineRecognizer` — one stream through the stateful net
  (LstmProjectedStreams, carried state; an `OnlineBatchScorer` of one
  session), its target delay applied as lookahead buffering
  (`_ShiftBuffer`, the TimeShift end clamp).
* `OnlineBatchScorer` — N carried-state sessions scored in one device
  dispatch per tick: on the card one K5 launch per tick (its masked
  entry point when the tick is ragged, ``lengths``), the affine, the
  log-softmax and the prior, then the scores to the host on a side
  stream into fresh pinned memory, as `decode.scoring.AmScorer` does.

No silent fallback: when the native core cannot be built or loaded,
`OnlineDecoder` raises; only ``KLT_DECODE_IMPL=python`` runs the numpy
search (the cross-check).

The backpointers are dense, [ns] int32 a frame for the whole utterance
(as in the reference): at 1.5M graph states that is 6 MB a frame, so a
session's host memory grows with frames x states. Size the graph for
the number of live sessions.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.decode.faster import (
    NEG,
    DecodeResult,
    _eps_closure,
    _frame_step,
    _traceback,
    compile_graph,
)
from kaldi_lstm_tpu_torch.decode.graph import DecodingGraph
from kaldi_lstm_tpu_torch.decode.scoring import (
    fetch_block,
    queue_host_copy,
)
from kaldi_lstm_tpu_torch.io.native import NativeStreamSession
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import (
    BLstmProjectedStreams,
    Softmax,
    TimeShift,
)
from kaldi_lstm_tpu_torch.utils.tree import params_device


def strip_leading_timeshift(nnet: Nnet, params, targets_delay: int
                            ) -> tuple[Nnet, tuple, int]:
    """Pop a leading TimeShift component for streaming use: its shift
    becomes the lookahead delay when `targets_delay` < 0, since
    streaming applies the delay as per-session buffering (_ShiftBuffer).
    Shared by the serving CLIs."""
    comps, plist = list(nnet.components), list(params)
    delay = targets_delay
    if comps and isinstance(comps[0], TimeShift):
        if delay < 0:
            delay = comps[0].shift
        comps.pop(0)
        plist.pop(0)
    return Nnet(comps), tuple(plist), max(delay, 0)


class OnlineDecoder:
    """Incremental Viterbi beam search. Feed [t, num_pdfs] log-likelihood
    chunks through `advance`; `partial()` gives the current best
    hypothesis (ignoring final weights, like upstream
    GetBestPath(use_final_probs=false)); `finalize()` equals
    decode_faster on the rows fed."""

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 beam: float = 16.0, max_active: int = 0):
        self.cg = compile_graph(graph)
        self.acoustic_scale = acoustic_scale
        self.beam = beam
        self.max_active = max_active
        cg = self.cg
        self._native = None
        if os.environ.get("KLT_DECODE_IMPL", "auto") != "python":
            # raises when the core cannot be built or loaded
            self._native = NativeStreamSession(
                cg.ns, cg.em_ptr, cg.em_dst, cg.em_pdf, cg.em_w,
                cg.eps_ptr, cg.eps_dst, cg.eps_w, beam, max_active,
                cg.start)
            self.alpha = None  # read from the session on demand
            self.bps = [self._native.bp0]
        else:
            self.alpha = np.full(cg.ns, NEG)
            self.alpha[cg.start] = 0.0
            bp0 = np.full(cg.ns, -1, np.int32)
            _eps_closure(cg, self.alpha, bp0, np.asarray([cg.start]))
            self.active = np.nonzero(self.alpha > NEG / 2)[0]
            self.bps = [bp0]
        self.num_frames = 0

    def advance(self, loglik: np.ndarray) -> None:
        em = self.acoustic_scale * np.asarray(loglik, np.float64)
        if self._native is not None:
            if len(em) == 0:
                return
            self.bps.extend(self._native.advance(em))
            self.num_frames += len(em)
            return
        for row in em:
            bp = np.full(self.cg.ns, -1, np.int32)
            self.alpha, self.active = _frame_step(
                self.cg, self.alpha, self.active, row, self.beam,
                self.max_active, bp, self.num_frames)
            self.bps.append(bp)
            self.num_frames += 1

    def _alpha(self) -> np.ndarray:
        return (self._native.alpha() if self._native is not None
                else self.alpha)

    def partial(self) -> DecodeResult:
        alpha = self._alpha()
        state = int(np.argmax(alpha))
        return DecodeResult(
            words=_traceback(self.cg, self.bps, state, self.num_frames),
            score=float(alpha[state]), reached_final=False)

    def finalize(self) -> DecodeResult:
        alpha = self._alpha()
        total = alpha + self.cg.final
        reached = bool(total.max() > NEG / 2)
        state = int(np.argmax(total if reached else alpha))
        score = float(total[state] if reached else alpha[state])
        words = _traceback(self.cg, self.bps, state, self.num_frames)
        return DecodeResult(words=words, score=score,
                            reached_final=reached)


class _ShiftBuffer:
    """Streams the decode-time target delay: out[t] = in[t + k], the end
    frames clamped to the last input (TimeShift semantics,
    nnet-time-shift.h:42-51). `push` returns every shifted frame that
    has become available; `flush` emits the k clamped tail frames."""

    def __init__(self, k: int):
        if k < 0:
            raise ValueError("negative target delay is not supported "
                             "for online decoding")
        self.k = k
        # out[t] = in[t+k]: each push's emittable slice lies within the
        # new chunk (emitted = max(0, seen - k)), so only the input count
        # and the last frame (for the clamped tail) are kept
        self._seen = 0
        self._last: Optional[np.ndarray] = None

    def push(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        if len(frames):
            self._last = frames[-1:].copy()
        start = min(max(self.k - self._seen, 0), len(frames))
        self._seen += len(frames)
        return frames[start:]

    def flush(self) -> np.ndarray:
        if self._last is None:
            return np.zeros((0, 0), np.float32)
        tail = min(self.k, self._seen)
        return np.repeat(self._last, tail, axis=0)


class OnlineRecognizer:
    """Streaming recognizer over a stateful net, one stream.

    `nnet`/`params` may be either format: a leading TimeShift (standard
    decode nets) is stripped and its <Shift> becomes the lookahead;
    otherwise pass `targets_delay` (the trainer's --targets-delay).
    Standard-form LSTM components are converted to the streams form, so
    the state carries across chunks. `log_prior` (length num_pdfs) turns
    log-posteriors into scaled log-likelihoods as nnet_forward does
    (subtracted on the host in float64). Each chunk is one tick of an
    `OnlineBatchScorer` of one session on `device` (default: the device
    of the parameters)."""

    def __init__(self, nnet: Nnet, params, graph: DecodingGraph, *,
                 transf: Optional[Nnet] = None, transf_params=None,
                 log_prior: Optional[np.ndarray] = None,
                 acoustic_scale: float = 0.1, beam: float = 16.0,
                 max_active: int = 0,
                 targets_delay: Optional[int] = None, device=None):
        comps = list(nnet.components)
        plist = list(params)
        if any(isinstance(c, BLstmProjectedStreams) for c in comps):
            raise ValueError("bidirectional nets cannot stream (the "
                             "backward pass needs the whole utterance)")
        if targets_delay is None:
            targets_delay = 0
            if comps and isinstance(comps[0], TimeShift):
                if comps[0].shift < 0:
                    raise ValueError(
                        "online decoding: leading TimeShift has "
                        f"negative shift {comps[0].shift}")
                targets_delay = comps[0].shift
                comps.pop(0)
                plist.pop(0)
        self.scorer = OnlineBatchScorer(
            Nnet(comps), plist, 1, transf=transf,
            transf_params=transf_params, device=device)
        self.log_prior = (None if log_prior is None
                          else np.asarray(log_prior, np.float32))
        self.shift = _ShiftBuffer(targets_delay)
        self.decoder = OnlineDecoder(graph, acoustic_scale, beam,
                                     max_active)

    def _score(self, frames: np.ndarray) -> None:
        if frames.shape[0] == 0:
            return
        loglik = np.asarray(self.scorer.score(frames[None])[0], np.float64)
        if self.log_prior is not None:
            loglik = loglik - self.log_prior
        self.decoder.advance(loglik)

    def accept(self, frames: np.ndarray) -> None:
        """Feed a chunk of raw feature frames [t, feat_dim]."""
        self._score(self.shift.push(frames))

    def partial(self) -> DecodeResult:
        return self.decoder.partial()

    def finalize(self) -> DecodeResult:
        self._score(self.shift.flush())
        return self.decoder.finalize()


class OnlineBatchScorer:
    """Batched streaming AM scoring of N concurrent sessions: one device
    dispatch per chunk tick over carried-state streams (the trainer's
    multi-stream batching applied to inference); the per-session search
    stays on the host (OnlineDecoder), fed the fetched rows.

    * `score(feats [N, t, D])` -> [N, t, num_pdfs] float32 log-likelihoods
      (minus the log-prior when given): one K5 launch per tick on the
      card, then one copy of the tick's scores to the host on a side
      stream, into fresh pinned memory.
    * `lengths` [N] makes a ragged tick: session i advances through its
      first lengths[i] frames only (K5's advance mask; the rows past that
      are not scores and must be discarded). The sticky server's shape.
    * `reset(session_ids)` zeroes those sessions' carried state
      (`Nnet.reset_states`).
    * `fetch_dtype` (torch.bfloat16) halves the copied values; they come
      back as float32 holding the bf16 values.
    * `top_p` > 0 prunes the fetch on the device (torch.topk): only the
      top-P values and their int32 pdf ids are copied, and `score`
      rebuilds dense rows on the host with the per-frame floor
      `min(top values) - floor_margin` for the others.

    Pipeline mode (`pipeline=True`): `score(x)` dispatches the tick for
    `x` and returns the PREVIOUS tick's block (None on the first call;
    `flush()` drains the last), so one tick is always in flight. Each
    tick's features are copied into a private pinned buffer before
    `score` returns, so the caller may overwrite its chunk buffer at
    once. `reset(ids)` applies to the state that feeds the NEXT dispatch;
    the in-flight tick was computed with the pre-reset state and is
    returned as such: a caller rebinding a slot discards that slot's rows
    of the next returned block (online_serve_batch's order). Without the
    pipeline `reset` takes effect at once.

    The net runs on `device` (default: the device its parameters are
    on); the feature transform's parameters must be on the same device.
    """

    def __init__(self, nnet: Nnet, params, n_sessions: int, *,
                 transf: Optional[Nnet] = None, transf_params=None,
                 log_prior: Optional[np.ndarray] = None,
                 fetch_dtype=None, top_p: int = 0,
                 floor_margin: float = 10.0, pipeline: bool = False,
                 device=None):
        comps = list(nnet.components)
        if any(isinstance(c, BLstmProjectedStreams) for c in comps):
            raise ValueError("bidirectional nets cannot stream")
        if comps and isinstance(comps[0], TimeShift):
            raise ValueError("strip the TimeShift and buffer lookahead "
                             "per session (OnlineRecognizer semantics)")
        self.nnet = Nnet(comps).to_streams()
        self.params = tuple(params)
        self.device = torch.device(device) if device is not None \
            else params_device(self.params)
        self.n = int(n_sessions)
        self._softmax = bool(comps) and isinstance(comps[-1], Softmax)
        self.transf = transf
        self.transf_params = transf_params
        self._lp_dev = None if log_prior is None else torch.tensor(
            np.asarray(log_prior, np.float32), device=self.device)
        self.states = self.nnet.init_states(self.n, self.device)
        self.fetch_dtype = fetch_dtype
        self.top_p = int(top_p)
        self.floor_margin = float(floor_margin)
        self.num_pdfs = self.nnet.output_dim
        self.pipeline = bool(pipeline)
        self._inflight = None
        self._copy_stream = None

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        """A private copy of host array `a` on the device: staged through
        fresh pinned memory on CUDA (the copy to it is done when this
        returns, the upload is asynchronous)."""
        t = torch.from_numpy(np.array(a, dtype, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor, amask: Optional[torch.Tensor]):
        if self.transf is not None:
            x = self.transf.feedforward(self.transf_params, x)
        y, self.states = self.nnet.propagate(self.params, x, self.states,
                                             logits=True,
                                             advance_mask=amask)
        if self._softmax:
            y = torch.log_softmax(y, dim=-1)
        if self._lp_dev is not None:
            y = y - self._lp_dev
        if self.top_p > 0:
            vals, idx = torch.topk(y, self.top_p, dim=-1)
            if self.fetch_dtype is not None:
                vals = vals.to(self.fetch_dtype)
            return vals, idx.to(torch.int32)
        if self.fetch_dtype is not None:
            y = y.to(self.fetch_dtype)
        return y

    def _dispatch(self, feats: np.ndarray, lengths):
        """Upload a tick and queue its forward; on CUDA also queue the
        copy of its scores to the host (a PendingFetch)."""
        begin = None
        if self.device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(torch.cuda.current_stream(self.device))
        x = self._upload(feats, np.float32)
        amask = None
        if lengths is not None:
            t = feats.shape[1]
            amask = (np.arange(t)[None, :]
                     < np.asarray(lengths)[:, None])
            amask = self._upload(amask, np.uint8)
        y = self._forward(x, amask)
        if begin is None:
            return y
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return queue_host_copy(y, self._copy_stream, self.device, begin)

    def _fetch(self, y) -> np.ndarray:
        return fetch_block(y, self.top_p, self.num_pdfs, self.floor_margin)

    def score(self, feats: np.ndarray,
              lengths: Optional[np.ndarray] = None
              ) -> Optional[np.ndarray]:
        """[N, t, D] feature tick -> [N, t, num_pdfs] scaled
        log-likelihoods on the host (see the class docstring; in pipeline
        mode the previous tick's block, None on the first tick)."""
        assert feats.shape[0] == self.n
        y = self._dispatch(feats, lengths)
        if not self.pipeline:
            return self._fetch(y)
        prev, self._inflight = self._inflight, y
        return None if prev is None else self._fetch(prev)

    def flush(self) -> Optional[np.ndarray]:
        """Pipeline mode: drain the last in-flight tick's result."""
        prev, self._inflight = self._inflight, None
        return None if prev is None else self._fetch(prev)

    def reset(self, session_ids) -> None:
        """Zero the carried state of the given sessions (stream ended /
        new utterance bound to the slot)."""
        flags = np.zeros(self.n, np.int32)
        flags[np.asarray(session_ids, np.int64)] = 1
        with torch.inference_mode():
            self.states = self.nnet.reset_states(
                self.states, self._upload(flags, np.int32))
