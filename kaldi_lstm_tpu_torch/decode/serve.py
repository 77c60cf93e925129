"""Sticky-session serving: ragged chunk arrival over one batched scorer,
with endpointing; this package's copy of ``kaldi_lstm_tpu.decode.serve``.

`OnlineBatchScorer` advances all N sessions in lock-step ticks. Serving
traffic is ragged: sessions start and end at any time, chunks arrive at
different rates and sizes, and an utterance should be finalized as soon
as trailing silence says it is over. This module is that serving layer:

* **Slots** — the card runs a fixed [N_slots, chunk, D] tick. A session
  BINDS to a free slot on arrival and RELEASES it when finalized; excess
  sessions queue. A bound slot with no pending audio this tick feeds
  length 0: its LSTM state is frozen by the per-frame advance mask (K5's
  masked entry point on the card, `lstm_scan(advance_mask=...)` on the
  CPU), not advanced through padding. One K5 launch per tick with any
  frame.
* **Endpointing** — per-session trailing-silence detection over the
  scored frames (argmax pdf in a configured silence set; Kaldi's rule
  "silence >= K frames after speech"), plus an optional hard utterance
  length cap. On an endpoint the session is finalized, its slot released
  and given to the next waiting session within the same tick.
* **Results** — equal to offline decoding of the same audio when
  endpointing is off: OnlineDecoder.finalize() equals decode_faster on
  the rows fed, and chunked carried-state scoring equals
  whole-utterance scoring up to the summation order of the batch shape.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kaldi_lstm_tpu_torch.decode.faster import DecodeResult
from kaldi_lstm_tpu_torch.decode.graph import DecodingGraph
from kaldi_lstm_tpu_torch.decode.online import (
    OnlineBatchScorer,
    OnlineDecoder,
    _ShiftBuffer,
)
from kaldi_lstm_tpu_torch.models import Nnet


@dataclass
class EndpointConfig:
    """Trailing-silence endpointing (simplified Kaldi rule set).

    An utterance is endpointed when BOTH hold on the decoded frames so
    far: at least `min_speech_frames` were speech (argmax pdf outside
    `silence_pdfs`), and the last `trailing_silence_frames` were all
    silence. Independently, `max_utterance_frames` > 0 force-endpoints
    overlong utterances (rule 5 analogue)."""

    silence_pdfs: frozenset
    trailing_silence_frames: int = 30
    min_speech_frames: int = 3
    max_utterance_frames: int = 0

    def __post_init__(self):
        self.silence_pdfs = frozenset(int(p) for p in self.silence_pdfs)


@dataclass
class _Session:
    sid: str
    decoder: OnlineDecoder
    shift: _ShiftBuffer
    pending: deque = field(default_factory=deque)  # scorable frames
    eos: bool = False
    slot: int = -1
    # endpoint counters
    n_speech: int = 0
    n_trailing_sil: int = 0
    n_frames: int = 0


@dataclass
class ServeResult:
    sid: str
    result: DecodeResult
    n_frames: int
    endpointed: bool


class StickySessionServer:
    """Slot-bound batched serving with heterogeneous arrival (see
    module docstring).

    Drive it with `submit(sid, frames)` / `end_stream(sid)` from the
    I/O side and `tick()` from the serving loop; finished utterances
    appear in `results`. `tick()` returns the number of audio frames
    scored (0 = idle tick, nothing pending). The scorer runs on `device`
    (default: the device of `params`)."""

    def __init__(self, nnet: Nnet, params, graph: DecodingGraph,
                 n_slots: int, *, chunk_frames: int = 20,
                 transf: Optional[Nnet] = None, transf_params=None,
                 log_prior: Optional[np.ndarray] = None,
                 acoustic_scale: float = 0.1, beam: float = 16.0,
                 max_active: int = 0, targets_delay: int = 0,
                 endpoint: Optional[EndpointConfig] = None,
                 top_p: int = 0, fetch_dtype=None, device=None):
        self.scorer = OnlineBatchScorer(
            nnet, params, n_slots, transf=transf,
            transf_params=transf_params, log_prior=log_prior,
            top_p=top_p, fetch_dtype=fetch_dtype, device=device)
        self.graph = graph
        self.n_slots = int(n_slots)
        self.chunk = int(chunk_frames)
        self.feat_dim = nnet.input_dim
        self.acoustic_scale = acoustic_scale
        self.beam = beam
        self.max_active = max_active
        self.delay = int(targets_delay)
        self.endpoint = endpoint
        self.slots: list[Optional[_Session]] = [None] * self.n_slots
        self.waiting: deque[_Session] = deque()
        self.sessions: "OrderedDict[str, _Session]" = OrderedDict()
        # finalized sids (late audio is dropped), bounded: a long-running
        # server finalizes millions of sessions, so only the most recent
        # 65536 are kept (late audio for an older one starts a new
        # session)
        self.closed: "OrderedDict[str, None]" = OrderedDict()
        self.max_closed = 65536
        self.results: list[ServeResult] = []
        # occupancy accounting for the serving report
        self.ticks = 0
        self.bound_slot_ticks = 0

    # -- I/O side ------------------------------------------------------
    def submit(self, sid: str, frames: np.ndarray) -> None:
        """Append audio frames [t, D] to a session (created on first
        submit and bound to a slot as one frees up)."""
        if sid in self.closed:
            return  # audio after finalization is dropped (session over)
        s = self.sessions.get(sid)
        if s is None:
            s = _Session(
                sid=sid,
                decoder=OnlineDecoder(self.graph, self.acoustic_scale,
                                      self.beam, self.max_active),
                shift=_ShiftBuffer(self.delay))
            self.sessions[sid] = s
            self._try_bind(s)
        out = s.shift.push(np.asarray(frames, np.float32))
        if len(out):
            s.pending.append(out)

    def end_stream(self, sid: str) -> None:
        """No more audio for this session; it finalizes once its buffer
        drains (or immediately if already empty). Unknown/closed sids
        return gracefully (submit on an unknown sid creates it; a
        reordered or dropped first chunk must not crash the loop)."""
        if sid in self.closed:
            return
        s = self.sessions.get(sid)
        if s is None or s.eos:
            return
        s.eos = True
        tail = s.shift.flush()
        if len(tail):
            s.pending.append(tail)

    def partial(self, sid: str) -> DecodeResult:
        return self.sessions[sid].decoder.partial()

    # -- slot management ----------------------------------------------
    def _try_bind(self, s: _Session) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None:
                self.slots[i] = s
                s.slot = i
                self.scorer.reset([i])
                return
        self.waiting.append(s)

    def _finalize(self, s: _Session, endpointed: bool) -> None:
        self.results.append(ServeResult(
            sid=s.sid, result=s.decoder.finalize(),
            n_frames=s.n_frames, endpointed=endpointed))
        self.closed[s.sid] = None
        while len(self.closed) > self.max_closed:
            self.closed.popitem(last=False)
        i = s.slot
        self.slots[i] = None
        s.slot = -1
        del self.sessions[s.sid]
        if self.waiting:
            nxt = self.waiting.popleft()
            self.slots[i] = nxt
            nxt.slot = i
            self.scorer.reset([i])

    # -- serving loop --------------------------------------------------
    def _take(self, s: _Session, n: int) -> np.ndarray:
        out = []
        got = 0
        while s.pending and got < n:
            blk = s.pending[0]
            take = min(len(blk), n - got)
            out.append(blk[:take])
            got += take
            if take == len(blk):
                s.pending.popleft()
            else:
                s.pending[0] = blk[take:]
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, self.feat_dim), np.float32))

    def _check_endpoint(self, s: _Session, rows: np.ndarray) -> bool:
        ep = self.endpoint
        if ep is None:
            return False
        sil = np.fromiter(
            (int(p) in ep.silence_pdfs for p in rows.argmax(axis=-1)),
            dtype=bool, count=len(rows))
        for is_sil in sil:
            if is_sil:
                s.n_trailing_sil += 1
            else:
                s.n_speech += 1
                s.n_trailing_sil = 0
        if (s.n_speech >= ep.min_speech_frames
                and s.n_trailing_sil >= ep.trailing_silence_frames):
            return True
        return bool(ep.max_utterance_frames
                    and s.n_frames >= ep.max_utterance_frames)

    def tick(self) -> int:
        """One serving step: gather <= chunk_frames per bound slot,
        ONE batched device dispatch with per-slot lengths, feed each
        session's incremental decoder, endpoint/finalize, rebind freed
        slots. Returns total frames scored."""
        self.ticks += 1
        self.bound_slot_ticks += sum(sl is not None for sl in self.slots)
        x = np.zeros((self.n_slots, self.chunk, self.feat_dim),
                     np.float32)
        lengths = np.zeros(self.n_slots, np.int64)
        chunks: list[Optional[np.ndarray]] = [None] * self.n_slots
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            blk = self._take(s, self.chunk)
            chunks[i] = blk
            lengths[i] = len(blk)
            x[i, :len(blk)] = blk
        total = int(lengths.sum())
        if total:
            y = self.scorer.score(x, lengths=lengths)
        # drain finalizable sessions even on an idle tick (eos with an
        # empty buffer, e.g. end_stream right after the last tick)
        for i in range(self.n_slots):
            s = self.slots[i]
            if s is None:
                continue
            rows = None
            if chunks[i] is not None and len(chunks[i]):
                rows = y[i, :lengths[i]]
                s.decoder.advance(rows)
                s.n_frames += int(lengths[i])
            hit = rows is not None and self._check_endpoint(s, rows)
            if hit:
                self._finalize(s, endpointed=True)
            elif s.eos and not s.pending:
                self._finalize(s, endpointed=False)
        return total

    def drain(self, max_ticks: int = 1_000_000) -> None:
        """Tick until no session holds pending audio or an unfinalized
        eos (the offline-replay shape used by tests/benches)."""
        for _ in range(max_ticks):
            busy = any(
                s is not None and (s.pending or s.eos)
                for s in self.slots) or self.waiting
            if not busy:
                return
            self.tick()

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots bound over all ticks so far."""
        return (self.bound_slot_ticks / (self.ticks * self.n_slots)
                if self.ticks else 0.0)
