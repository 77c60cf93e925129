"""The port's streaming recognition path against the JAX package's
(`decode/online.py`, the `online_decode` and `online_serve_batch` CLIs),
on the CPU (the plain path), and the masked K5 on the card (`gpu`).

The world: the port's `make_word_synth_data` writes a small word corpus
(6 words, 5 phones x 2 states, 8-dim frames, optional silence), the
port's `train_lstm_streams --device cpu` trains a tiny
LstmProjectedStreams AM on it for three epochs, and both packages read
that model file (each also reads the other's copy of it). Held:

* `lstm_infer(advance_mask=...)` (the wrapper's plain version) against
  the JAX masked `lstm_scan`, on the valid rows and the final state,
  within 1e-5 (float32 on both sides, the same sums in other orders);
* `OnlineDecoder` (native stream session) equal to `decode_faster` on
  the rows fed, words and score, and to the JAX `OnlineDecoder`; the
  native session equal to `KLT_DECODE_IMPL=python`, backpointers too;
* `OnlineRecognizer` and `OnlineBatchScorer` (lengths, reset, top_p, bf16
  fetch, pipeline) against the JAX ones within 1e-5, hypotheses equal;
  the pipeline's private copy of each tick's features, with a caller
  that overwrites its buffer right after `score`;
* the `online_decode` and `online_serve_batch` transcript files byte for
  byte against the JAX CLIs' and equal to the port's offline
  `nnet_forward` -> `decode_faster`;
* no fallback: a broken native build raises, the CLIs without CUDA exit 1.
"""

import os

import numpy as np
import pytest
import torch

NUM_PDFS = 10
TOL = dict(rtol=1e-5, atol=1e-5)
CLI_SEARCH = ["--acoustic-scale", "0.7", "--beam", "15"]


def _leaves(params) -> list:
    out = []
    for p in params:
        out.extend(p.values() if isinstance(p, dict) else p)
    return out


def make_world(d: str) -> dict:
    """The corpus, the port-trained AM (both packages' readings of it),
    the decoding graphs, the priors and the offline reference: the port's
    whole-utterance scores and decode_faster words."""
    from kaldi_lstm_tpu.decode.graph import build_graph_from_arpa as j_graph
    from kaldi_lstm_tpu.io.lang import SymbolTable as JSymbols
    from kaldi_lstm_tpu.io.lang import read_lexicon as j_lex
    from kaldi_lstm_tpu.io.transition_model import \
        TransitionModel as JTransitionModel
    from kaldi_lstm_tpu.models import Nnet as JNnet
    from kaldi_lstm_tpu_torch.decode.faster import decode_faster
    from kaldi_lstm_tpu_torch.decode.graph import build_graph_from_arpa
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        log_priors_from_counts,
    )
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.lang import SymbolTable, read_lexicon
    from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools.make_word_synth_data import main as mk
    from kaldi_lstm_tpu_torch.tools.train_lstm_streams import main as train

    assert mk(["--dir", d, "--num-words", "6", "--num-phones", "5",
               "--states-per-phone", "2", "--feat-dim", "8",
               "--num-utts", "24", "--min-pron", "2", "--max-pron", "3",
               "--max-words", "5", "--sil-prob", "0.4",
               "--emission-noise", "0.4"]) == 0
    tm = TransitionModel.load(f"{d}/final.mdl")
    counts = np.ones(tm.num_pdfs)
    with kio.PosteriorWriter(f"ark:{d}/post.ark") as pw:
        for key, ali in kio.SequentialIntVectorReader(f"ark:{d}/ali.ark"):
            pdf = tm.transition_ids_to_pdfs(ali)
            counts += np.bincount(pdf, minlength=tm.num_pdfs)
            pw.write(key, [[(int(p), 1.0)] for p in pdf])
    with open(f"{d}/counts.vec", "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts.astype(np.float32))
    proto = f"""<NnetProto>
<LstmProjectedStreams> <InputDim> 8 <OutputDim> 12 <CellDim> 16 <ParamScale> 0.08 <NumStream> 8
<AffineTransform> <InputDim> 12 <OutputDim> {NUM_PDFS} <ParamStddev> 0.1
<Softmax> <InputDim> {NUM_PDFS} <OutputDim> {NUM_PDFS}
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(0), "cpu")
    nnet.write(f"{d}/nnet.iter0", params, binary=True)
    for i in range(3):
        assert train([f"scp:{d}/feats.scp", f"ark:{d}/post.ark",
                      f"{d}/nnet.iter{i}", f"{d}/nnet.iter{i + 1}",
                      "--learn-rate=5e-3", "--num-stream=8",
                      "--targets-delay=0", "--device", "cpu"]) == 0
    os.replace(f"{d}/nnet.iter3", f"{d}/final.nnet")
    # each package reads the other's copy of the model
    jn, jp = JNnet.read(f"{d}/final.nnet")
    jn.write(f"{d}/final_jax.nnet", jp, binary=True)
    nnet, params = Nnet.read(f"{d}/final.nnet", "cpu")
    _, back = Nnet.read(f"{d}/final_jax.nnet", "cpu")
    assert _leaves(back) and all(
        torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(params)))
    assert all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(_leaves(jp), _leaves(params)))

    words = SymbolTable.load(f"{d}/words.txt")
    graph = build_graph_from_arpa(tm, read_lexicon(f"{d}/lexicon.txt"),
                                  f"{d}/lm.arpa", words=words)
    jgraph = j_graph(JTransitionModel.load(f"{d}/final.mdl"),
                     j_lex(f"{d}/lexicon.txt"), f"{d}/lm.arpa",
                     words=JSymbols.load(f"{d}/words.txt"))
    log_prior = log_priors_from_counts(counts)
    feats = dict(kio.SequentialMatrixReader(f"scp:{d}/feats.scp"))
    scorer = AmScorer(nnet, params, log_prior=log_prior, apply_log=True,
                      device="cpu")
    loglik = dict(scorer.score_stream(feats.items()))
    offline = {k: decode_faster(graph, y, 1.0, 18.0, 0)
               for k, y in loglik.items()}
    return dict(d=d, nnet=nnet, params=params, jnnet=jn, jparams=jp,
                graph=graph, jgraph=jgraph, log_prior=log_prior,
                feats=feats, keys=list(feats), loglik=loglik,
                offline=offline,
                # phone 1 is silence: its two states are pdfs 0 and 1
                sil_pdfs=frozenset({0, 1}), decode_faster=decode_faster)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(str(tmp_path_factory.mktemp("online_port")))


def _chunks(arr, rng):
    t = 0
    while t < len(arr):
        n = int(rng.randint(1, 9))
        yield arr[t:t + n]
        t += n


# ---------------------------------------------------------------------------
# the masked scan (K5's plain version) against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("time_major", [False, True])
def test_masked_lstm_infer_matches_jax(time_major):
    """`lstm_infer(advance_mask=...)` on the CPU (its plain version, one
    plain call) against the JAX masked `lstm_scan`: lengths 0, T and in
    between, and one stream masked at a middle frame only."""
    import jax.numpy as jnp
    from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JP
    from kaldi_lstm_tpu.ops.lstm_cell import LstmState as JS
    from kaldi_lstm_tpu.ops.lstm_cell import lstm_scan as j_scan
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params
    S, T, I, C, R = 5, 9, 7, 11, 6
    p = init_lstm_params(torch.Generator().manual_seed(3), I, C, R, 0.3)
    rng = np.random.RandomState(4)
    x = rng.randn(S, T, I).astype(np.float32)
    c0 = rng.randn(S, C).astype(np.float32)
    r0 = rng.randn(S, R).astype(np.float32)
    lengths = np.array([0, T, 3, 7, T])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    mask[4, T // 2] = 0.0
    xt, mt = x, mask
    if time_major:
        xt, mt = x.transpose(1, 0, 2).copy(), mask.T.copy()
    li.reset_counts()
    out, fin = li.lstm_infer(p, torch.from_numpy(xt),
                             LstmState(torch.from_numpy(c0),
                                       torch.from_numpy(r0)),
                             50.0, time_major=time_major,
                             advance_mask=torch.from_numpy(mt))
    assert (li.LAUNCHES, li.MASKED_LAUNCHES, li.PLAIN_CALLS) == (0, 0, 1)
    jp = JP(*(jnp.asarray(t.numpy()) for t in p))
    jout, jfin = j_scan(jp, jnp.asarray(xt), JS(jnp.asarray(c0),
                                                jnp.asarray(r0)),
                        50.0, time_major=time_major,
                        advance_mask=jnp.asarray(mt))
    out, jout = out.numpy(), np.asarray(jout)
    if time_major:
        out, jout = out.transpose(1, 0, 2), jout.transpose(1, 0, 2)
    valid = mask.astype(bool)
    np.testing.assert_allclose(out[valid], jout[valid], **TOL)
    np.testing.assert_allclose(fin.c.numpy(), np.asarray(jfin.c), **TOL)
    np.testing.assert_allclose(fin.r.numpy(), np.asarray(jfin.r), **TOL)
    # a stream of length 0 keeps its state exactly
    np.testing.assert_array_equal(fin.c.numpy()[0], c0[0])
    np.testing.assert_array_equal(fin.r.numpy()[0], r0[0])


def test_masked_training_call_runs_the_scan_on_the_cpu():
    """A masked call that needs a gradient takes the differentiable scan
    on the CPU, routed by the component (the card raises, see the gpu
    test); ``lstm_infer`` itself rejects it on any device."""
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, lstm_scan
    proto = """<NnetProto>
<LstmProjectedStreams> <InputDim> 4 <OutputDim> 3 <CellDim> 5 <NumStream> 2
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(proto,
                                        torch.Generator().manual_seed(1))
    p = params[0]
    x = torch.randn(2, 4, 4, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    st = LstmState(torch.zeros(2, 5), torch.zeros(2, 3))
    mask = torch.tensor([[1.0, 1, 0, 0], [1, 1, 1, 1]])
    li.reset_counts()
    out, _ = nnet.propagate(params, x, (st,), advance_mask=mask)
    ref, _ = lstm_scan(p, x, st, advance_mask=mask)
    assert out.requires_grad and torch.equal(out, ref)
    assert li.PLAIN_CALLS == 0   # the component's scan, not lstm_infer
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with pytest.raises(NotImplementedError, match="gradient"):
        li.lstm_infer(p, x, st, advance_mask=mask)


# ---------------------------------------------------------------------------
# the incremental decoder and the native stream session
# ---------------------------------------------------------------------------

def test_online_decoder_matches_offline_and_jax(world):
    """Chunked feeding of each utterance's offline rows: words, score
    and reached_final equal `decode_faster` and the JAX OnlineDecoder;
    partial() at every chunk equals the JAX one."""
    from kaldi_lstm_tpu.decode.online import OnlineDecoder as JDecoder
    from kaldi_lstm_tpu_torch.decode.online import OnlineDecoder
    w = world
    rng = np.random.RandomState(5)
    for key in w["keys"][:6]:
        ll = w["loglik"][key]
        dec = OnlineDecoder(w["graph"], 1.0, beam=18.0, max_active=40)
        jdec = JDecoder(w["jgraph"], 1.0, beam=18.0, max_active=40)
        for chunk in _chunks(ll, rng):
            dec.advance(chunk)
            jdec.advance(chunk)
            part, jpart = dec.partial(), jdec.partial()
            assert part.words == jpart.words
            assert part.score == jpart.score
        res, jres = dec.finalize(), jdec.finalize()
        ref = w["decode_faster"](w["graph"], ll, 1.0, 18.0, 40)
        assert res.words == ref.words == jres.words
        assert res.score == ref.score == jres.score
        assert res.reached_final == ref.reached_final


def test_native_stream_session_matches_python(world, monkeypatch):
    """The native stream session (klt_stream_*) equals the numpy
    OnlineDecoder (`KLT_DECODE_IMPL=python`) across chunked feeding:
    partials, the result and every backpointer row."""
    from kaldi_lstm_tpu_torch.decode.online import OnlineDecoder
    w = world
    ll = np.concatenate([w["loglik"][k] for k in w["keys"][:2]])
    monkeypatch.delenv("KLT_DECODE_IMPL", raising=False)
    nat = OnlineDecoder(w["graph"], acoustic_scale=0.3, beam=14.0,
                        max_active=30)
    assert nat._native is not None
    monkeypatch.setenv("KLT_DECODE_IMPL", "python")
    py = OnlineDecoder(w["graph"], acoustic_scale=0.3, beam=14.0,
                       max_active=30)
    assert py._native is None
    rng = np.random.RandomState(6)
    for chunk in _chunks(ll, rng):
        nat.advance(chunk)
        py.advance(chunk)
        pn, pp = nat.partial(), py.partial()
        assert pn.words == pp.words
        np.testing.assert_allclose(pn.score, pp.score, rtol=1e-12)
    rn, rp = nat.finalize(), py.finalize()
    assert rn.words == rp.words and rn.reached_final == rp.reached_final
    np.testing.assert_allclose(rn.score, rp.score, rtol=1e-12)
    assert len(nat.bps) == len(py.bps)
    for a, b in zip(nat.bps, py.bps):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_broken_native_build_raises_never_falls_back(world, monkeypatch,
                                                     tmp_path):
    """The JAX OnlineDecoder falls back to numpy when its native session
    cannot be made; the port's raises with the compiler's error."""
    import kaldi_lstm_tpu_torch.io.native as native
    from kaldi_lstm_tpu_torch.decode.online import OnlineDecoder
    src = tmp_path / "kltdecode.cc"
    with open(native.SOURCE) as f:
        src.write_text(f.read() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.delenv("KLT_DECODE_IMPL", raising=False)
    with pytest.raises(RuntimeError, match="kltdecode.cc"):
        OnlineDecoder(world["graph"], 1.0, 18.0)
    monkeypatch.setenv("KLT_DECODE_IMPL", "python")
    assert OnlineDecoder(world["graph"], 1.0, 18.0)._native is None


def test_shift_buffer_is_time_shift():
    from kaldi_lstm_tpu.decode.online import _ShiftBuffer as JShift
    from kaldi_lstm_tpu_torch.decode.online import _ShiftBuffer
    rng = np.random.RandomState(3)
    for T, k in [(17, 0), (17, 5), (6, 5), (4, 5), (30, 1)]:
        x = rng.randn(T, 4).astype(np.float32)
        buf, jbuf = _ShiftBuffer(k), JShift(k)
        outs, jouts = [], []
        for c in _chunks(x, rng):
            outs.append(buf.push(c))
            jouts.append(jbuf.push(c))
        outs.append(buf.flush())
        jouts.append(jbuf.flush())
        got = np.concatenate([o for o in outs if o.size], 0)
        src = np.clip(np.arange(T) + k, 0, T - 1)
        np.testing.assert_array_equal(got, x[src])
        np.testing.assert_array_equal(
            got, np.concatenate([o for o in jouts if o.size], 0))


def test_shift_buffer_rejects_negative():
    from kaldi_lstm_tpu_torch.decode.online import _ShiftBuffer
    with pytest.raises(ValueError):
        _ShiftBuffer(-1)


# ---------------------------------------------------------------------------
# the single-stream recognizer
# ---------------------------------------------------------------------------

def _offline_shifted(w, feats, delay):
    """The port's whole-utterance scores of the delayed features (the
    TimeShift end clamp) and decode_faster on them."""
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    T = len(feats)
    src = np.clip(np.arange(T) + delay, 0, T - 1)
    sc = AmScorer(w["nnet"], w["params"], log_prior=w["log_prior"],
                  apply_log=True, device="cpu")
    [(_, ll)] = list(sc.score_stream([("u", feats[src])]))
    return w["decode_faster"](w["graph"], ll, 0.5, 18.0)


@pytest.mark.parametrize("delay", [0, 3])
def test_online_recognizer_matches_jax_and_offline(world, delay):
    from kaldi_lstm_tpu.decode.online import OnlineRecognizer as JRec
    from kaldi_lstm_tpu_torch.decode.online import OnlineRecognizer
    w = world
    rng = np.random.RandomState(7 + delay)
    for key in w["keys"][:3]:
        feats = w["feats"][key]
        rec = OnlineRecognizer(w["nnet"], w["params"], w["graph"],
                               log_prior=w["log_prior"], acoustic_scale=0.5,
                               beam=18.0, targets_delay=delay)
        jrec = JRec(w["jnnet"], w["jparams"], w["jgraph"],
                    log_prior=w["log_prior"], acoustic_scale=0.5,
                    beam=18.0, targets_delay=delay)
        for chunk in _chunks(feats, rng):
            rec.accept(chunk)
            jrec.accept(chunk)
            assert rec.partial().words == jrec.partial().words
        res, jres = rec.finalize(), jrec.finalize()
        ref = _offline_shifted(w, feats, delay)
        assert res.words == jres.words == ref.words
        assert abs(res.score - jres.score) < 1e-3
        assert abs(res.score - ref.score) < 1e-3


def test_online_recognizer_takes_delay_from_timeshift(world):
    """A standard-form decode net (TimeShift(3) + LstmProjected): the
    recognizer strips the TimeShift, takes its shift as the lookahead
    and converts the LSTM to the streams form; equal to the standard
    net's offline scores decoded, and to the JAX recognizer."""
    from kaldi_lstm_tpu.decode.online import OnlineRecognizer as JRec
    from kaldi_lstm_tpu_torch.decode.online import OnlineRecognizer
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.models.components import Transmit
    w = world
    head = Transmit(8, 8)
    snet = Nnet([head] + list(w["nnet"].components)).to_standard()
    snet.components[0].shift = 3
    sparams = (head.init_params(None),) + tuple(w["params"])
    feats = w["feats"][w["keys"][3]]
    sc = AmScorer(snet, sparams, log_prior=w["log_prior"], apply_log=True,
                  device="cpu")
    [(_, ll)] = list(sc.score_stream([("u", feats)]))
    ref = w["decode_faster"](w["graph"], ll, 0.5, 18.0)
    rec = OnlineRecognizer(snet, sparams, w["graph"],
                           log_prior=w["log_prior"], acoustic_scale=0.5,
                           beam=18.0)
    assert rec.shift.k == 3
    jrec = JRec(w["jnnet"], w["jparams"], w["jgraph"],
                log_prior=w["log_prior"], acoustic_scale=0.5, beam=18.0,
                targets_delay=3)
    rng = np.random.RandomState(9)
    for chunk in _chunks(feats, rng):
        rec.accept(chunk)
        jrec.accept(chunk)
    res, jres = rec.finalize(), jrec.finalize()
    assert res.words == ref.words == jres.words
    assert abs(res.score - ref.score) < 1e-3


# ---------------------------------------------------------------------------
# the batched scorer
# ---------------------------------------------------------------------------

def _scorers(w, n, **kw):
    from kaldi_lstm_tpu.decode.online import OnlineBatchScorer as JScorer
    from kaldi_lstm_tpu_torch.decode.online import OnlineBatchScorer
    jkw = dict(kw)
    if kw.get("fetch_dtype") is not None:
        import jax.numpy as jnp
        jkw["fetch_dtype"] = jnp.bfloat16
    return (OnlineBatchScorer(w["nnet"], w["params"], n, **kw),
            JScorer(w["jnnet"], w["jparams"], n, **jkw))


def _ticks(w, n, t, count, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, t, 8).astype(np.float32) for _ in range(count)]


def test_batch_scorer_matches_jax_and_per_session(world):
    from kaldi_lstm_tpu_torch.decode.online import OnlineBatchScorer
    w = world
    sc, jsc = _scorers(w, 3, log_prior=w["log_prior"])
    ticks = _ticks(w, 3, 4, 3, 0)
    got = np.concatenate([sc.score(x) for x in ticks], axis=1)
    jgot = np.concatenate([np.asarray(jsc.score(x)) for x in ticks], axis=1)
    np.testing.assert_allclose(got, jgot, **TOL)
    for s in range(3):
        one = OnlineBatchScorer(w["nnet"], w["params"], 1,
                                log_prior=w["log_prior"])
        ref = np.concatenate([one.score(x[s:s + 1]) for x in ticks], 1)
        np.testing.assert_allclose(got[s], ref[0], **TOL)


def test_batch_scorer_lengths_match_jax(world):
    """Ragged ticks (`lengths`, the advance mask): the valid rows equal
    the JAX scorer's; a session fed nothing keeps its state, so its next
    full tick equals the JAX one's too."""
    w = world
    sc, jsc = _scorers(w, 4, log_prior=w["log_prior"])
    ticks = _ticks(w, 4, 5, 4, 1)
    lens = [np.array([5, 0, 3, 5]), np.array([2, 5, 0, 5]),
            np.array([0, 0, 5, 1]), None]
    for x, ln in zip(ticks, lens):
        got = sc.score(x, lengths=ln)
        jgot = np.asarray(jsc.score(x, lengths=ln))
        for s in range(4):
            n = 5 if ln is None else ln[s]
            np.testing.assert_allclose(got[s, :n], jgot[s, :n], **TOL)


def test_reset_zeroes_only_requested_sessions(world):
    w = world
    sc, jsc = _scorers(w, 4)
    first, chunk2 = _ticks(w, 4, 5, 2, 2)
    sc.score(first)
    jsc.score(first)
    fresh = _scorers(w, 4)[0].score(chunk2)
    sc.reset([1, 3])
    jsc.reset([1, 3])
    got = sc.score(chunk2)
    np.testing.assert_allclose(got, np.asarray(jsc.score(chunk2)), **TOL)
    np.testing.assert_allclose(got[1], fresh[1], **TOL)
    np.testing.assert_allclose(got[3], fresh[3], **TOL)
    assert np.abs(got[0] - fresh[0]).max() > 1e-6
    assert np.abs(got[2] - fresh[2]).max() > 1e-6


def test_top_p_and_bf16_fetch_match_jax(world):
    """top_p = K rebuilds the dense block; top_p = 4 keeps the fetched
    values and floors the rest as the JAX scorer does; the bf16 fetch
    rounds the same values (within one bf16 step of the JAX result)."""
    w = world
    x = _ticks(w, 2, 4, 1, 3)[0]
    dense = _scorers(w, 2)[0].score(x)
    full = _scorers(w, 2, top_p=NUM_PDFS)[0].score(x)
    np.testing.assert_allclose(full, dense, **TOL)
    part, jpart = _scorers(w, 2, top_p=4, floor_margin=5.0)
    part, jpart = part.score(x), np.asarray(jpart.score(x))
    np.testing.assert_allclose(part, jpart, **TOL)
    order = np.argsort(-dense, axis=-1)
    np.testing.assert_allclose(np.take_along_axis(part, order[..., :4], -1),
                               np.take_along_axis(dense, order[..., :4], -1),
                               **TOL)
    b, jb = _scorers(w, 2, fetch_dtype=torch.bfloat16)
    b, jb = b.score(x), np.asarray(jb.score(x), np.float32)
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, jb, rtol=2 ** -7, atol=1e-5)
    np.testing.assert_array_equal(
        b, torch.from_numpy(b).to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose(b, dense, rtol=0.02, atol=0.02)


def test_pipeline_mode_shifted_identical(world):
    """Pipelined scoring returns the eager blocks one tick late."""
    w = world
    ticks = _ticks(w, 2, 3, 4, 4)
    eager = _scorers(w, 2)[0]
    want = [eager.score(x) for x in ticks]
    pipe = _scorers(w, 2, pipeline=True)[0]
    got = [pipe.score(x) for x in ticks]
    assert got[0] is None
    for a, b in zip(got[1:] + [pipe.flush()], want):
        np.testing.assert_array_equal(a, b)
    assert pipe.flush() is None


def test_pipeline_takes_a_private_copy_of_each_tick(world):
    """A caller that overwrites its chunk buffer right after `score`
    (online_serve_batch reuses one) must not change the tick in flight.
    The forward is deferred to the fetch here, as a device queue defers
    it, so a tick that kept a view of the caller's buffer would read the
    overwritten values."""
    w = world
    ticks = _ticks(w, 2, 3, 4, 5)
    eager = _scorers(w, 2)[0]
    want = [eager.score(x) for x in ticks]
    pipe = _scorers(w, 2, pipeline=True)[0]
    forward, fetch = pipe._forward, pipe._fetch
    pipe._forward = lambda x, amask: (lambda: forward(x, amask))
    pipe._fetch = lambda y: fetch(y())
    buf = np.empty_like(ticks[0])
    got = []
    for x in ticks:
        buf[:] = x
        got.append(pipe.score(buf))
        buf[:] = np.nan   # the caller reuses its buffer at once
    for a, b in zip(got[1:] + [pipe.flush()], want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _table(path):
    return dict(line.split(None, 1) if " " in line else (line, "")
                for line in open(path).read().splitlines())


@pytest.fixture(scope="module")
def offline_hyps(world):
    """The port's offline pipeline on the CPU (nnet_forward -> ark ->
    decode_faster) at the CLI search flags, for delays 0 and 2."""
    from kaldi_lstm_tpu_torch.io.kaldi_io import (
        MatrixWriter,
        SequentialMatrixReader,
    )
    from kaldi_lstm_tpu_torch.tools.decode_faster import main as decode
    from kaldi_lstm_tpu_torch.tools.nnet_forward import main as fwd
    from kaldi_lstm_tpu_torch.tools.online_serve_batch import _shift_feats
    d = world["d"]
    out = {}
    for delay in (0, 2):
        spec = f"scp:{d}/feats.scp"
        if delay:
            with MatrixWriter(f"ark,scp:{d}/sh.ark,{d}/sh.scp") as wr:
                for k, m in SequentialMatrixReader(spec):
                    wr.write(k, _shift_feats(np.asarray(m, np.float32),
                                             delay))
            spec = f"scp:{d}/sh.scp"
        for prior in (False, True):
            pri = [f"--class-frame-counts={d}/counts.vec"] if prior else []
            assert fwd([f"{d}/final.nnet", spec, f"ark:{d}/ll.ark",
                        "--apply-log=true", "--device", "cpu"] + pri) == 0
            assert decode([f"{d}/final.mdl", f"{d}/lexicon.txt",
                           f"{d}/lm.arpa", f"ark:{d}/ll.ark",
                           f"ark,t:{d}/off.txt", "--word-symbol-table",
                           f"{d}/words.txt"] + CLI_SEARCH) == 0
            out[delay, prior] = _table(f"{d}/off.txt")
    return out


def _cli_args(d, out, extra):
    return [f"{d}/final.nnet", f"{d}/final.mdl", f"{d}/lexicon.txt",
            f"{d}/lm.arpa", f"scp:{d}/feats.scp", f"ark,t:{d}/{out}",
            "--word-symbol-table", f"{d}/words.txt"] + CLI_SEARCH \
        + list(extra)


@pytest.mark.parametrize("name,extra", [
    ("n3c7", ["--num-sessions", "3", "--chunk-frames", "7"]),
    ("delay", ["--num-sessions", "2", "--chunk-frames", "5",
               "--targets-delay", "2"]),
    ("one_big", ["--num-sessions", "1", "--chunk-frames", "1000"]),
    ("priors", ["--num-sessions", "3", "--chunk-frames", "6",
                "--class-frame-counts={d}/counts.vec"]),
    ("pipeline", ["--num-sessions", "3", "--chunk-frames", "7",
                  "--pipeline", "true"]),
    ("pipeline_delay", ["--num-sessions", "2", "--chunk-frames", "5",
                        "--targets-delay", "2", "--pipeline", "true"]),
    ("top_p_all", ["--num-sessions", "3", "--chunk-frames", "9",
                   "--top-p", str(NUM_PDFS)]),
    ("top_p6", ["--num-sessions", "3", "--chunk-frames", "9",
                "--top-p", "6"]),
    ("bf16", ["--num-sessions", "4", "--chunk-frames", "8",
              "--fetch-bf16", "true"]),
])
def test_online_serve_batch_matches_jax_and_offline(world, offline_hyps,
                                                    name, extra):
    from kaldi_lstm_tpu.tools.online_serve_batch import main as jax_main
    from kaldi_lstm_tpu_torch.tools.online_serve_batch import main
    d = world["d"]
    extra = [e.format(d=d) for e in extra]
    assert jax_main(_cli_args(d, f"jax_{name}.txt", extra)) == 0
    assert main(_cli_args(d, f"port_{name}.txt", extra)
                + ["--device", "cpu"]) == 0
    assert _read(f"{d}/port_{name}.txt") == _read(f"{d}/jax_{name}.txt")
    if name in ("bf16", "top_p6"):
        return   # rounded or floored scores are not the offline ones
    delay = 2 if "--targets-delay" in extra else 0
    prior = any(e.startswith("--class-frame-counts") for e in extra)
    hyp = _table(f"{d}/port_{name}.txt")
    assert hyp == offline_hyps[delay, prior] and len(hyp) == 24


@pytest.mark.parametrize("extra", [
    ["--chunk-frames", "7"],
    ["--chunk-frames", "5", "--targets-delay", "2", "--print-partials"],
])
def test_online_decode_matches_jax_and_offline(world, offline_hyps, extra):
    """On the first 6 utterances (the JAX recognizer compiles its step
    once per utterance)."""
    from kaldi_lstm_tpu.tools.online_decode import main as jax_main
    from kaldi_lstm_tpu_torch.tools.online_decode import main
    d = world["d"]
    with open(f"{d}/feats.scp") as f:
        head = f.read().splitlines()[:6]
    with open(f"{d}/six.scp", "w") as f:
        f.write("\n".join(head) + "\n")

    def argv(out):
        a = _cli_args(d, out, extra)
        a[4] = f"scp:{d}/six.scp"
        return a
    assert jax_main(argv("jax_od.txt")) == 0
    assert main(argv("port_od.txt") + ["--device", "cpu"]) == 0
    assert _read(f"{d}/port_od.txt") == _read(f"{d}/jax_od.txt")
    delay = 2 if "--targets-delay" in extra else 0
    off = offline_hyps[delay, False]
    hyp = _table(f"{d}/port_od.txt")
    assert hyp == {k: off[k] for k in hyp} and len(hyp) == 6


def test_streaming_clis_without_cuda_exit_1(tmp_path, monkeypatch, capsys):
    from kaldi_lstm_tpu_torch.tools import (
        online_decode,
        online_serve_batch,
        online_serve_sticky,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (online_decode, online_serve_batch, online_serve_sticky):
        out = tmp_path / f"{tool.__name__}.txt"
        assert tool.main(["m.nnet", "final.mdl", "lexicon.txt", "none",
                          "ark:f.ark", f"ark,t:{out}"]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert not out.exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 has no CPU mode); run on the "
                    "card with: python -m pytest -m gpu "
                    "tests/test_torch_online.py")
    return torch.device("cuda")


def _k5_case(S, T, I, C, R, seed, device):
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params
    p = init_lstm_params(torch.Generator().manual_seed(seed), I, C, R, 0.04,
                         device=device)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32), device=device)
    st = LstmState(
        c=torch.tensor(rng.randn(S, C).astype(np.float32) * 0.5,
                       device=device),
        r=torch.tensor(rng.randn(S, R).astype(np.float32) * 0.5,
                       device=device))
    return p, x, st


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R", [(1, 20, 40, 800, 512),
                                       (4, 20, 40, 800, 512),
                                       (64, 20, 40, 800, 512),
                                       (3, 9, 37, 200, 130)])
def test_cuda_masked_k5_matches_plain_version(cuda_device, S, T, I, C, R):
    """Tolerance 1e-4 abs + 1e-4 rel (chip_smoke.py's K5 tolerance): the
    valid rows of r and the final (c, r); one launch of the masked entry
    point; lengths 0 and T among the streams (a single stream stops 7
    frames short of T), one middle frame masked."""
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan
    p, x, st = _k5_case(S, T, I, C, R, 20, cuda_device)
    lengths = np.random.RandomState(S).randint(0, T + 1, S)
    lengths[0], lengths[-1] = 0, T
    if S == 1:
        lengths[0] = T - 7
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    mask[-1, T // 2] = 0.0
    m = torch.tensor(mask, device=cuda_device)
    li.reset_counts()
    with torch.inference_mode():
        out, fin = li.lstm_infer(p, x, st, advance_mask=m)
        ref, ref_fin = lstm_scan(p, x, st, advance_mask=m)
        torch.cuda.synchronize()
    assert (li.MASKED_LAUNCHES, li.LAUNCHES, li.PLAIN_CALLS) == (1, 0, 0)
    with torch.inference_mode():   # bytes, read in place at their strides
        out_u8, fin_u8 = li.lstm_infer(p, x, st,
                                       advance_mask=m.to(torch.uint8))
    assert torch.equal(out_u8, out) and torch.equal(fin_u8.c, fin.c)
    valid = m.bool()
    for a, b in ((out[valid], ref[valid]), (fin.c, ref_fin.c),
                 (fin.r, ref_fin.r)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if lengths[0] == 0:
        assert torch.equal(fin.c[0], st.c[0])
        assert torch.equal(fin.r[0], st.r[0])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 64])
def test_cuda_chunked_k5_equals_whole_at_the_same_S(cuda_device, S):
    """The step's summation order does not depend on T: K5 over 5 chunks
    of 20 frames with the carried state equals one call over 100 frames
    bit for bit (unmasked, and masked with every frame set)."""
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState
    p, x, st = _k5_case(S, 100, 40, 800, 512, 21, cuda_device)
    ones = torch.ones(S, 20, device=cuda_device)
    with torch.inference_mode():
        whole, wfin = li.lstm_infer(p, x, st)
        for mask in (None, ones):
            s, parts = LstmState(st.c.clone(), st.r.clone()), []
            for t0 in range(0, 100, 20):
                o, s = li.lstm_infer(p, x[:, t0:t0 + 20], s,
                                     advance_mask=mask)
                parts.append(o)
            assert torch.equal(torch.cat(parts, 1), whole)
            assert torch.equal(s.c, wfin.c) and torch.equal(s.r, wfin.r)


@pytest.mark.gpu
def test_cuda_masked_call_needing_a_gradient_raises(cuda_device):
    from kaldi_lstm_tpu_torch.models import Nnet
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    p, x, st = _k5_case(2, 4, 8, 16, 8, 22, cuda_device)
    x.requires_grad_(True)
    mask = torch.ones(2, 4, device=cuda_device)
    with pytest.raises(NotImplementedError, match="gradient"):
        li.lstm_infer(p, x, st, advance_mask=mask)
    proto = """<NnetProto>
<LstmProjectedStreams> <InputDim> 8 <OutputDim> 8 <CellDim> 16 <NumStream> 2
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(0), cuda_device)
    with pytest.raises(NotImplementedError, match="training"):
        nnet.propagate(params, x, nnet.init_states(2, cuda_device),
                       advance_mask=mask)
