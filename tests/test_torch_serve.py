"""The port's sticky-session server (`decode/serve.py`) and its CLI
(`online_serve_sticky`) against the JAX package's, on the CPU (the plain
path: the masked scan is K5's plain version), in the world of
tests/test_torch_online.py (the port-trained AM both packages read).

Held: under a Poisson arrival trace with more sessions than slots, with
starved slots (their state frozen by the advance mask), endpointing on
trailing silence, the max-frames cap, slot rebinding and late audio,
every finalized hypothesis equals the JAX server's on the same trace and
the offline decode of the same audio (of the consumed prefix when
endpointed), and the scores within 1e-3 of the JAX server's (float32
scores within 1e-5 summed over a few hundred frames); the CLI's
transcript file equals the JAX CLI's byte for byte.
"""

import importlib.util
import pathlib

import numpy as np
import pytest


def _sibling(name: str):
    """A module of this directory loaded by its path: where another
    installed package is named `tests`, `tests.<name>` would find that
    one instead."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_sibling_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make_world = _sibling("test_torch_online").make_world

SEARCH = dict(acoustic_scale=1.0, beam=18.0, chunk_frames=7)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(str(tmp_path_factory.mktemp("serve_port")))


def _servers(w, n_slots, endpoint=None):
    """The port's and the JAX package's servers on the same model."""
    from kaldi_lstm_tpu.decode.serve import EndpointConfig as JEndpoint
    from kaldi_lstm_tpu.decode.serve import StickySessionServer as JServer
    from kaldi_lstm_tpu_torch.decode.serve import StickySessionServer
    jend = None if endpoint is None else JEndpoint(**vars(endpoint))
    return (StickySessionServer(w["nnet"], w["params"], w["graph"], n_slots,
                                log_prior=w["log_prior"], endpoint=endpoint,
                                **SEARCH),
            JServer(w["jnnet"], w["jparams"], w["jgraph"], n_slots,
                    log_prior=w["log_prior"], endpoint=jend, **SEARCH))


def _both(servers, method, *args):
    for srv in servers:
        getattr(srv, method)(*args)


def _same_results(servers):
    """Both servers finalized the same sessions in the same order with
    the same words, endpoint flags and frame counts; returns the port's
    {sid: result}."""
    port, jax = servers
    assert [r.sid for r in port.results] == [r.sid for r in jax.results]
    for a, b in zip(port.results, jax.results):
        assert a.result.words == b.result.words, a.sid
        assert (a.endpointed, a.n_frames) == (b.endpointed, b.n_frames)
        assert abs(a.result.score - b.result.score) < 1e-3
    return {r.sid: r for r in port.results}


def _offline(w, feats):
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    sc = AmScorer(w["nnet"], w["params"], log_prior=w["log_prior"],
                  apply_log=True, device="cpu")
    [(_, ll)] = list(sc.score_stream([("u", feats)]))
    return w["decode_faster"](w["graph"], ll, 1.0, 18.0, 0)


def test_poisson_trace_matches_jax_and_offline(world):
    """20 sessions, 6 slots, Poisson chunk sizes with random
    interleaving (some ticks starve some slots)."""
    w = world
    servers = _servers(w, 6)
    keys = w["keys"][:20]
    rng = np.random.RandomState(7)
    cursors = {k: 0 for k in keys}
    live = list(keys)
    port = servers[0]
    while live or any(s is not None for s in port.slots) or port.waiting:
        for k in list(live):
            if rng.rand() < 0.6:
                n = rng.poisson(6)
                f = w["feats"][k]
                if n > 0 and cursors[k] < len(f):
                    _both(servers, "submit", k, f[cursors[k]:cursors[k] + n])
                    cursors[k] += n
                if cursors[k] >= len(f):
                    _both(servers, "submit", k, f[0:0])
                    _both(servers, "end_stream", k)
                    live.remove(k)
        _both(servers, "tick")
    _both(servers, "drain")
    got = _same_results(servers)
    assert set(got) == set(keys)
    for k in keys:
        assert got[k].result.words == w["offline"][k].words, k
        assert abs(got[k].result.score - w["offline"][k].score) < 1e-3
    assert not any(r.endpointed for r in got.values())
    assert 0.0 < port.occupancy <= 1.0
    assert port.occupancy == servers[1].occupancy


def test_starved_slot_state_freezes(world):
    w = world
    servers = _servers(w, 2)
    k = w["keys"][0]
    f = w["feats"][k]
    _both(servers, "submit", k, f[:5])
    for _ in range(3):   # one tick of 5 frames, then two starved ticks
        _both(servers, "tick")
    _both(servers, "submit", k, f[5:])
    _both(servers, "end_stream", k)
    _both(servers, "drain")
    got = _same_results(servers)
    assert got[k].result.words == w["offline"][k].words


def test_endpointing_trailing_silence(world):
    """Speech followed by sustained silence endpoints the session; the
    hypothesis equals the offline decode of exactly the consumed frames."""
    from kaldi_lstm_tpu_torch.decode.serve import EndpointConfig
    w = world
    k = w["keys"][1]
    y = w["loglik"][k]
    sil = [t for t in range(len(y)) if int(y[t].argmax()) in w["sil_pdfs"]]
    assert sil, "the model scores no frame as silence"
    tail = np.tile(w["feats"][k][sil[len(sil) // 2]], (60, 1))
    audio = np.concatenate([w["feats"][k], tail], axis=0)
    servers = _servers(w, 1, EndpointConfig(silence_pdfs=w["sil_pdfs"],
                                            trailing_silence_frames=25,
                                            min_speech_frames=3))
    _both(servers, "submit", k, audio)
    _both(servers, "end_stream", k)
    _both(servers, "drain")
    [r] = _same_results(servers).values()
    assert r.endpointed and r.n_frames < len(audio)
    assert r.result.words == _offline(w, audio[:r.n_frames]).words


def test_max_utterance_force_endpoint(world):
    from kaldi_lstm_tpu_torch.decode.serve import EndpointConfig
    w = world
    k = w["keys"][2]
    f = w["feats"][k]
    servers = _servers(w, 1, EndpointConfig(silence_pdfs=w["sil_pdfs"],
                                            trailing_silence_frames=10**9,
                                            max_utterance_frames=12))
    _both(servers, "submit", k, f)
    _both(servers, "end_stream", k)
    _both(servers, "drain")
    [r] = _same_results(servers).values()
    assert r.endpointed and 12 <= r.n_frames < len(f)
    assert r.result.words == _offline(w, f[:r.n_frames]).words


def test_slot_rebind_after_endpoint(world):
    from kaldi_lstm_tpu_torch.decode.serve import EndpointConfig
    w = world
    keys = w["keys"][:3]
    servers = _servers(w, 1, EndpointConfig(silence_pdfs=w["sil_pdfs"],
                                            trailing_silence_frames=10**9,
                                            max_utterance_frames=8))
    for k in keys:
        _both(servers, "submit", k, w["feats"][k])
        _both(servers, "end_stream", k)
    _both(servers, "drain")
    got = _same_results(servers)
    assert list(got) == keys and all(r.endpointed for r in got.values())
    for k in keys:   # each newcomer starts from a reset state
        f = w["feats"][k][:got[k].n_frames]
        assert got[k].result.words == _offline(w, f).words


def test_late_audio_after_endpoint_dropped(world):
    from kaldi_lstm_tpu_torch.decode.serve import EndpointConfig
    w = world
    k = w["keys"][3]
    f = w["feats"][k]
    servers = _servers(w, 1, EndpointConfig(silence_pdfs=w["sil_pdfs"],
                                            trailing_silence_frames=10**9,
                                            max_utterance_frames=6))
    _both(servers, "submit", k, f)
    _both(servers, "drain")
    assert len(servers[0].results) == 1
    _both(servers, "submit", k, f)     # late audio: dropped
    _both(servers, "end_stream", k)    # idempotent on a closed session
    _both(servers, "drain")
    assert len(_same_results(servers)) == 1


def test_end_stream_unknown_sid_graceful(world):
    servers = _servers(world, 1)
    _both(servers, "end_stream", "never-submitted")
    _both(servers, "drain")
    assert servers[0].results == [] == servers[1].results


def test_partial_matches_jax_mid_stream(world):
    w = world
    servers = _servers(w, 2)
    k = w["keys"][4]
    f = w["feats"][k]
    _both(servers, "submit", k, f[:len(f) // 2])
    _both(servers, "tick")
    _both(servers, "tick")
    a, b = servers[0].partial(k), servers[1].partial(k)
    assert a.words == b.words and abs(a.score - b.score) < 1e-3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _sticky(w, tag, extra, scp=None):
    """The JAX CLI and the port's on the same flags: transcript files
    byte-identical; returns the port's {key: words}."""
    from kaldi_lstm_tpu.tools.online_serve_sticky import main as jax_main
    from kaldi_lstm_tpu_torch.tools.online_serve_sticky import main
    d = w["d"]

    def argv(out):
        return [f"{d}/final.nnet", f"{d}/final.mdl", f"{d}/lexicon.txt",
                f"{d}/lm.arpa", scp or f"scp:{d}/feats.scp",
                f"ark,t:{d}/{out}", "--word-symbol-table", f"{d}/words.txt",
                "--acoustic-scale", "1.0", "--beam", "18"] + list(extra)
    assert jax_main(argv(f"jax_{tag}.txt")) == 0
    assert main(argv(f"port_{tag}.txt") + ["--device", "cpu"]) == 0
    assert _read(f"{d}/port_{tag}.txt") == _read(f"{d}/jax_{tag}.txt")
    return dict((ln.split(None, 1) + [""])[:2]
                for ln in open(f"{d}/port_{tag}.txt").read().splitlines())


def test_sticky_cli_matches_jax_and_offline(world):
    """Ragged Poisson chunks, staggered arrivals, fewer slots than
    sessions."""
    w = world
    hyp = _sticky(w, "poisson", ["--num-slots", "4", "--chunk-frames", "7",
                                 "--arrival-hazard", "0.5",
                                 "--mean-chunk", "5", "--trace-seed", "3",
                                 f"--class-frame-counts={w['d']}/counts.vec"])
    sym = w["graph"].words.id2sym
    off = {k: " ".join(sym[i] for i in r.words)
           for k, r in w["offline"].items()}
    assert hyp == off and len(hyp) == 24


def test_sticky_cli_delay_matches_jax(world):
    _sticky(world, "delay", ["--num-slots", "3", "--chunk-frames", "5",
                             "--targets-delay", "2",
                             "--arrival-hazard", "0.7", "--mean-chunk", "4"])


def test_sticky_cli_zero_length_utterance(world, tmp_path):
    from kaldi_lstm_tpu_torch.io.kaldi_io import MatrixWriter
    with MatrixWriter(f"ark,scp:{tmp_path}/z.ark,{tmp_path}/z.scp") as wr:
        wr.write("empty00", np.zeros((0, 8), np.float32))
        wr.write("one00", np.zeros((3, 8), np.float32))
    hyp = _sticky(world, "zero", ["--num-slots", "2", "--chunk-frames", "5"],
                  scp=f"scp:{tmp_path}/z.scp")
    assert set(hyp) == {"empty00", "one00"}


def test_sticky_cli_endpointing_runs(world, capsys):
    """With every pdf in the silence set every session endpoints early."""
    hyp = _sticky(world, "endpoint", [
        "--num-slots", "4", "--endpoint-silence-pdfs",
        ",".join(str(i) for i in range(10)),
        "--endpoint-trailing-silence", "5", "--endpoint-min-speech", "0"])
    assert len(hyp) == 24
    assert "24 endpointed" in capsys.readouterr().err
