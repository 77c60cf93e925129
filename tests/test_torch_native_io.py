"""The native I/O half (csrc/kltio.cc through io/native.py): the ark
offset scans and the one-call batch fill, held to the JAX package's
native functions and to the Python readers and the numpy fill, byte for
byte, on arks that both packages wrote; and no fallback when the
library cannot be built."""

import warnings

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.io import kaldi_io as jkio
from kaldi_lstm_tpu.io import native as jnative
from kaldi_lstm_tpu.train.streams import StreamScheduler as JScheduler
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.io import native
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler

# keys of every length mod 4, so the float views are unaligned
KEYS = ["a", "bb", "ccc", "dddd", "u5", "utt0006", "x" * 13, "empty"]


def _matrices(seed=0, D=5):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(0 if k == "empty" else rng.randint(1, 30),
                         D).astype(np.float32) for k in KEYS}


def _posts(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for k in KEYS:
        L = 0 if k == "empty" else rng.randint(1, 30)
        out[k] = [[(int(rng.randint(0, 50)), float(np.float32(w)))
                   for w in rng.randn(rng.randint(0, 4))]
                  for _ in range(L)]
    return out


@pytest.fixture(params=["port", "jax"])
def arks(request, tmp_path):
    """Matrix and posterior arks written by either package."""
    mod = kio if request.param == "port" else jkio
    mats, posts = _matrices(), _posts()
    with mod.MatrixWriter(f"ark:{tmp_path}/m.ark") as w:
        for k, m in mats.items():
            w.write(k, m)
    with mod.PosteriorWriter(f"ark:{tmp_path}/p.ark") as w:
        for k, p in posts.items():
            w.write(k, p)
    return tmp_path, mats, posts


def test_matrix_scan_matches_jax_and_the_python_reader(arks):
    d, mats, _ = arks
    got = native.scan_matrix_ark(f"{d}/m.ark")
    ref = jnative.scan_matrix_ark(f"{d}/m.ark")
    assert [k for k, _ in got] == [k for k, _ in ref] == KEYS
    for (k, a), (_, b) in zip(got, ref):
        assert a.tobytes() == b.tobytes() == mats[k].tobytes()
        assert a.shape == mats[k].shape and not a.flags.writeable
    # the readers: views from the scan, the same bytes as Python's parse
    seq = list(kio.SequentialMatrixReader(f"ark:{d}/m.ark"))
    assert seq[0][1].base is not None  # a view, not a parse
    ra = kio.RandomAccessMatrixReader(f"ark:{d}/m.ark")
    jra = jkio.RandomAccessMatrixReader(f"ark:{d}/m.ark")
    with open(f"{d}/m.ark", "rb") as f:
        py = {}
        stream = kio._buffered(f)
        while (key := kio._read_key(stream)) is not None:
            py[key] = kio.read_matrix(kio._read_value_header(stream))
    for k, m in seq:
        assert m.tobytes() == py[k].tobytes() == ra.value(k).tobytes() \
            == jra.value(k).tobytes()
        assert ra.has_key(k)
    assert not ra.has_key("missing")


@pytest.mark.parametrize("K", [1, 2, 5])
def test_posterior_scan_matches_jax_and_the_python_reader(arks, K):
    d, _, posts = arks
    offsets = {}
    got = native.scan_posterior_ark(f"{d}/p.ark", K, offsets)
    ref = jnative.scan_posterior_ark(f"{d}/p.ark", K)
    assert list(got) == list(ref) == KEYS
    for k in KEYS:
        for a, b in zip(got[k], ref[k]):
            assert a.tobytes() == b.tobytes()
    mine = kio.RandomAccessPosteriorReader(f"ark:{d}/p.ark", K)
    jr = jkio.RandomAccessPosteriorReader(f"ark:{d}/p.ark", K)
    for k in KEYS:
        for kk in (1, K):
            a = mine.value_dense(k, kk)
            b = jr.value_dense(k, kk)
            for x, y in zip(a, b):
                assert x.tobytes() == np.ascontiguousarray(y).tobytes()
        # value() reads the record whole: every entry, any sign
        assert mine.value(k) == posts[k]
        assert mine.num_frames(k) == len(posts[k]) == jr.num_frames(k)
    seq = dict(kio.SequentialPosteriorReader(f"ark:{d}/p.ark"))
    assert {k: mine.value(k) for k in KEYS} == seq


def test_formats_the_scan_does_not_parse_take_the_python_reader(tmp_path):
    """A text ark and compressed matrices raise ValueError in the scan;
    the readers then parse them in Python, as the JAX readers do."""
    # (an empty matrix has no text form that the readers parse)
    mats = {k: m for k, m in _matrices(1).items() if k != "empty"}
    posts = {k: p for k, p in _posts(1).items() if k != "empty"}
    with kio.MatrixWriter(f"ark,t:{tmp_path}/t.ark") as w:
        for k, m in mats.items():
            w.write(k, m)
    with kio.CompressedMatrixWriter(f"ark:{tmp_path}/c.ark") as w:
        for k, m in mats.items():
            w.write(k, m)
    with kio.PosteriorWriter(f"ark,t:{tmp_path}/tp.ark") as w:
        for k, p in posts.items():
            w.write(k, p)
    for name in ("t.ark", "c.ark"):
        with pytest.raises(ValueError):
            native.scan_matrix_ark(f"{tmp_path}/{name}")
        mine = list(kio.SequentialMatrixReader(f"ark:{tmp_path}/{name}"))
        ref = list(jkio.SequentialMatrixReader(f"ark:{tmp_path}/{name}"))
        assert [k for k, _ in mine] == [k for k, _ in ref]
        for (_, a), (_, b) in zip(mine, ref):
            assert a.tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError):
        native.scan_posterior_ark(f"{tmp_path}/tp.ark")
    reader = kio.RandomAccessPosteriorReader(f"ark:{tmp_path}/tp.ark")
    assert reader.num_frames("bb") == len(posts["bb"])
    assert native.scan_matrix_ark(str(_empty(tmp_path))) == []
    assert native.scan_posterior_ark(str(_empty(tmp_path))) == {}


def _empty(d):
    p = d / "empty.ark"
    p.write_bytes(b"")
    return p


def _corpus(d, n=9, D=4, seed=0):
    rng = np.random.RandomState(seed)
    with kio.MatrixWriter(f"ark:{d}/f.ark") as fw, \
            kio.PosteriorWriter(f"ark:{d}/p.ark") as pw:
        for i in range(n):
            L = int(rng.randint(1, 23))
            fw.write(f"utt{i}", rng.randn(L, D).astype(np.float32))
            pw.write(f"utt{i}", [[(int(rng.randint(0, 9)), 0.7),
                                  (int(rng.randint(0, 9)), 0.3)]
                                 for _ in range(L)])
    rng = np.random.RandomState(seed + 1)
    weights = {f"utt{i}": rng.rand(200).astype(np.float32)
               for i in range(n)}
    return weights


class PlainFill(StreamScheduler):
    """The scheduler with the numpy fill, the plain version."""
    _fill_native = StreamScheduler._fill_plain


@pytest.mark.parametrize("S,T,delay,K,weights", [
    (3, 7, 0, 1, False), (4, 5, 3, 2, True), (16, 6, 2, 2, False),
    (2, 20, 25, 1, True)])
def test_native_fill_equals_numpy_fill_and_jax(tmp_path, S, T, delay, K,
                                               weights):
    """Every batch byte for byte: delayed features clamped at the
    utterance end, targets padded with the last frame, dry streams (more
    streams than utterances: S=16) zeroed, frame weights applied after
    the fill; and the JAX scheduler's batches."""
    fw = _corpus(tmp_path)
    if weights:
        fw = {k: v[:len(m)] for (k, m), v in zip(
            kio.SequentialMatrixReader(f"ark:{tmp_path}/f.ark"),
            fw.values())}

    def run(cls, mod):
        s = cls(iter(mod.SequentialMatrixReader(f"ark:{tmp_path}/f.ark")),
                mod.RandomAccessPosteriorReader(f"ark:{tmp_path}/p.ark", K),
                feat_dim=4, num_stream=S, batch_size=T, targets_delay=delay,
                max_entries=K, frame_weights=fw if weights else None)
        return list(s)

    mine, plain = run(StreamScheduler, kio), run(PlainFill, kio)
    ref = run(JScheduler, jkio)
    assert len(mine) == len(plain) == len(ref) > 1
    for a, b, c in zip(mine, plain, ref):
        for x, y, z in zip(a, b, c):
            x, y, z = (np.asarray(v) for v in (x, y, z))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes() \
                == z.tobytes()


def test_fill_stream_matches_jax():
    rng = np.random.RandomState(4)
    L, D, K, T = 9, 3, 2, 6
    feats = rng.randn(L, D).astype(np.float32)
    ids = rng.randint(0, 7, (L, K)).astype(np.int32)
    w = rng.rand(L, K).astype(np.float32)
    for curt in (0, 6, 12):
        outs = [[np.full((T, D), 9, np.float32), np.full((T, K), 9, np.int32),
                 np.full((T, K), 9, np.float32), np.full(T, 9, np.float32)]
                for _ in range(2)]
        a = native.fill_stream(T, 2, feats, ids, w, curt, *outs[0])
        b = jnative.fill_stream(T, 2, feats, ids, w, curt, *outs[1])
        assert a == b == curt + T
        for x, y in zip(*outs):
            assert x.tobytes() == y.tobytes()


def test_views_reach_torch_without_a_copy_warning(tmp_path):
    """The scan's read-only views feed the trainer: the batch arrays are
    the fill's own, so no tensor is made over a read-only array."""
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch
    _corpus(tmp_path)
    proto = ("<NnetProto>\n<LstmProjectedStreams> <InputDim> 4 "
             "<OutputDim> 4 <CellDim> 6 <NumStream> 3\n<AffineTransform> "
             "<InputDim> 4 <OutputDim> 9\n<Softmax> <InputDim> 9 "
             "<OutputDim> 9\n</NnetProto>")
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(0), "cpu")
    sched = StreamScheduler(
        iter(kio.SequentialMatrixReader(f"ark:{tmp_path}/f.ark")),
        kio.RandomAccessPosteriorReader(f"ark:{tmp_path}/p.ark", 2),
        feat_dim=4, num_stream=3, batch_size=5, targets_delay=1,
        max_entries=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = run_epoch(nnet, params, sched, TrainOptions(learn_rate=0.01))
    assert res.stats.frames > 0 and np.isfinite(res.stats.loss)


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_IO_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    return tmp_path


def test_failed_build_raises_and_never_falls_back(broken_compiler):
    d = broken_compiler
    _corpus(d)
    for make in (lambda: kio.SequentialMatrixReader(f"ark:{d}/f.ark"),
                 lambda: kio.RandomAccessMatrixReader(f"ark:{d}/f.ark"),
                 lambda: kio.RandomAccessPosteriorReader(f"ark:{d}/p.ark"),
                 lambda: native.get_io_lib()):
        with pytest.raises(RuntimeError, match="native I/O library"):
            make()
    # a scheduler over readers that need no scan still fills natively
    utts = [("u", np.ones((4, 4), np.float32))]
    sched = StreamScheduler(iter(utts),
                            kio.RandomAccessPosteriorReader(
                                f"scp:{_scp(d)}"),
                            feat_dim=4, num_stream=2, batch_size=3,
                            targets_delay=0)
    with pytest.raises(RuntimeError, match="kltio.cc"):
        list(sched)
    assert native._IO_LIB is None


def _scp(d):
    with kio.PosteriorWriter(f"ark,scp:{d}/q.ark,{d}/q.scp") as w:
        w.write("u", [[(1, 1.0)]] * 4)
    return f"{d}/q.scp"
