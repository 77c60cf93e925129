"""The port's compressed-matrix writer, int32 tables, random-access
matrix reader and mmap views against the JAX package's, on matrices made
with numpy from a seed.

Held exact: the compressed bytes (CM, CM2, CM3 and "auto", with the
writer's edge cases: constant, one-row and tiny matrices), the arks and
scp indexes the table writers produce, and every value read back (the
port's readers against the JAX package's on the same files). The
round-trip accuracy bounds are the JAX package's own
(tests/test_compressed_matrix.py): a range/48 bound for CM's three uint8
segments, range/30000 for CM2, range/200 for CM3.
"""

import io
import os

import numpy as np
import pytest

from kaldi_lstm_tpu.io import kaldi_io as jkio
from kaldi_lstm_tpu_torch.io import kaldi_io as kio


def _compressed(mod, mat, method):
    buf = io.BytesIO()
    mod.write_compressed_matrix(mod.KaldiOutput(buf, binary=True), mat,
                                method)
    return buf.getvalue()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _cases():
    rng = np.random.RandomState(0)
    return {
        "randn": rng.randn(50, 13).astype(np.float32) * 3.0 + 1.0,
        "short": rng.randn(5, 7).astype(np.float32),
        "constant": np.full((9, 4), 2.5, np.float32),
        "zeros": np.zeros((10, 3), np.float32),
        "one_row": np.array([[1.0, 2.0]], np.float32),
        "ties": np.repeat(rng.randn(4, 6).astype(np.float32), 5, axis=0),
        "wide": rng.randn(200, 40).astype(np.float32) * 10.0,
    }


@pytest.mark.parametrize("method", ["auto", "CM", "CM2", "CM3"])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_compressed_bytes_equal_jax(method, case):
    mat = _cases()[case]
    assert _compressed(kio, mat, method) == _compressed(jkio, mat, method)


@pytest.mark.parametrize("method,tol_frac", [
    ("CM", 1 / 48.0), ("CM2", 1 / 30000.0), ("CM3", 1 / 200.0)])
def test_roundtrip_accuracy_and_readers_agree(method, tol_frac):
    mat = _cases()["randn"]
    raw = _compressed(kio, mat, method)
    got = kio.read_matrix(kio.KaldiInput(io.BufferedReader(
        io.BytesIO(raw))))
    ref = jkio.read_matrix(jkio.KaldiInput(io.BufferedReader(
        io.BytesIO(raw))))
    np.testing.assert_array_equal(got, ref)
    assert np.max(np.abs(got - mat)) <= (mat.max() - mat.min()) * tol_frac


def test_cm_column_major_layout():
    """Column identity survives (CM data is column-major)."""
    mat = np.zeros((20, 3), np.float32)
    mat[:, 0] = np.linspace(0, 1, 20)
    mat[:, 1] = np.linspace(10, 11, 20)
    mat[:, 2] = np.linspace(-5, -4, 20)
    raw = _compressed(kio, mat, "CM")
    got = kio.read_matrix(kio.KaldiInput(io.BufferedReader(
        io.BytesIO(raw))))
    for c in range(3):
        assert abs(got[:, c].mean() - mat[:, c].mean()) < 0.1


def test_text_mode_writes_the_plain_matrix():
    mat = _cases()["short"]
    bufs = []
    for mod in (kio, jkio):
        buf = io.BytesIO()
        mod.write_compressed_matrix(mod.KaldiOutput(buf, binary=False), mat)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1] and bufs[0].lstrip().startswith(b"[")


def test_compressed_ark_scp_equal_jax_and_readable(tmp_path):
    d = str(tmp_path)
    rng = np.random.RandomState(1)
    mats = {f"u{i}": rng.randn(30 + i, 8).astype(np.float32)
            for i in range(4)}
    for tag, mod in (("port", kio), ("jax", jkio)):
        with mod.CompressedMatrixWriter(
                f"ark,scp:{d}/{tag}.ark,{d}/{tag}.scp") as w:
            for k, m in sorted(mats.items()):
                w.write(k, m)
    assert _read(f"{d}/port.ark") == _read(f"{d}/jax.ark")
    assert _read(f"{d}/port.scp").replace(b"port.ark", b"jax.ark") == \
        _read(f"{d}/jax.scp")
    for spec in (f"ark:{d}/port.ark", f"scp:{d}/port.scp"):
        got = dict(kio.SequentialMatrixReader(spec))
        ref = dict(jkio.SequentialMatrixReader(spec))
        assert sorted(got) == sorted(mats)
        for k in mats:
            np.testing.assert_array_equal(got[k], ref[k])
            rngv = mats[k].max() - mats[k].min()
            assert np.max(np.abs(got[k] - mats[k])) <= rngv / 48.0


def test_compression_ratio(tmp_path):
    d = str(tmp_path)
    m = np.random.RandomState(2).randn(1000, 40).astype(np.float32)
    with kio.MatrixWriter(f"ark:{d}/f.ark") as w:
        w.write("u", m)
    with kio.CompressedMatrixWriter(f"ark:{d}/c.ark") as w:
        w.write("u", m)
    assert os.path.getsize(f"{d}/c.ark") < os.path.getsize(
        f"{d}/f.ark") / 3.5


@pytest.mark.parametrize("spec", ["ark", "ark,t"])
def test_int32_table_bytes_and_reader_equal_jax(tmp_path, spec):
    vals = {"a": 3, "b": 1000, "c": 0, "d": -7}
    for tag, mod in (("port", kio), ("jax", jkio)):
        with mod.Int32Writer(f"{spec}:{tmp_path}/{tag}.ark") as w:
            for k, v in vals.items():
                w.write(k, v)
    assert _read(f"{tmp_path}/port.ark") == _read(f"{tmp_path}/jax.ark")
    got = list(kio.SequentialInt32Reader(f"ark:{tmp_path}/jax.ark"))
    assert got == list(jkio.SequentialInt32Reader(
        f"ark:{tmp_path}/jax.ark"))
    assert dict(got) == vals


def test_int32_reader_rejects_scp(tmp_path):
    (tmp_path / "x.scp").write_text("a x.ark:2\n")
    with pytest.raises(ValueError, match="scp"):
        list(kio.SequentialInt32Reader(f"scp:{tmp_path}/x.scp"))


@pytest.mark.parametrize("compress", [False, True])
def test_random_access_matrix_reader_equals_jax(tmp_path, compress):
    d = str(tmp_path)
    rng = np.random.RandomState(3)
    mats = {f"k{i}": rng.randn(7 + i, 5).astype(np.float32)
            for i in range(5)}
    writer = kio.CompressedMatrixWriter if compress else kio.MatrixWriter
    with writer(f"ark,scp:{d}/m.ark,{d}/m.scp") as w:
        for k, m in mats.items():
            w.write(k, m)
    for spec in (f"ark:{d}/m.ark", f"scp:{d}/m.scp"):
        got = kio.RandomAccessMatrixReader(spec)
        ref = jkio.RandomAccessMatrixReader(spec)
        for k in reversed(sorted(mats)):
            assert got.has_key(k) and ref.has_key(k)
            np.testing.assert_array_equal(got.value(k), ref.value(k))
            if not compress:
                np.testing.assert_array_equal(got.value(k), mats[k])
        assert not got.has_key("missing")


def test_read_matrix_view_equals_jax(tmp_path):
    d = str(tmp_path)
    m = np.random.RandomState(4).randn(6, 3).astype(np.float32)
    with kio.MatrixWriter(f"ark,scp:{d}/v.ark,{d}/v.scp") as w:
        w.write("utt_odd_key", m)
    path, off = open(f"{d}/v.scp").read().split()[1].rsplit(":", 1)
    off = int(off)
    view = kio.read_matrix_view(path, off)
    np.testing.assert_array_equal(view, jkio.read_matrix_view(path, off))
    np.testing.assert_array_equal(view, m)
    assert not view.flags.writeable
    assert kio.read_matrix_view(path, off + 1) is None
    assert jkio.read_matrix_view(path, off + 1) is None
    assert kio.read_matrix_view(path, 10**6) is None
    assert kio._mmap_file(f"{d}/does_not_exist") is None
