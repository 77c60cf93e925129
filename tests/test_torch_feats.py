"""The port's front end (`feats/fbank.py`, `io/wav.py`) against the JAX
package's, bit for bit: on waveforms made with numpy from a seed, the
fbank and MFCC features, the mel banks, the frame counts and the windows
of both packages are `np.array_equal` (snip_edges true and false, every
window type, dither 0 and dither > 0 with the same explicit
`RandomState(seed)` on both sides, round_to_power_of_two false, low and
high frequency cut-offs); the WAV bytes and parsed arrays are equal for
8-, 16-, 24- and 32-bit PCM, float32/64 and several channels, for
wav-ark records and tables and for a `cmd |` wav.scp entry.

Both modules are host numpy: the port's imports neither torch nor jax
(checked in a fresh interpreter).
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import kaldi_lstm_tpu.feats.fbank as jf
import kaldi_lstm_tpu.io.wav as jw
import kaldi_lstm_tpu_torch.feats.fbank as tf
import kaldi_lstm_tpu_torch.io.wav as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = ("povey", "hamming", "hanning", "rectangular", "blackman")


def wave(n=4321, seed=0, scale=2000.0):
    return np.random.RandomState(seed).randn(n) * scale


def options(pkg, kind="fbank", **frame_kw):
    mel_kw = {k: frame_kw.pop(k) for k in ("num_bins", "low_freq",
                                           "high_freq") if k in frame_kw}
    extra = {k: frame_kw.pop(k) for k in (
        "use_energy", "raw_energy", "energy_floor", "use_log_fbank",
        "use_power", "num_ceps", "cepstral_lifter") if k in frame_kw}
    fo = pkg.FrameOptions(**frame_kw)
    mo = pkg.MelOptions(**mel_kw)
    cls = pkg.FbankOptions if kind == "fbank" else pkg.MfccOptions
    return cls(frame_opts=fo, mel_opts=mo, **extra)


def both(kind, x, seed=None, **kw):
    out = []
    for pkg in (jf, tf):
        fn = pkg.compute_fbank if kind == "fbank" else pkg.compute_mfcc
        rng = None if seed is None else np.random.RandomState(seed)
        out.append(fn(x, options(pkg, kind, **kw), dither_rng=rng))
    return out


@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_fbank_bitwise(window, snip, dither):
    a, b = both("fbank", wave(), seed=11, window_type=window,
                snip_edges=snip, dither=dither, num_bins=40)
    assert a.dtype == b.dtype == np.float32 and a.shape[1] == 40
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(round_to_power_of_two=False, num_bins=23),
    dict(low_freq=64.0, high_freq=-400.0, num_bins=30),
    dict(low_freq=100.0, high_freq=7000.0, use_energy=True,
         raw_energy=False, energy_floor=2.0),
    dict(use_log_fbank=False, use_power=False, preemph_coeff=0.0,
         remove_dc_offset=False),
    dict(samp_freq=8000.0, frame_length_ms=20.0, frame_shift_ms=8.0,
         blackman_coeff=0.4, window_type="blackman", num_bins=15),
])
def test_fbank_options_bitwise(kw):
    a, b = both("fbank", wave(3000, 1), seed=5, **kw)
    assert a.shape[0] > 0 and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(), dict(snip_edges=False, window_type="hamming", num_ceps=20,
                 num_bins=40),
    dict(use_energy=False, cepstral_lifter=0.0),
    dict(raw_energy=False, energy_floor=1.0, round_to_power_of_two=False),
])
@pytest.mark.parametrize("dither", [0.0, 0.5])
def test_mfcc_bitwise(kw, dither):
    a, b = both("mfcc", wave(2500, 2), seed=3, dither=dither, **kw)
    assert np.array_equal(a, b)


def test_default_dither_stream_matches():
    """Without a generator both draw from their module-level stream; the
    two streams start equal and advance alike."""
    jf._DITHER_RNG.seed(0)
    tf._DITHER_RNG.seed(0)
    x = wave(1200, 4)
    for _ in range(2):
        a = jf.compute_fbank(x, jf.FbankOptions())
        b = tf.compute_fbank(x, tf.FbankOptions())
        assert np.array_equal(a, b)
    jf._DITHER_RNG.seed(0)
    tf._DITHER_RNG.seed(0)


def test_short_input_and_frame_counts():
    for snip in (True, False):
        for n in (0, 1, 79, 80, 399, 400, 401, 561, 16000):
            fo_j, fo_t = (p.FrameOptions(snip_edges=snip) for p in (jf, tf))
            assert jf.num_frames(n, fo_j) == tf.num_frames(n, fo_t)
    for kind in ("fbank", "mfcc"):
        a, b = both(kind, wave(100), dither=0.0)
        assert a.shape == b.shape and a.shape[0] == 0


@pytest.mark.parametrize("window", WINDOWS)
def test_windows_and_mel_banks(window):
    fo_j = jf.FrameOptions(window_type=window, round_to_power_of_two=False)
    fo_t = tf.FrameOptions(window_type=window, round_to_power_of_two=False)
    assert np.array_equal(jf._window(fo_j), tf._window(fo_t))
    assert fo_j.padded_window_size == fo_t.padded_window_size == 400
    for nb, lo, hi in ((23, 20.0, 0.0), (40, 300.0, -1000.0),
                       (80, 0.0, 8000.0)):
        mj = jf.mel_banks(fo_j, jf.MelOptions(nb, lo, hi))
        mt = tf.mel_banks(fo_t, tf.MelOptions(nb, lo, hi))
        assert np.array_equal(mj, mt)
    with pytest.raises(ValueError):
        tf.mel_banks(fo_t, tf.MelOptions(10, 9000.0, 0.0))
    with pytest.raises(ValueError):
        tf._window(tf.FrameOptions(window_type="kaiser"))


# --- WAV -------------------------------------------------------------

def riff(fmt_tag, channels, bits, body, rate=16000, extensible=False):
    align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_tag,
                      channels, rate, rate * align, align, bits)
    if extensible:
        fmt += struct.pack("<HHIH14s", 22, bits, 0, fmt_tag, b"\0" * 14)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"LIST" + struct.pack("<I", 3) + b"abc\0"
              + b"data" + struct.pack("<I", len(body)) + body)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def wav_cases():
    rng = np.random.RandomState(8)
    i16 = rng.randint(-32768, 32768, (3, 50)).astype("<i2")
    i24 = rng.randint(-(1 << 23), 1 << 23, 100)
    b24 = np.stack([(i24 >> s) & 0xFF for s in (0, 8, 16)], 1)
    return {
        "pcm16_stereo": riff(1, 2, 16, i16[:2].T.tobytes()),
        "pcm16_3ch_extensible": riff(1, 3, 16, i16.T.tobytes(),
                                     extensible=True),
        "pcm8": riff(1, 1, 8, rng.randint(0, 256, 77).astype("u1")
                     .tobytes()),
        "pcm24": riff(1, 1, 24, b24.astype("u1").tobytes()),
        "pcm24_stereo": riff(1, 2, 24, b24.astype("u1").tobytes()),
        "pcm32": riff(1, 1, 32, rng.randint(-2**31, 2**31, 40)
                      .astype("<i4").tobytes()),
        "float32": riff(3, 1, 32, rng.uniform(-1, 1, 64).astype("<f4")
                        .tobytes()),
        "float64_stereo": riff(3, 2, 64, rng.uniform(-1, 1, 64)
                               .astype("<f8").tobytes(), rate=8000),
        "odd_data_size": riff(1, 1, 16, i16[0].tobytes() + b"\x01"),
    }


@pytest.mark.parametrize("case", sorted(wav_cases()))
def test_parse_wav_equal(case):
    raw = wav_cases()[case]
    a, b = jw.parse_wav(raw), tw.parse_wav(raw)
    assert a.samp_freq == b.samp_freq and a.duration == b.duration
    assert a.data.dtype == b.data.dtype == np.float32
    assert np.array_equal(a.data, b.data)
    for c in range(a.data.shape[0]):
        assert np.array_equal(a.channel(c), b.channel(c))
    with pytest.raises(ValueError):
        b.channel(a.data.shape[0])
    if case == "pcm24":
        assert b.data.min() < 0 < b.data.max()


@pytest.mark.parametrize("raw", [b"RIFF....JUNK", b"RIFX" + b"\0" * 8
                                 + b"WAVE", riff(2, 1, 16, b"\0\0"),
                                 riff(1, 1, 12, b"\0\0")])
def test_parse_wav_refusals(raw):
    for pkg in (jw, tw):
        with pytest.raises(ValueError) as e:
            pkg.parse_wav(raw)
        msg = str(e.value)
    with pytest.raises(ValueError) as e:
        jw.parse_wav(raw)
    assert str(e.value) == msg


@pytest.mark.parametrize("shape", [(1000,), (2, 300), (3, 17)])
def test_wav_bytes_and_write_wav(tmp_path, shape):
    x = np.random.RandomState(1).randn(*shape) * 40000  # clips at int16
    assert tw.wav_bytes(16000, x) == jw.wav_bytes(16000, x)
    tw.write_wav(str(tmp_path / "t.wav"), 8000.0, x)
    jw.write_wav(str(tmp_path / "j.wav"), 8000.0, x)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    a, b = jw.read_wav(str(tmp_path / "j.wav")), tw.read_wav(
        str(tmp_path / "t.wav"))
    assert np.array_equal(a.data, b.data)
    with open(tmp_path / "t.wav", "rb") as f:
        assert np.array_equal(tw.read_wav(f).data, b.data)


def test_wave_tables_equal(tmp_path):
    """WaveWriter arks (with and without scp) byte-equal; both readers
    over ark:, scp: offsets, wav paths and a `cmd |` entry give the
    same keys and arrays; read_wav_record stops at the record's end."""
    rng = np.random.RandomState(3)
    recs = {f"r{i}": (8000.0 * (1 + i % 2),
                      rng.randint(-3000, 3000, (1 + i % 2, 300 + 41 * i))
                      .astype(np.float32)) for i in range(4)}
    for pkg, tag in ((jw, "j"), (tw, "t")):
        with pkg.WaveWriter(f"ark,scp:{tmp_path}/{tag}.ark,"
                            f"{tmp_path}/{tag}.scp") as w:
            for k, (fs, x) in recs.items():
                w.write(k, fs, x)
        with pkg.WaveWriter(f"ark:{tmp_path}/{tag}2.ark") as w:
            for k, (fs, x) in recs.items():
                w.write(k, fs, x)
    assert (tmp_path / "t.ark").read_bytes() == \
        (tmp_path / "j.ark").read_bytes()
    assert (tmp_path / "t2.ark").read_bytes() == \
        (tmp_path / "t.ark").read_bytes()
    assert (tmp_path / "t.scp").read_text() == \
        (tmp_path / "j.scp").read_text().replace("/j.ark", "/t.ark")
    for k, (fs, x) in recs.items():
        tw.write_wav(str(tmp_path / f"{k}.wav"), fs, x)
    (tmp_path / "wav.scp").write_text(
        f"r0 cat {tmp_path}/r0.wav |\n\nr1 {tmp_path}/r1.wav\n"
        f"r2 {tmp_path}/r2.wav\n")
    for spec in (f"ark:{tmp_path}/t.ark", f"scp:{tmp_path}/t.scp",
                 f"scp:{tmp_path}/wav.scp",
                 f"ark:cat {tmp_path}/t.ark |"):
        a = [(k, w.samp_freq, w.data) for k, w in
             jw.SequentialWaveReader(spec)]
        b = [(k, w.samp_freq, w.data) for k, w in
             tw.SequentialWaveReader(spec)]
        assert [r[:2] for r in a] == [r[:2] for r in b] and len(b) >= 3
        assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
        for k, fs, x in b:
            assert fs == recs[k][0] and np.array_equal(x, recs[k][1])
        if spec.startswith("scp:"):
            assert len(tw.SequentialWaveReader(spec)) == len(b)
    with pytest.raises(TypeError):
        len(tw.SequentialWaveReader(f"ark:{tmp_path}/t.ark"))
    with pytest.raises(ValueError):
        tw.SequentialWaveReader(f"foo:{tmp_path}/t.ark")
    with pytest.raises(ValueError):
        tw.WaveWriter(f"ark,t:{tmp_path}/x.ark")
    import io
    two = tw.wav_bytes(8000, np.ones(10)) + tw.wav_bytes(8000, 2 * np.ones(5))
    s = io.BytesIO(two)
    assert tw.read_wav_record(s).data.shape == (1, 10)
    assert tw.read_wav_record(s).data[0, 0] == 2.0
    with pytest.raises(EOFError):
        tw.read_wav_record(io.BytesIO(two[:30]))


def test_front_end_modules_import_neither_torch_nor_jax():
    code = ("import sys\n"
            "import kaldi_lstm_tpu_torch.feats, kaldi_lstm_tpu_torch.io.wav\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'kaldi_lstm_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
