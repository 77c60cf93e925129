"""RIFF WAVE reading + wav.scp tables — the audio entry point for the
native feature extraction (feats/fbank.py).

Upstream Kaldi reads audio via `wav.scp` lines `key path-or-command|`
(wave-reader.cc). This covers the formats Kaldi itself accepts from
sox/standard corpora: PCM 8/16/24/32-bit, IEEE float32/64, any channel
count. Samples are returned at the raw int16-like scale upstream uses
(float data is scaled by 32768) so feature values match Kaldi's.

This package's copy of ``kaldi_lstm_tpu.io.wav``: host numpy, byte for
byte the same parsing and RIFF bytes; wav-ark tables go through the
port's own io/kaldi_io.py.
"""

from __future__ import annotations

import io
import struct
import subprocess
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import _open_rspecifier, _read_key


class WaveData:
    __slots__ = ("samp_freq", "data")

    def __init__(self, samp_freq: float, data: np.ndarray):
        self.samp_freq = samp_freq
        self.data = data            # [channels, samples] float32

    def channel(self, c: int = 0) -> np.ndarray:
        if not 0 <= c < self.data.shape[0]:
            raise ValueError(f"channel {c} of {self.data.shape[0]}")
        return self.data[c]

    @property
    def duration(self) -> float:
        return self.data.shape[1] / self.samp_freq


def _read_chunks(b: bytes):
    if len(b) < 12 or b[:4] not in (b"RIFF", b"RIFX") or b[8:12] != b"WAVE":
        raise ValueError("not a RIFF WAVE file")
    if b[:4] == b"RIFX":
        raise ValueError("big-endian RIFX wav not supported")
    pos = 12
    while pos + 8 <= len(b):
        cid = b[pos:pos + 4]
        (size,) = struct.unpack_from("<I", b, pos + 4)
        body = b[pos + 8: pos + 8 + size]
        yield cid, body
        pos += 8 + size + (size & 1)


def parse_wav(raw: bytes) -> WaveData:
    fmt = None
    data = None
    for cid, body in _read_chunks(raw):
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
            # some writers lie about the data size when streaming; the
            # chunk walker already clamps to the buffer
    if fmt is None or data is None:
        raise ValueError("wav missing fmt/data chunk")
    (audio_format, channels, samp_freq, _brate, block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        (audio_format,) = struct.unpack_from("<H", fmt, 24)
    if channels < 1 or block_align != channels * (bits // 8):
        raise ValueError(f"bad wav header: channels={channels} "
                         f"block_align={block_align} bits={bits}")
    n = len(data) // block_align
    data = data[:n * block_align]
    if audio_format == 1:       # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32)
        elif bits == 8:         # unsigned, offset binary
            x = (np.frombuffer(data, "u1").astype(np.float32)
                 - 128.0) * 256.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 65536.0
        elif bits == 24:
            a = np.frombuffer(data, "u1").reshape(-1, 3)
            x = ((a[:, 0].astype(np.int32))
                 | (a[:, 1].astype(np.int32) << 8)
                 | (a[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x)
            x = x.astype(np.float32) / 256.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:     # IEEE float; Kaldi scales to int16 range
        dt = "<f4" if bits == 32 else "<f8"
        x = (np.frombuffer(data, dt) * 32768.0).astype(np.float32)
    else:
        raise ValueError(f"unsupported wav format tag {audio_format}")
    return WaveData(float(samp_freq),
                    x.reshape(-1, channels).T.copy())


def read_wav(path_or_stream) -> WaveData:
    if isinstance(path_or_stream, (str, bytes)):
        with open(path_or_stream, "rb") as f:
            return parse_wav(f.read())
    return parse_wav(path_or_stream.read())


def read_wav_record(stream) -> WaveData:
    """Read ONE RIFF wave from a stream that may hold further records
    (wav-ark values): the RIFF header's size field bounds the read."""
    head = stream.read(8)
    if len(head) < 8:
        raise EOFError("truncated wav record")
    if head[:4] != b"RIFF":
        raise ValueError("wav record does not start with RIFF")
    (size,) = struct.unpack_from("<I", head, 4)
    body = stream.read(size)
    if len(body) < size:
        raise EOFError("truncated wav record body")
    return parse_wav(head + body)


def wav_bytes(samp_freq: float, data: np.ndarray) -> bytes:
    """PCM16 RIFF encoding of [samples] or [channels, samples] int16-scale
    data (the WaveData wire form, upstream wave-reader.h WaveData::Write)."""
    x = np.asarray(data)
    if x.ndim == 1:
        x = x[None, :]
    pcm = np.clip(np.round(x.T), -32768, 32767).astype("<i2").tobytes()
    ch, n = x.shape[0], x.shape[1]
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                      b"WAVE", b"fmt ", 16, 1, ch, int(samp_freq),
                      int(samp_freq) * ch * 2, ch * 2, 16, b"data",
                      len(pcm))
    return hdr + pcm


class WaveWriter:
    """`ark[,scp]:` writer of wave records — upstream WaveHolder tables
    (binary-only: the value is the raw RIFF stream, no \\0B marker;
    util/kaldi-holder-inl.h WaveHolder). Lets extract-segments pipe into
    compute-fbank-feats exactly like upstream featbin."""

    def __init__(self, wspecifier: str):
        import os
        kind, rest = wspecifier.split(":", 1)
        opts = kind.split(",")
        if opts[0] != "ark" or "t" in opts:
            raise ValueError("wave tables are binary ark only, got "
                             f"{wspecifier!r}")
        self.scp = None
        if "scp" in opts:
            ark_path, scp_path = rest.split(",", 1)
            self.ark = open(ark_path, "wb")
            self.scp = open(scp_path, "w")
            self.ark_path = os.path.abspath(ark_path)
        else:
            self.ark = sys.stdout.buffer if rest == "-" else open(rest, "wb")
            self.ark_path = rest

    def write(self, key: str, samp_freq: float, data: np.ndarray) -> None:
        self.ark.write(key.encode() + b" ")
        if self.scp is not None:
            self.scp.write(f"{key} {self.ark_path}:{self.ark.tell()}\n")
        self.ark.write(wav_bytes(samp_freq, data))

    def close(self) -> None:
        if self.ark is not sys.stdout.buffer:
            self.ark.close()
        if self.scp is not None:
            self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_wav(path, samp_freq: float, data: np.ndarray) -> None:
    """PCM16 writer (test fixtures / synthetic corpora). `data` is
    [samples] or [channels, samples] in int16 scale."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samp_freq, data))


class SequentialWaveReader:
    """Iterate (key, WaveData) over `scp:wav.scp` — lines
    `key path` or `key command ... |` (upstream wav.scp semantics) —
    or over `ark:` wave tables (key + raw RIFF records, upstream
    WaveHolder; supports files, `-` and trailing-`|` pipes) so
    `extract-segments ... ark:- | compute-fbank-feats ark:-` works."""

    def __init__(self, rspecifier: str):
        kind, rest = rspecifier.split(":", 1)
        self.kind = kind.split(",")[0]
        if self.kind not in ("scp", "ark"):
            raise ValueError("wave reading expects scp:/ark:, got "
                             f"{rspecifier!r}")
        if self.kind == "ark":
            self._lines = None
            _, self._stream = _open_rspecifier(rspecifier)
            return
        self._lines = []
        stream = (sys.stdin if rest == "-"
                  else open(rest, "r", encoding="utf-8"))
        with stream if rest != "-" else io.StringIO(stream.read()) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, val = line.split(None, 1)
                self._lines.append((key, val))

    def __iter__(self):
        if self._lines is None:
            while True:
                key = _read_key(self._stream)
                if key is None:
                    return
                yield key, read_wav_record(self._stream)
        for key, val in self._lines:
            if val.endswith("|"):
                out = subprocess.run(val[:-1], shell=True, check=True,
                                     stdout=subprocess.PIPE).stdout
                yield key, parse_wav(out)
            else:
                path, _, off = val.rpartition(":")
                if path and off.isdigit():  # wav-ark scp offsets
                    with open(path, "rb") as f:
                        f.seek(int(off))
                        yield key, read_wav_record(f)
                else:
                    yield key, read_wav(val)

    def __len__(self):
        if self._lines is None:
            raise TypeError("ark wave tables have no known length")
        return len(self._lines)
