"""Kaldi-format table I/O: binary/text tokens, matrices, vectors and
ark/scp readers — the part of ``kaldi_lstm_tpu.io.kaldi_io`` that model
files and acoustic-model scoring need, carried as this package's own
copy. Formats follow the Kaldi wire conventions so models and features
interoperate with the JAX package and with upstream Kaldi:

* binary streams start with the two bytes ``\\0B``;
* tokens are space-terminated ASCII words (``<CellDim> ``);
* basic types are written as a size byte then little-endian payload;
* float matrices are ``FM `` + int32 rows + int32 cols + row-major f32;
  compressed feature matrices (``CM``/``CM2``/``CM3``) are read;
* float vectors are ``FV `` + int32 dim + f32 data;
* posteriors are int32 frames, then per frame int32 n and n (int32
  pdf-id, f32 weight) pairs (text: ``[ id w id w ] [ ... ]``).

rspecifiers understood: ``ark:file``, ``scp:file``, ``ark:-`` (stdin),
and trailing-``|`` command pipes (``ark:gunzip -c f.gz |``).
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
import sys
import warnings
from typing import Iterator, List, Tuple

import numpy as np

BINARY_HEADER = b"\0B"

# per frame a list of (pdf-id, weight) pairs
Posterior = List[List[Tuple[int, float]]]


def _probe_binary_header(stream) -> tuple[bool, object]:
    """Detect the \\0B binary marker at the stream position, consuming it
    when present. Returns (is_binary, stream-to-continue-reading-from).
    BufferedReader.peek returns only the CURRENT buffer contents when
    non-empty, so a 1-byte buffer tail is handled by consuming the byte
    and splicing it back logically — otherwise a binary record whose
    marker straddles the buffer boundary is misdetected as text."""
    if not hasattr(stream, "peek"):
        head = stream.read(2)
        if head == BINARY_HEADER:
            return True, stream
        return False, _ChainedStream(head, stream)
    head = stream.peek(2)[:2]
    if len(head) == 1:
        b0 = stream.read(1)
        if b0 == BINARY_HEADER[:1] and stream.peek(1)[:1] == \
                BINARY_HEADER[1:2]:
            stream.read(1)
            return True, stream
        # raw chained pushback (NOT a fresh BufferedReader: its
        # read-ahead would swallow bytes of the following records)
        return False, _ChainedStream(b0, stream)
    if head == BINARY_HEADER:
        stream.read(2)
        return True, stream
    return False, stream


class KaldiInput:
    """Wraps a readable binary stream; detects binary vs text mode."""

    def __init__(self, stream, binary: bool | None = None):
        self.stream = stream
        if binary is None:
            self.binary, self.stream = _probe_binary_header(stream)
        else:
            self.binary = binary

    def read(self, n: int) -> bytes:
        return self.stream.read(n)


class _ChainedStream(io.RawIOBase):
    def __init__(self, head: bytes, rest):
        self.head = head
        self.rest = rest

    def readable(self):
        return True

    def readinto(self, b):
        if self.head:
            n = min(len(b), len(self.head))
            b[:n] = self.head[:n]
            self.head = self.head[n:]
            return n
        data = self.rest.read(len(b))
        if not data:
            return 0
        b[:len(data)] = data
        return len(data)


class KaldiOutput:
    def __init__(self, stream, binary: bool = True, write_header: bool = True):
        self.stream = stream
        self.binary = binary
        if binary and write_header:
            stream.write(BINARY_HEADER)


# ---------------------------------------------------------------------------
# token / basic-type primitives
# ---------------------------------------------------------------------------

def write_token(out: KaldiOutput, token: str) -> None:
    out.stream.write(token.encode() + b" ")


def read_token(inp: KaldiInput) -> str:
    """Read a space/newline-delimited token, skipping leading whitespace."""
    chars = []
    while True:
        c = inp.read(1)
        if not c:
            if chars:
                break
            raise EOFError("read_token: end of stream")
        if c.isspace():
            if chars:
                break
            continue
        chars.append(c)
    return b"".join(chars).decode()


def peek_token(stream) -> str:
    """Peek the next token of a buffered stream without consuming it."""
    buf = stream.peek(64)
    i = 0
    while i < len(buf) and buf[i:i + 1].isspace():
        i += 1
    j = i
    while j < len(buf) and not buf[j:j + 1].isspace():
        j += 1
    return buf[i:j].decode(errors="replace")


def _read_until_bracket(inp: KaldiInput) -> bytes:
    """Consume and return everything up to (excluding) the next ']',
    consuming the ']' too. Uses buffered peeking when available — large
    text matrices (16k x 512 senone layers) make byte-at-a-time reads
    prohibitively slow."""
    stream = inp.stream
    peek = getattr(stream, "peek", None)
    chunks = []
    if peek is not None:
        while True:
            buf = peek(65536)
            if not buf:
                raise EOFError("unterminated '[ ... ]' block")
            idx = buf.find(b"]")
            if idx >= 0:
                chunks.append(stream.read(idx))
                stream.read(1)
                return b"".join(chunks)
            chunks.append(stream.read(len(buf)))
    while True:
        c = stream.read(1)
        if not c:
            raise EOFError("unterminated '[ ... ]' block")
        if c == b"]":
            return b"".join(chunks)
        chunks.append(c)


def _parse_floats(body: bytes) -> np.ndarray:
    """Whitespace-separated ascii floats -> float32 array, via numpy's C
    parser (str.split on a 50 MB senone matrix costs tens of seconds)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return np.fromstring(body, dtype=np.float32, sep=" ")
    except ValueError:
        return np.array(body.split(), np.float32)


def write_int32(out: KaldiOutput, value: int) -> None:
    if out.binary:
        out.stream.write(b"\x04" + struct.pack("<i", value))
    else:
        out.stream.write(f"{value} ".encode())


def read_int32(inp: KaldiInput) -> int:
    if inp.binary:
        size = inp.read(1)
        if size != b"\x04":
            raise ValueError(f"read_int32: bad size marker {size!r}")
        return struct.unpack("<i", inp.read(4))[0]
    return int(read_token(inp))


def write_float(out: KaldiOutput, value: float) -> None:
    if out.binary:
        out.stream.write(b"\x04" + struct.pack("<f", value))
    else:
        out.stream.write(f"{value:.7g} ".encode())


def read_float(inp: KaldiInput) -> float:
    if inp.binary:
        size = inp.read(1)
        if size != b"\x04":
            raise ValueError(f"read_float: bad size marker {size!r}")
        return struct.unpack("<f", inp.read(4))[0]
    return float(read_token(inp))


# ---------------------------------------------------------------------------
# matrices / vectors
# ---------------------------------------------------------------------------

def write_matrix(out: KaldiOutput, mat: np.ndarray) -> None:
    # float64 input keeps double precision on the wire ("DM", the
    # format of upstream CMVN stats); everything else goes out as "FM"
    mat = np.asarray(mat)
    mat = mat.astype(np.float64 if mat.dtype == np.float64
                     else np.float32, copy=False)
    if mat.ndim != 2:
        raise ValueError(f"write_matrix: expected 2-D, got {mat.shape}")
    if out.binary:
        write_token(out, "DM" if mat.dtype == np.float64 else "FM")
        write_int32(out, mat.shape[0])
        write_int32(out, mat.shape[1])
        out.stream.write(np.ascontiguousarray(mat).tobytes())
    else:
        out.stream.write(b" [\n")
        # np.savetxt formats at C speed — a per-element Python loop is
        # minutes on 16k x 512 senone layers
        np.savetxt(out.stream, mat, fmt="%.7g", delimiter=" ")
        out.stream.write(b"]\n")


def read_matrix(inp: KaldiInput) -> np.ndarray:
    if inp.binary:
        token = read_token(inp)
        if token in ("CM", "CM2", "CM3"):
            return read_compressed_matrix(inp, token)
        if token == "FM":
            dt = np.float32
        elif token == "DM":
            dt = np.float64
        else:
            raise ValueError(
                f"read_matrix: expected FM/DM/CM*, got {token!r}")
        rows = read_int32(inp)
        cols = read_int32(inp)
        data = inp.read(rows * cols * np.dtype(dt).itemsize)
        if len(data) != rows * cols * np.dtype(dt).itemsize:
            raise EOFError(f"read_matrix: truncated {rows}x{cols} payload")
        return np.frombuffer(data, dt).reshape(rows, cols)
    # text: " [ \n r0c0 r0c1 \n r1c0 ... ]" — accumulate to the closing
    # bracket, then split physical lines into rows.
    tok = read_token(inp)
    if tok != "[":
        raise ValueError(f"read_matrix(text): expected '[', got {tok!r}")
    body = _read_until_bracket(inp)
    stripped = body.lstrip()
    nl = stripped.find(b"\n")
    first_line = stripped if nl < 0 else stripped[:nl]
    ncols = len(first_line.split())
    flat = _parse_floats(body)
    return flat.reshape(-1, ncols)


# -- compressed matrices (upstream matrix/compressed-matrix.{h,cc}) ---------
# Real Kaldi feature arks are usually written --compress=true; after the
# "CM"/"CM2"/"CM3" token comes a global header (f32 min_value, f32 range,
# i32 num_rows, i32 num_cols), then:
#   CM  — per-column {4x uint16 percentiles} headers, uint8 data
#         column-major, piecewise-linear in 3 segments (0-64-192-255);
#   CM2 — uint16 data row-major, linear min+range*v/65535;
#   CM3 — uint8 data row-major, linear min+range*v/255.

def read_compressed_matrix(inp: KaldiInput, token: str) -> np.ndarray:
    hdr = inp.read(16)
    if len(hdr) != 16:
        raise ValueError("read_compressed_matrix: truncated header")
    min_value, rng = struct.unpack("<ff", hdr[:8])
    rows, cols = struct.unpack("<ii", hdr[8:16])
    if rows < 0 or cols < 0:
        raise ValueError(f"read_compressed_matrix: bad dims {rows}x{cols}")
    if token == "CM2":
        data = np.frombuffer(inp.read(rows * cols * 2), "<u2")
        return (min_value + rng * (1.0 / 65535.0)
                * data.astype(np.float32)).reshape(rows, cols)
    if token == "CM3":
        data = np.frombuffer(inp.read(rows * cols), np.uint8)
        return (min_value + rng * (1.0 / 255.0)
                * data.astype(np.float32)).reshape(rows, cols)
    # CM: per-column percentile headers then column-major bytes
    pch = np.frombuffer(inp.read(cols * 8), "<u2").reshape(cols, 4)
    p = min_value + rng * (1.0 / 65535.0) * pch.astype(np.float32)
    data = np.frombuffer(inp.read(rows * cols),
                         np.uint8).reshape(cols, rows)
    v = data.astype(np.float32)
    p0, p25, p75, p100 = (p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4])
    lo = p0 + (p25 - p0) * (v * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((v - 64.0) * (1.0 / 128.0))
    hi = p75 + (p100 - p75) * ((v - 192.0) * (1.0 / 63.0))
    out = np.where(v <= 64, lo, np.where(v <= 192, mid, hi))
    return np.ascontiguousarray(out.T)


def write_vector(out: KaldiOutput, vec: np.ndarray) -> None:
    vec = np.asarray(vec, np.float32).reshape(-1)
    if out.binary:
        write_token(out, "FV")
        write_int32(out, vec.shape[0])
        out.stream.write(np.ascontiguousarray(vec).tobytes())
    else:
        out.stream.write(b" [ " + " ".join(
            np.char.mod("%.7g", vec)).encode() + b" ]\n")


def read_vector(inp: KaldiInput) -> np.ndarray:
    if inp.binary:
        token = read_token(inp)
        if token == "FV":
            dt = np.float32
        elif token == "DV":
            dt = np.float64
        else:
            raise ValueError(f"read_vector: expected FV/DV, got {token!r}")
        dim = read_int32(inp)
        data = inp.read(dim * np.dtype(dt).itemsize)
        if len(data) != dim * np.dtype(dt).itemsize:
            raise EOFError(f"read_vector: truncated {dim}-dim payload")
        return np.frombuffer(data, dt).astype(np.float32)
    tok = read_token(inp)
    if tok != "[":
        raise ValueError(f"read_vector(text): expected '[', got {tok!r}")
    return _parse_floats(_read_until_bracket(inp))


def write_int_vector(out: KaldiOutput, vec) -> None:
    """Kaldi integer vector — upstream WriteIntegerVector: ONE
    element-size byte (\\x04), the int32 count, then the RAW int32
    payload (no per-element size markers)."""
    vec = np.asarray(vec, np.int32).reshape(-1)
    if out.binary:
        out.stream.write(b"\x04" + struct.pack("<i", len(vec))
                         + vec.astype("<i4").tobytes())
    else:
        out.stream.write(" ".join(str(int(v)) for v in vec).encode()
                         + b"\n")


def read_int_vector(inp: KaldiInput) -> np.ndarray:
    if inp.binary:
        sz = inp.read(1)
        if sz != b"\x04":
            raise ValueError(f"read_int_vector: bad element-size byte "
                             f"{sz!r}")
        hdr = inp.read(4)
        if len(hdr) != 4:
            raise EOFError("read_int_vector: truncated size")
        (n,) = struct.unpack("<i", hdr)
        if n < 0:
            raise ValueError(f"read_int_vector: negative size {n}")
        data = inp.read(4 * n)
        if len(data) != 4 * n:
            raise EOFError("read_int_vector: truncated payload")
        return np.frombuffer(data, "<i4").astype(np.int32)
    # text: rest of line
    chars = []
    while True:
        c = inp.read(1)
        if not c or c == b"\n":
            break
        chars.append(c)
    return np.array(b"".join(chars).split(), np.int32)


# ---------------------------------------------------------------------------
# posteriors
# ---------------------------------------------------------------------------

def write_posterior(out: KaldiOutput, post: Posterior) -> None:
    if out.binary:
        write_int32(out, len(post))
        for frame in post:
            write_int32(out, len(frame))
            for pdf, weight in frame:
                write_int32(out, int(pdf))
                write_float(out, float(weight))
    else:
        for frame in post:
            out.stream.write(b"[ ")
            for pdf, weight in frame:
                out.stream.write(f"{int(pdf)} {weight:.7g} ".encode())
            out.stream.write(b"] ")
        out.stream.write(b"\n")


def read_posterior(inp: KaldiInput) -> Posterior:
    if inp.binary:
        nframes = read_int32(inp)
        post: Posterior = []
        for _ in range(nframes):
            n = read_int32(inp)
            frame = []
            for _ in range(n):
                pdf = read_int32(inp)
                weight = read_float(inp)
                frame.append((pdf, weight))
            post.append(frame)
        return post
    # text: "[ id w id w ] [ ... ] \n"
    post = []
    while True:
        tok = read_token(inp)
        if tok != "[":
            raise ValueError(f"read_posterior(text): expected '[', got {tok!r}")
        frame = []
        while True:
            tok = read_token(inp)
            if tok == "]":
                break
            frame.append((int(tok), float(read_token(inp))))
        post.append(frame)
        # peek for the record's newline or the next frame; never wrap the
        # shared table stream in a new BufferedReader (its read-ahead
        # would swallow the next records)
        peek = getattr(inp.stream, "peek", None)
        if peek is None:  # unbuffered source: push the byte back
            c = inp.read(1)
            while c and c in b" \t":
                c = inp.read(1)
            if not c or c == b"\n":
                return post
            if c != b"[":
                raise ValueError("read_posterior(text): malformed")
            inp.stream = _ChainedStream(b"[", inp.stream)
            continue
        while True:
            c = peek(1)[:1]
            if c in (b" ", b"\t"):
                inp.read(1)
                continue
            break
        if not c or c == b"\n":
            if c:
                inp.read(1)  # consume the record's newline
            return post
        if c != b"[":
            raise ValueError("read_posterior(text): malformed")


# ---------------------------------------------------------------------------
# rspecifiers / wspecifiers and table readers/writers
# ---------------------------------------------------------------------------

class _PipeRaw(io.RawIOBase):
    """Raw stream over a pipe command that verifies the exit status at
    EOF — upstream Kaldi aborts on nonzero pipe status; silently reading
    a failed `cmd |` as an empty table would truncate the data."""

    def __init__(self, proc, cmd: str):
        self.proc = proc
        self.cmd = cmd
        self._checked = False

    def readable(self):
        return True

    def readinto(self, b):
        n = self.proc.stdout.readinto(b)
        if not n and not self._checked:
            self._checked = True
            rc = self.proc.wait()
            if rc != 0:
                raise IOError(f"pipe command failed with status {rc}: "
                              f"{self.cmd!r}")
        return n or 0


def _open_rspecifier(spec: str):
    """Open the data source of an rspecifier. Returns (kind, stream)."""
    if ":" not in spec:
        raise ValueError(f"bad rspecifier {spec!r}")
    kind, rest = spec.split(":", 1)
    # strip read options like ark,t:
    kind = kind.split(",")[0]
    if kind not in ("ark", "scp"):
        raise ValueError(f"unsupported rspecifier kind {kind!r}")
    if rest.endswith("|"):
        cmd = rest[:-1]
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        return kind, io.BufferedReader(_PipeRaw(proc, cmd))
    if rest == "-":
        return kind, sys.stdin.buffer
    return kind, open(rest, "rb")


def _read_key(stream) -> str | None:
    """Read the whitespace-terminated utterance key, or None at EOF."""
    chars = []
    while True:
        c = stream.read(1)
        if not c:
            if not chars:
                return None
            break
        if c.isspace():
            if chars:
                break
            continue
        chars.append(c)
    try:
        return b"".join(chars).decode()
    except UnicodeDecodeError as e:
        # binary payload where a key was expected: a reader/table
        # mismatch or a truncated/misaligned ark
        raise ValueError(
            f"bad utterance key {b''.join(chars)[:32]!r}: not a Kaldi "
            f"table of this kind, or the stream is misaligned") from e


def _read_value_header(stream) -> KaldiInput:
    """After the key comes one space then \\0B (binary) or text data."""
    is_binary, stream = _probe_binary_header(stream)
    return KaldiInput(stream, binary=is_binary)


def _split_offset(rxfilename: str):
    if ":" in rxfilename:
        path, _, off = rxfilename.rpartition(":")
        if off.isdigit():
            return path, int(off)
    return rxfilename, None


def read_matrix_from_rxfilename(rxfilename: str) -> np.ndarray:
    path, offset = _split_offset(rxfilename)
    with open(path, "rb") as f:
        if offset is not None:
            f.seek(offset)
        return read_matrix(KaldiInput(f))


class SequentialMatrixReader:
    """Sequential reader over `ark:`/`scp:` float-matrix tables (the
    feature source of the scoring tools)."""

    def __init__(self, rspecifier: str):
        self.kind, self.stream = _open_rspecifier(rspecifier)

    def __iter__(self) -> Iterator[tuple[str, np.ndarray]]:
        if self.kind == "ark":
            stream = self.stream \
                if isinstance(self.stream, io.BufferedReader) \
                else io.BufferedReader(self.stream)
            while True:
                key = _read_key(stream)
                if key is None:
                    return
                yield key, read_matrix(_read_value_header(stream))
        else:  # scp: "key path[:offset]" lines
            for line in io.TextIOWrapper(self.stream):
                line = line.strip()
                if not line:
                    continue
                key, rxf = line.split(None, 1)
                yield key, read_matrix_from_rxfilename(rxf)


def check_output_path(path: str, what: str = "output file") -> str:
    """Refuse to CREATE a file whose name looks like a CLI flag (a
    mis-parsed argv once wrote a model to a flag-named file). `-`
    (stdout) stays valid, and the explicit escape hatch is a `./`
    prefix."""
    if path.startswith("-") and path != "-":
        raise ValueError(
            f"{what} {path!r} looks like a command-line flag, refusing to "
            f"write it (use {'./' + path!r} if you really mean a file "
            f"with that name)")
    return path


class TableWriter:
    """Write `key value` records to an ark (and optional scp index)."""

    def __init__(self, wspecifier: str, write_fn, binary: bool = True):
        # wspecifier: "ark:file", "ark,scp:arkfile,scpfile", "ark,t:file"
        kind, rest = wspecifier.split(":", 1)
        opts = kind.split(",")
        self.binary = binary and "t" not in opts
        self.write_fn = write_fn
        self.scp = None
        if "scp" in opts:
            ark_path, scp_path = rest.split(",", 1)
            check_output_path(ark_path, "ark")
            check_output_path(scp_path, "scp")
            self.ark = open(ark_path, "wb")
            self.scp = open(scp_path, "w")
            self.ark_path = os.path.abspath(ark_path)
        else:
            check_output_path(rest, "ark")
            self.ark = sys.stdout.buffer if rest == "-" else open(rest, "wb")
            self.ark_path = rest

    def write(self, key: str, value) -> None:
        self.ark.write(key.encode() + b" ")
        if self.scp is not None:  # stdout/pipes are unseekable
            self.scp.write(f"{key} {self.ark_path}:{self.ark.tell()}\n")
        self.write_fn(KaldiOutput(self.ark, binary=self.binary), value)

    def close(self) -> None:
        if self.ark is not sys.stdout.buffer:
            self.ark.close()
        if self.scp is not None:
            self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def MatrixWriter(wspecifier: str) -> TableWriter:
    return TableWriter(wspecifier, write_matrix)


def PosteriorWriter(wspecifier: str) -> TableWriter:
    return TableWriter(wspecifier, write_posterior)


def _buffered(stream) -> io.BufferedReader:
    return stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)


class SequentialPosteriorReader:
    """Sequential (key, Posterior) iteration over `ark:` posterior tables
    (files, `-`, trailing-`|` pipes)."""

    def __init__(self, rspecifier: str):
        kind, stream = _open_rspecifier(rspecifier)
        if kind != "ark":
            raise ValueError("sequential posterior reading expects ark:, "
                             f"got {rspecifier!r}")
        self._stream = _buffered(stream)

    def __iter__(self) -> Iterator[tuple[str, Posterior]]:
        while True:
            key = _read_key(self._stream)
            if key is None:
                return
            yield key, read_posterior(_read_value_header(self._stream))


class RandomAccessPosteriorReader:
    """Random-access posterior reader: an `ark:` table is read whole into
    memory (an epoch's targets fit on the host); `scp:` values are read
    lazily by offset. `max_entries` is the sparse-target width Kmax that
    `value_dense` defaults to."""

    def __init__(self, rspecifier: str, max_entries: int = 1):
        self.kind, stream = _open_rspecifier(rspecifier)
        self.max_entries = max_entries
        self._table: dict[str, Posterior] = {}
        self._scp: dict[str, str] = {}
        if self.kind == "ark":
            buffered = _buffered(stream)
            while True:
                key = _read_key(buffered)
                if key is None:
                    break
                self._table[key] = read_posterior(_read_value_header(buffered))
            if buffered is not sys.stdin.buffer:
                buffered.close()
        else:
            with io.TextIOWrapper(stream) as lines:
                for line in lines:
                    line = line.strip()
                    if line:
                        key, path = line.split(None, 1)
                        self._scp[key] = path

    def has_key(self, key: str) -> bool:
        return key in self._table or key in self._scp

    def value(self, key: str) -> Posterior:
        if key in self._table:
            return self._table[key]
        path, offset = _split_offset(self._scp[key])
        with open(path, "rb") as f:
            if offset is not None:
                f.seek(offset)
            return read_posterior(KaldiInput(io.BufferedReader(
                io.FileIO(f.fileno(), closefd=False))))

    def value_dense(self, key: str, max_entries: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Targets as ([T, Kmax] int32 ids, [T, Kmax] float32 weights);
        entries past Kmax are dropped, missing ones have weight 0."""
        k = self.max_entries if max_entries is None else max_entries
        post = self.value(key)
        ids = np.zeros((len(post), k), np.int32)
        w = np.zeros((len(post), k), np.float32)
        for t, frame in enumerate(post):
            for j, (pdf, weight) in enumerate(frame[:k]):
                ids[t, j] = pdf
                w[t, j] = weight
        return ids, w


def read_float_vectors(rspecifier: str) -> dict[str, np.ndarray]:
    """Read a whole float-vector table (`ark:`) into a dict, e.g. the
    per-frame weights of `--frame-weights`."""
    kind, stream = _open_rspecifier(rspecifier)
    if kind != "ark":
        raise ValueError("float-vector tables: only ark: supported")
    buffered = _buffered(stream)
    out = {}
    while True:
        key = _read_key(buffered)
        if key is None:
            break
        out[key] = read_vector(_read_value_header(buffered))
    return out
