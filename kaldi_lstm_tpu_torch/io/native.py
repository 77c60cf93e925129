"""ctypes bindings to the two native host libraries: the decoder core
(``csrc/kltdecode.cc``, the decoder half of ``kaldi_lstm_tpu.io.native``)
and the I/O library (``csrc/kltio.cc``, its I/O half: the zero-copy ark
scans and the one-call batch fill of the stream scheduler).

Each library is host code, built at first use with ``g++ -O3 -fPIC
-std=c++17 -shared`` (``CXX`` names another compiler) into
``kaldi_lstm_tpu_torch/_build/``, which ``.gitignore`` lists. The
library's file name carries a hash of the source and the flags, so an
edit rebuilds it; a build is written to a temporary name and renamed
into place under a file lock, so concurrent processes neither race the
compiler nor load a half-written library.

There is no fallback: a library that fails to build or load raises
RuntimeError naming the compiler's or the loader's error. The numpy
decoders in decode/faster.py, decode/lattice_faster.py and
decode/online.py run only when asked for with ``KLT_DECODE_IMPL=python``;
the I/O functions have no numpy twin in the readers (io/kaldi_io.py reads
a table in Python only when its format is one the scan does not parse,
such as a text ark, a pipe or a compressed matrix).

ctypes releases the GIL for the length of each call, so decoder threads
(``--num-threads``) search in parallel while the main thread feeds the
card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import mmap
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "kltdecode.cc")
IO_SOURCE = os.path.join(_PKG_DIR, "csrc", "kltio.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_IO_LIB: ctypes.CDLL | None = None

# what each library is called in an error, and what its failure means
_ROLE = {
    "kltdecode": ("native decoder core",
                  "the decoders need g++; they do not fall back to numpy, "
                  "KLT_DECODE_IMPL=python asks for the numpy decoders"),
    "kltio": ("native I/O library",
              "the ark scans and the batch fill need g++; they do not "
              "fall back to Python"),
}


def _stem(source: str) -> str:
    return os.path.splitext(os.path.basename(source))[0]


def lib_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Where the library built from `source` lives: named by the
    source's stem and a hash of its bytes and the flags."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir,
                        f"lib{_stem(source)}.{h.hexdigest()[:16]}.so")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = lib_path(source, build_dir)
    if os.path.exists(path):
        return path
    what, need = _ROLE.get(_stem(source), ("native library", "it needs g++"))
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, f"{_stem(source)}.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):          # another process built it
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", tmp, source]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(
                f"{what}: could not run {' '.join(cmd)}: {e} "
                f"({need})") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"{what}: {' '.join(cmd)} failed (exit "
                f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return path


def _load(source: str) -> ctypes.CDLL:
    path = build(source, BUILD_DIR)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        what = _ROLE.get(_stem(source), ("native library",))[0]
        raise RuntimeError(f"{what}: cannot load {path}: {e}") from e


def get_lib() -> ctypes.CDLL:
    """The loaded decoder core, built first if needed (see module
    docstring); raises RuntimeError when it cannot be built or loaded."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            lib = _load(SOURCE)
            _declare(lib)
            _LIB = lib
        return _LIB


def get_io_lib() -> ctypes.CDLL:
    """The loaded I/O library (``csrc/kltio.cc``), built first if needed;
    raises RuntimeError when it cannot be built or loaded."""
    global _IO_LIB
    lib = _IO_LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _IO_LIB is None:
            lib = _load(IO_SOURCE)
            _declare_io(lib)
            _IO_LIB = lib
        return _IO_LIB


def _declare_io(lib: ctypes.CDLL) -> None:
    L = ctypes.c_long
    I = ctypes.c_int  # noqa: E741
    PL = ctypes.POINTER(L)
    PI = ctypes.POINTER(I)
    PF = ctypes.POINTER(ctypes.c_float)
    P64 = ctypes.POINTER(ctypes.c_int64)
    lib.klt_scan_matrix_ark.restype = L
    lib.klt_scan_matrix_ark.argtypes = [
        ctypes.c_void_p, L, L, PL, PI, PL, PI, PI]
    lib.klt_scan_posterior_ark.restype = L
    lib.klt_scan_posterior_ark.argtypes = [
        ctypes.c_void_p, L, I, L, L, PL, PI, PL, PI, PI, PF]
    lib.klt_fill_stream.restype = L
    lib.klt_fill_stream.argtypes = [
        L, L, L, L, PF, L, PI, PF, L, PF, PI, PF, PF]
    lib.klt_fill_batch.restype = L
    lib.klt_fill_batch.argtypes = [
        L, L, L, L, L, P64, P64, P64, P64, P64, PF, PI, PF, PF]


def _declare(lib: ctypes.CDLL) -> None:
    I64 = ctypes.c_int64
    P64 = ctypes.POINTER(I64)
    PI = ctypes.POINTER(ctypes.c_int)
    PD = ctypes.POINTER(ctypes.c_double)
    D = ctypes.c_double
    graph = [I64, I64, I64, P64, PI, PI, PD, I64, P64, PI, PD]
    lib.klt_decode_faster.restype = I64
    lib.klt_decode_faster.argtypes = graph + [PD, D, D, I64, I64, PD, PI]
    lib.klt_decode_faster_sparse.restype = I64
    lib.klt_decode_faster_sparse.argtypes = graph + [
        PI, PI, PI, PI, PI, PD, D, D, I64, I64, PD, PD, PI, PI, I64, PI]
    lib.klt_decode_lattice.restype = I64
    lib.klt_decode_lattice.argtypes = graph + [
        PD, D, D, I64, I64, PD, P64, I64, P64, P64, I64, P64]
    lib.klt_decode_lattice2.restype = I64
    lib.klt_decode_lattice2.argtypes = graph + [
        PD, D, D, I64, I64, PI, PD, I64, P64, P64, I64, P64, P64, I64, P64]
    lib.klt_stream_new.restype = ctypes.c_void_p
    lib.klt_stream_new.argtypes = [I64, P64, PI, PI, PD, I64, P64, PI, PD,
                                   D, D, I64, I64, PI]
    lib.klt_stream_advance.restype = I64
    lib.klt_stream_advance.argtypes = [ctypes.c_void_p, PD, I64, I64, PI]
    lib.klt_stream_alpha.restype = None
    lib.klt_stream_alpha.argtypes = [ctypes.c_void_p, PD]
    lib.klt_stream_free.restype = None
    lib.klt_stream_free.argtypes = [ctypes.c_void_p]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _graph_args(ns, T, K, em_ptr, em_dst, em_pdf, em_w, eps_ptr, eps_dst,
                eps_w) -> list:
    return [ns, T, K,
            _ptr(em_ptr, ctypes.c_int64), _ptr(em_dst, ctypes.c_int),
            _ptr(em_pdf, ctypes.c_int), _ptr(em_w, ctypes.c_double),
            len(em_dst),
            _ptr(eps_ptr, ctypes.c_int64), _ptr(eps_dst, ctypes.c_int),
            _ptr(eps_w, ctypes.c_double)]


def decode_faster_sparse_native(ns: int, em_ptr, em_dst, em_pdf, em_w,
                                em_src, em_word, em_tid,
                                eps_ptr, eps_dst, eps_w,
                                eps_src, eps_word,
                                loglik: np.ndarray, final_w: np.ndarray,
                                acoustic_scale: float, beam: float,
                                max_active: int, start: int):
    """Large-graph Viterbi decode with SPARSE backpointers + in-C++
    traceback (klt_decode_faster_sparse): memory is O(T * active)
    instead of the dense path's O(T * num_states). `loglik` is [T, K]
    C-contiguous float64. Returns (words int32[], tids int32[], score,
    reached)."""
    lib = get_lib()
    T, K = loglik.shape
    score = np.empty(1, np.float64)
    reached = np.empty(1, np.int32)
    tids = np.empty(T, np.int32)
    cap = 4 * T + 64
    for _ in range(4):
        words = np.empty(cap, np.int32)
        rc = lib.klt_decode_faster_sparse(
            *_graph_args(ns, T, K, em_ptr, em_dst, em_pdf, em_w,
                         eps_ptr, eps_dst, eps_w),
            _ptr(em_src, ctypes.c_int), _ptr(em_word, ctypes.c_int),
            _ptr(em_tid, ctypes.c_int),
            _ptr(eps_src, ctypes.c_int), _ptr(eps_word, ctypes.c_int),
            _ptr(loglik, ctypes.c_double), float(acoustic_scale),
            float(beam), int(max_active), int(start),
            _ptr(final_w, ctypes.c_double),
            _ptr(score, ctypes.c_double), _ptr(reached, ctypes.c_int),
            _ptr(words, ctypes.c_int), cap, _ptr(tids, ctypes.c_int))
        if rc == -1000001:
            cap *= 8
            continue
        if rc == -1000000:
            raise RuntimeError(
                "decode_faster: broken backpointer chain (sparse)")
        if rc < 0:
            raise RuntimeError(
                f"decode_faster: no tokens survived at frame {-rc - 1} "
                "— beam too tight or loglik/graph mismatch")
        return (words[:rc], tids, float(score[0]), bool(reached[0]))
    raise RuntimeError("decode_faster: word path exceeds capacity")


def decode_faster_native(ns: int, em_ptr, em_dst, em_pdf, em_w,
                         eps_ptr, eps_dst, eps_w, loglik: np.ndarray,
                         acoustic_scale: float, beam: float,
                         max_active: int, start: int):
    """Whole-utterance Viterbi beam search in C++ (klt_decode_faster).
    Returns (alpha [ns] float64, bps [(T+1), ns] int32); raises
    RuntimeError when no token survives a frame (same condition as the
    numpy path)."""
    lib = get_lib()
    T, K = loglik.shape
    alpha = np.empty(ns, np.float64)
    bps = np.empty((T + 1, ns), np.int32)
    rc = lib.klt_decode_faster(
        *_graph_args(ns, T, K, em_ptr, em_dst, em_pdf, em_w,
                     eps_ptr, eps_dst, eps_w),
        _ptr(loglik, ctypes.c_double), float(acoustic_scale), float(beam),
        int(max_active), int(start),
        _ptr(alpha, ctypes.c_double), _ptr(bps, ctypes.c_int))
    if rc < 0:
        raise RuntimeError(
            f"decode_faster: no tokens survived at frame {-rc - 1} — "
            "beam too tight or loglik/graph mismatch")
    return alpha, bps


def _kept(ids, ptr, n) -> list:
    return [ids[ptr[i]:ptr[i + 1]].copy() for i in range(n)]


def decode_lattice_native(ns: int, em_ptr, em_dst, em_pdf, em_w,
                          eps_ptr, eps_dst, eps_w, em: np.ndarray,
                          beam: float, lattice_beam: float,
                          max_active: int, start: int):
    """Lattice-generating forward pass in C++ (klt_decode_lattice) with
    dense [(T+1), ns] alpha snapshots. `em` is the pre-scaled [T, K]
    float64 emission matrix. Returns (alphas, em_kept per-frame id
    arrays, eps_kept per-level id arrays); raises RuntimeError when no
    token survives a frame."""
    lib = get_lib()
    T, K = em.shape
    alphas = np.empty((T + 1, ns), np.float64)
    em_out_ptr = np.zeros(T + 1, np.int64)
    eps_out_ptr = np.zeros(T + 2, np.int64)
    em_cap, eps_cap = 64 * T + 4096, 64 * (T + 2) + 4096
    while True:
        em_ids = np.empty(em_cap, np.int64)
        eps_ids = np.empty(eps_cap, np.int64)
        rc = lib.klt_decode_lattice(
            *_graph_args(ns, T, K, em_ptr, em_dst, em_pdf, em_w,
                         eps_ptr, eps_dst, eps_w),
            _ptr(em, ctypes.c_double), float(beam), float(lattice_beam),
            int(max_active), int(start),
            _ptr(alphas, ctypes.c_double),
            _ptr(em_ids, ctypes.c_int64), em_cap,
            _ptr(em_out_ptr, ctypes.c_int64),
            _ptr(eps_ids, ctypes.c_int64), eps_cap,
            _ptr(eps_out_ptr, ctypes.c_int64))
        if rc == 1:  # capacity exceeded; ptr arrays carry true counts
            em_cap = max(em_cap, int(em_out_ptr[T]) + 1)
            eps_cap = max(eps_cap, int(eps_out_ptr[T + 1]) + 1)
            continue
        if rc < 0:
            raise RuntimeError(
                f"decode_lattice_faster: no tokens survived at frame "
                f"{-rc - 1} — beam too tight or loglik/graph mismatch")
        break
    return (alphas, _kept(em_ids, em_out_ptr, T),
            _kept(eps_ids, eps_out_ptr, T + 1))


class SparseAlphas:
    """Per-level sparse alpha snapshots from klt_decode_lattice2:
    `self[level]` returns a lookup object supporting fancy indexing
    (searchsorted over the level's SORTED state ids; absent states
    read as NEG). Drop-in for the dense [(T+1), ns] table in
    decode_lattice_faster's backward pruning, which only reads alpha
    at recorded-arc endpoints."""

    NEG = -1e30

    class _Level:
        __slots__ = ("states", "vals")

        def __init__(self, states, vals):
            self.states = states
            self.vals = vals

        def __getitem__(self, idx):
            idx = np.asarray(idx)
            pos = np.searchsorted(self.states, idx)
            pos_c = np.minimum(pos, len(self.states) - 1) \
                if len(self.states) else pos * 0
            out = np.full(idx.shape, SparseAlphas.NEG)
            if len(self.states):
                hit = self.states[pos_c] == idx
                out[hit] = self.vals[pos_c[hit]]
            return out

        def to_dense(self, ns: int) -> np.ndarray:
            d = np.full(ns, SparseAlphas.NEG)
            d[self.states] = self.vals
            return d

    def __init__(self, states, vals, lvl_ptr):
        self._states = states
        self._vals = vals
        self._ptr = lvl_ptr

    def __getitem__(self, level: int):
        a, b = int(self._ptr[level]), int(self._ptr[level + 1])
        return self._Level(self._states[a:b], self._vals[a:b])


def decode_lattice2_native(ns: int, em_ptr, em_dst, em_pdf, em_w,
                           eps_ptr, eps_dst, eps_w, em: np.ndarray,
                           beam: float, lattice_beam: float,
                           max_active: int, start: int):
    """Sparse-alpha lattice forward (klt_decode_lattice2): two rolling
    alpha rows, each level's (state, alpha) pairs streamed out sparsely,
    instead of the dense [(T+1), ns] snapshot table, whose page-fault
    fill dominates at ~1M states. Returns (SparseAlphas, em_kept,
    eps_kept)."""
    lib = get_lib()
    T, K = em.shape
    em_out_ptr = np.zeros(T + 1, np.int64)
    eps_out_ptr = np.zeros(T + 2, np.int64)
    alev_ptr = np.zeros(T + 2, np.int64)
    em_cap, eps_cap = 64 * T + 4096, 64 * (T + 2) + 4096
    alev_cap = (T + 2) * max(1024, 2 * max_active if max_active else 8192)
    while True:
        em_ids = np.empty(em_cap, np.int64)
        eps_ids = np.empty(eps_cap, np.int64)
        alev_states = np.empty(alev_cap, np.int32)
        alev_vals = np.empty(alev_cap, np.float64)
        rc = lib.klt_decode_lattice2(
            *_graph_args(ns, T, K, em_ptr, em_dst, em_pdf, em_w,
                         eps_ptr, eps_dst, eps_w),
            _ptr(em, ctypes.c_double), float(beam), float(lattice_beam),
            int(max_active), int(start),
            _ptr(alev_states, ctypes.c_int),
            _ptr(alev_vals, ctypes.c_double), alev_cap,
            _ptr(alev_ptr, ctypes.c_int64),
            _ptr(em_ids, ctypes.c_int64), em_cap,
            _ptr(em_out_ptr, ctypes.c_int64),
            _ptr(eps_ids, ctypes.c_int64), eps_cap,
            _ptr(eps_out_ptr, ctypes.c_int64))
        if rc == 1:  # capacity exceeded; ptr arrays carry true counts
            em_cap = max(em_cap, int(em_out_ptr[T]) + 1)
            eps_cap = max(eps_cap, int(eps_out_ptr[T + 1]) + 1)
            alev_cap = max(alev_cap, int(alev_ptr[T + 1]) + 1)
            continue
        if rc < 0:
            raise RuntimeError(
                f"decode_lattice_faster: no tokens survived at frame "
                f"{-rc - 1} — beam too tight or loglik/graph mismatch")
        break
    n = int(alev_ptr[T + 1])
    return (SparseAlphas(alev_states[:n].copy(), alev_vals[:n].copy(),
                         alev_ptr.copy()),
            _kept(em_ids, em_out_ptr, T), _kept(eps_ids, eps_out_ptr, T + 1))


class NativeStreamSession:
    """Persistent native Viterbi search state of one online decoder
    (``klt_stream_*``): the search advances chunk by chunk and keeps its
    alpha between calls. It holds the graph's CSR arrays for its lifetime
    (the C side keeps raw pointers into them). Chunks passed to `advance`
    are PRE-SCALED log-likelihoods (the session runs at acoustic scale
    1.0; OnlineDecoder folds its scale in). Raises RuntimeError when the
    core cannot be built or loaded, like every binding here."""

    def __init__(self, ns: int, em_ptr, em_dst, em_pdf, em_w,
                 eps_ptr, eps_dst, eps_w, beam: float,
                 max_active: int, start: int):
        lib = get_lib()
        self._lib = lib
        self.ns = int(ns)
        self._refs = (em_ptr, em_dst, em_pdf, em_w, eps_ptr, eps_dst, eps_w)
        self.bp0 = np.empty(self.ns, np.int32)
        self._h = lib.klt_stream_new(
            self.ns, _ptr(em_ptr, ctypes.c_int64),
            _ptr(em_dst, ctypes.c_int), _ptr(em_pdf, ctypes.c_int),
            _ptr(em_w, ctypes.c_double), len(em_dst),
            _ptr(eps_ptr, ctypes.c_int64), _ptr(eps_dst, ctypes.c_int),
            _ptr(eps_w, ctypes.c_double),
            1.0, float(beam), int(max_active), int(start),
            _ptr(self.bp0, ctypes.c_int))
        self._frames = 0

    def advance(self, em: np.ndarray) -> np.ndarray:
        """em: [T, K] pre-scaled log-likelihoods. Returns the dense
        [T, ns] int32 backpointer rows of these frames."""
        em = np.ascontiguousarray(em, np.float64)
        T, K = em.shape
        bps = np.empty((T, self.ns), np.int32)
        rc = self._lib.klt_stream_advance(
            self._h, _ptr(em, ctypes.c_double), T, K,
            _ptr(bps, ctypes.c_int))
        if rc < 0:
            raise RuntimeError(
                f"online decode: no tokens survived at frame "
                f"{self._frames + (-rc - 1)} — beam too tight or "
                "loglik/graph mismatch")
        self._frames += T
        return bps

    def alpha(self) -> np.ndarray:
        """A copy of the search's current alpha row [ns]."""
        out = np.empty(self.ns, np.float64)
        self._lib.klt_stream_alpha(self._h, _ptr(out, ctypes.c_double))
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.klt_stream_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# the I/O half: ark scans and the batch fill (csrc/kltio.cc)
# ---------------------------------------------------------------------------

def scan_matrix_ark(path: str) -> list:
    """[(key, [rows, cols] float32 view)] of a binary float-matrix ark, in
    file order. The views alias a read-only mapping of the file (no copy;
    they may be unaligned). Raises ValueError when the file is not a
    binary ark of "FM" matrices (a text ark, a compressed matrix)."""
    lib = get_io_lib()
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return []
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    buf = np.frombuffer(mm, np.uint8)
    cap = max(16, size // 64)  # records are >= ~64 bytes in practice
    while True:
        key_off = np.zeros(cap, np.int64)
        key_len = np.zeros(cap, np.int32)
        data_off = np.zeros(cap, np.int64)
        rows = np.zeros(cap, np.int32)
        cols = np.zeros(cap, np.int32)
        n = lib.klt_scan_matrix_ark(
            buf.ctypes.data, size, cap,
            _ptr(key_off, ctypes.c_long), _ptr(key_len, ctypes.c_int),
            _ptr(data_off, ctypes.c_long), _ptr(rows, ctypes.c_int),
            _ptr(cols, ctypes.c_int))
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise ValueError(f"malformed matrix ark: {path}")
        break
    out = []
    for i in range(n):
        key = bytes(mm[key_off[i]:key_off[i] + key_len[i]]).decode()
        r, c = int(rows[i]), int(cols[i])
        out.append((key, np.frombuffer(mm, np.float32, count=r * c,
                                       offset=int(data_off[i])
                                       ).reshape(r, c)))
    return out


def scan_posterior_ark(path: str, max_entries: int = 1,
                       offsets: dict | None = None) -> dict:
    """{key: ([T, K] int32 ids, [T, K] float32 weights)} of a binary
    posterior ark, K = `max_entries`: entries past K are dropped, missing
    ones are 0. With `offsets`, that dict also gets each key's byte offset
    of its value (the ``\\0B`` header, an scp offset), so a caller can read
    a record whole. Raises ValueError when the file is not a binary
    posterior ark."""
    lib = get_io_lib()
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    if size == 0:
        return {}
    cap_rec = max(16, size // 32)
    # first pass counts records and frames (retried with a larger record
    # capacity on -2: short keys and short records beat the estimate)
    while True:
        key_off = np.zeros(cap_rec, np.int64)
        key_len = np.zeros(cap_rec, np.int32)
        frame_off = np.zeros(cap_rec, np.int64)
        num_frames = np.zeros(cap_rec, np.int32)
        n = lib.klt_scan_posterior_ark(
            data, size, max_entries, cap_rec, 1 << 62,
            _ptr(key_off, ctypes.c_long), _ptr(key_len, ctypes.c_int),
            _ptr(frame_off, ctypes.c_long), _ptr(num_frames, ctypes.c_int),
            None, None)
        if n == -2:
            cap_rec *= 4
            continue
        if n < 0:
            raise ValueError(f"malformed posterior ark: {path}")
        break
    total = int(frame_off[n - 1] + num_frames[n - 1]) if n > 0 else 0
    ids = np.zeros((total, max_entries), np.int32)
    weights = np.zeros((total, max_entries), np.float32)
    n2 = lib.klt_scan_posterior_ark(
        data, size, max_entries, cap_rec, total,
        _ptr(key_off, ctypes.c_long), _ptr(key_len, ctypes.c_int),
        _ptr(frame_off, ctypes.c_long), _ptr(num_frames, ctypes.c_int),
        _ptr(ids, ctypes.c_int), _ptr(weights, ctypes.c_float))
    if n2 != n:
        raise ValueError(f"posterior ark changed while scanned: {path}")
    out = {}
    for i in range(n):
        key = data[key_off[i]:key_off[i] + key_len[i]].decode()
        a = int(frame_off[i])
        b = a + int(num_frames[i])
        out[key] = (ids[a:b], weights[a:b])
        if offsets is not None:
            offsets[key] = int(key_off[i] + key_len[i]) + 1
    return out


def _check_arrays(fn: str, specs) -> None:
    """Raise unless each (name, array, dtype, shape) is a C-contiguous
    array of that dtype and shape, and each output is writable: the
    native code reads and writes them through raw pointers."""
    for name, a, dt, shape in specs:
        if (a.dtype != dt or a.shape != shape or not a.flags.c_contiguous
                or (name.startswith(("out", "curt"))
                    and not a.flags.writeable)):
            raise ValueError(f"{fn}: {name} must be a C-contiguous "
                             f"{np.dtype(dt).name} array of shape {shape}, "
                             f"got {a.dtype} {a.shape}")


def fill_batch(T: int, delay: int, feats_p: np.ndarray, ids_p: np.ndarray,
               w_p: np.ndarray, lent: np.ndarray, curt: np.ndarray,
               D: int, K: int,
               out_feats: np.ndarray, out_ids: np.ndarray,
               out_w: np.ndarray, out_mask: np.ndarray) -> bool:
    """Fill the whole [S, T] batch in one native call. `feats_p`, `ids_p`
    and `w_p` are [S] int64 arrays of raw data pointers (0 = a stream that
    was never fed: its rows are zeroed), which must stay valid for the
    call; `curt` [S] int64 advances in place. The outputs are C-contiguous
    [S, T, D] / [S, T, K] / [S, T, K] / [S, T]. Returns True (the JAX
    package's value when its library is present)."""
    S = curt.shape[0]
    _check_arrays("fill_batch", (
        ("feats_p", feats_p, np.int64, (S,)),
        ("ids_p", ids_p, np.int64, (S,)), ("w_p", w_p, np.int64, (S,)),
        ("lent", lent, np.int64, (S,)), ("curt", curt, np.int64, (S,)),
        ("out_feats", out_feats, np.float32, (S, T, D)),
        ("out_ids", out_ids, np.int32, (S, T, K)),
        ("out_w", out_w, np.float32, (S, T, K)),
        ("out_mask", out_mask, np.float32, (S, T))))
    lib = get_io_lib()
    p64 = ctypes.c_int64
    lib.klt_fill_batch(
        S, T, D, K, delay, _ptr(feats_p, p64), _ptr(ids_p, p64),
        _ptr(w_p, p64), _ptr(lent, p64), _ptr(curt, p64),
        _ptr(out_feats, ctypes.c_float), _ptr(out_ids, ctypes.c_int),
        _ptr(out_w, ctypes.c_float), _ptr(out_mask, ctypes.c_float))
    return True


def fill_stream(T: int, delay: int, feats: np.ndarray, tgt_ids: np.ndarray,
                tgt_w: np.ndarray, curt: int, out_feats: np.ndarray,
                out_ids: np.ndarray, out_w: np.ndarray,
                out_mask: np.ndarray) -> int:
    """One stream's [T] batch rows from its utterance (feats [L, D]
    float32, targets [L, K]); returns the new curt. Arrays must be
    C-contiguous float32 / int32."""
    lent, D = feats.shape
    K = tgt_ids.shape[1]
    _check_arrays("fill_stream", (
        ("feats", feats, np.float32, (lent, D)),
        ("tgt_ids", tgt_ids, np.int32, (lent, K)),
        ("tgt_w", tgt_w, np.float32, (lent, K)),
        ("out_feats", out_feats, np.float32, (T, D)),
        ("out_ids", out_ids, np.int32, (T, K)),
        ("out_w", out_w, np.float32, (T, K)),
        ("out_mask", out_mask, np.float32, (T,))))
    lib = get_io_lib()
    return int(lib.klt_fill_stream(
        T, D, K, delay,
        _ptr(feats, ctypes.c_float), lent,
        _ptr(tgt_ids, ctypes.c_int), _ptr(tgt_w, ctypes.c_float), curt,
        _ptr(out_feats, ctypes.c_float), _ptr(out_ids, ctypes.c_int),
        _ptr(out_w, ctypes.c_float), _ptr(out_mask, ctypes.c_float)))
