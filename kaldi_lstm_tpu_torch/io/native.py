"""ctypes bindings to the native decoder core (``csrc/kltdecode.cc``) —
this package's copy of the decoder half of ``kaldi_lstm_tpu.io.native``.

The core is host code, built at first use with ``g++ -O3 -fPIC
-std=c++17 -shared`` (``CXX`` names another compiler) into
``kaldi_lstm_tpu_torch/_build/``, which ``.gitignore`` lists. The
library's file name carries a hash of the source and the flags, so an
edit rebuilds it; a build is written to a temporary name and renamed
into place under a file lock, so concurrent processes neither race the
compiler nor load a half-written library.

There is no fallback: a core that fails to build or load raises
RuntimeError naming the compiler's or the loader's error. The numpy
decoders in decode/faster.py, decode/lattice_faster.py and
decode/online.py run only when asked for with ``KLT_DECODE_IMPL=python``.

ctypes releases the GIL for the length of each call, so decoder threads
(``--num-threads``) search in parallel while the main thread feeds the
card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "kltdecode.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def lib_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Where the library built from `source` lives: named by a hash of
    the source's bytes and the flags."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir, f"libkltdecode.{h.hexdigest()[:16]}.so")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = lib_path(source, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "kltdecode.lock"), "a") as lock:
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
                f"native decoder core: could not run {' '.join(cmd)}: {e} "
                "(the decoders need g++; they do not fall back to numpy, "
                "KLT_DECODE_IMPL=python asks for the numpy decoders)") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"native decoder core: {' '.join(cmd)} failed (exit "
                f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded decoder core, built first if needed (see module
    docstring); raises RuntimeError when it cannot be built or loaded."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            path = build(SOURCE, BUILD_DIR)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(
                    f"native decoder core: cannot load {path}: {e}") from e
            _declare(lib)
            _LIB = lib
        return _LIB


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
