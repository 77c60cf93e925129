// kltio — the native host I/O of kaldi_lstm_tpu_torch: this package's
// copy of native/kltio.cc, built at first use by io/native.py.
//
//  * klt_scan_matrix_ark     — offset scan of a binary float-matrix ark so
//                              Python can map the matrices zero-copy
//                              (SequentialBaseFloatMatrixReader equivalent)
//  * klt_scan_posterior_ark  — parse a binary posterior ark into dense
//                              top-K (id, weight) frame arrays
//                              (RandomAccessPosteriorReader equivalent)
//  * klt_fill_stream         — one stream's slice of the [S, Tbptt] batch:
//                              mask/target padding + target-delay feature
//                              shift (bd-nnet-train-lstm-streams.cc:187-206)
//  * klt_fill_batch          — every stream of the batch in one call
//
// Wire format (matching io/kaldi_io.py):
//   record   := key ' ' '\0' 'B' value
//   matrix   := "FM " '\x04' int32 rows '\x04' int32 cols f32[rows*cols]
//   posterior:= '\x04' int32 T { '\x04' int32 n { '\x04' int32 id
//                                                 '\x04' f32 w }*n }*T
// All integers/floats little-endian.

#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  bool need(long n) {
    if (end - p < n) { ok = false; return false; }
    return true;
  }
  bool read_i32(int32_t* out) {
    if (!need(5) || *p != '\x04') { ok = false; return false; }
    std::memcpy(out, p + 1, 4);
    p += 5;
    return true;
  }
  bool read_f32(float* out) {
    if (!need(5) || *p != '\x04') { ok = false; return false; }
    std::memcpy(out, p + 1, 4);
    p += 5;
    return true;
  }
  // skip whitespace, read key token; returns length or -1 at EOF/error
  long read_key(const char** key_start) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                       *p == '\r')) p++;
    if (p >= end) return -1;
    *key_start = p;
    while (p < end && *p > ' ') p++;
    return p - *key_start;
  }
  bool expect_binary_header() {
    // one space then \0B
    if (!need(3) || p[0] != ' ' || p[1] != '\0' || p[2] != 'B') {
      ok = false;
      return false;
    }
    p += 3;
    return true;
  }
  bool expect_token(const char* tok) {
    long n = std::strlen(tok);
    if (!need(n + 1) || std::strncmp(p, tok, n) != 0 || p[n] != ' ') {
      ok = false;
      return false;
    }
    p += n + 1;
    return true;
  }
};

}  // namespace

extern "C" {

// Returns number of records scanned (>=0), or -1 on malformed input,
// or -2 if max_records was too small.
long klt_scan_matrix_ark(const char* buf, long n, long max_records,
                         long* key_off, int* key_len, long* data_off,
                         int* rows, int* cols) {
  Cursor c{buf, buf + n};
  long i = 0;
  while (true) {
    const char* key;
    long klen = c.read_key(&key);
    if (klen < 0) return i;  // clean EOF
    if (i >= max_records) return -2;
    if (!c.expect_binary_header()) return -1;
    if (!c.expect_token("FM")) return -1;
    int32_t r, cl;
    if (!c.read_i32(&r) || !c.read_i32(&cl)) return -1;
    if (r < 0 || cl < 0) return -1;  // corrupt dims: cursor must not rewind
    // overflow-safe size check: r*cl*4 can wrap signed long for crafted
    // dims; compare against the remaining bytes with division instead
    long remain = (long)(c.end - c.p);
    if (cl > 0 && (long)r > remain / 4 / cl) return -1;
    long bytes = (long)r * cl * 4;
    if (!c.need(bytes)) return -1;
    key_off[i] = key - buf;
    key_len[i] = (int)klen;
    data_off[i] = c.p - buf;
    rows[i] = r;
    cols[i] = cl;
    c.p += bytes;
    i++;
  }
}

// Two-phase posterior scan.
// Phase 1 (ids == nullptr): count records and total frames; fills
//   key_off/key_len/frame_off/num_frames. Returns record count, or
//   -1 malformed / -2 capacity.
// Phase 2 (ids != nullptr): fills ids/weights [total_frames, K] dense
//   top-K arrays (excess entries per frame are dropped, shorter frames
//   zero-padded — K=1 covers ali-to-post 1-best targets).
long klt_scan_posterior_ark(const char* buf, long n, int K,
                            long max_records, long max_frames,
                            long* key_off, int* key_len, long* frame_off,
                            int* num_frames, int* ids, float* weights) {
  Cursor c{buf, buf + n};
  long rec = 0;
  long frames = 0;
  while (true) {
    const char* key;
    long klen = c.read_key(&key);
    if (klen < 0) return rec;
    if (rec >= max_records) return -2;
    if (!c.expect_binary_header()) return -1;
    int32_t T;
    if (!c.read_i32(&T)) return -1;
    if (T < 0) return -1;  // corrupt frame count
    if (frames + T > max_frames) return -2;
    key_off[rec] = key - buf;
    key_len[rec] = (int)klen;
    frame_off[rec] = frames;
    num_frames[rec] = T;
    for (int32_t t = 0; t < T; t++) {
      int32_t cnt;
      if (!c.read_i32(&cnt)) return -1;
      if (cnt < 0) return -1;  // negative count would underflow padding
      for (int32_t k = 0; k < cnt; k++) {
        int32_t id;
        float w;
        if (!c.read_i32(&id) || !c.read_f32(&w)) return -1;
        if (ids != nullptr && k < K) {
          ids[(frames + t) * K + k] = id;
          weights[(frames + t) * K + k] = w;
        }
      }
      if (ids != nullptr) {
        for (int32_t k = cnt; k < K; k++) {
          ids[(frames + t) * K + k] = 0;
          weights[(frames + t) * K + k] = 0.0f;
        }
      }
    }
    frames += T;
    rec++;
  }
}

// Fill stream s's rows of a [S, T] batch (stream-major [S, T, ...] layout,
// caller passes pointers already offset to stream s). Targets padded with
// the last frame, features shifted by `delay` and clamped to the last
// frame, mask 0 past the end; curt advances T steps (even past lent).
// Returns the new curt.
long klt_fill_stream(long T, long D, long K, long delay,
                     const float* feats, long lent,
                     const int* tgt_ids, const float* tgt_w, long curt,
                     float* out_feats, int* out_ids, float* out_w,
                     float* out_mask) {
  for (long t = 0; t < T; t++) {
    long cu = curt + t;
    long tgt_row = cu < lent ? cu : lent - 1;
    out_mask[t] = cu < lent ? 1.0f : 0.0f;
    std::memcpy(out_ids + t * K, tgt_ids + tgt_row * K, K * sizeof(int));
    std::memcpy(out_w + t * K, tgt_w + tgt_row * K, K * sizeof(float));
    long src = cu + delay;
    if (src >= lent) src = lent - 1;
    std::memcpy(out_feats + t * D, feats + src * D, D * sizeof(float));
  }
  return curt + T;
}

// Whole-batch variant: fills all S streams in one call (the per-stream
// entry costs ~60 us of ctypes pointer marshalling per batch at S=64 —
// 90% of scheduler time, measured). Pointer arrays are passed as int64
// so Python can cache them across batches; a 0 pointer marks a stream
// whose source went dry (its rows are zeroed, mask = 0). curt is
// updated in place.
long klt_fill_batch(long S, long T, long D, long K, long delay,
                    const int64_t* feats_p, const int64_t* ids_p,
                    const int64_t* w_p, const int64_t* lent,
                    int64_t* curt,
                    float* out_feats, int* out_ids, float* out_w,
                    float* out_mask) {
  for (long s = 0; s < S; s++) {
    float* of = out_feats + s * T * D;
    int* oi = out_ids + s * T * K;
    float* ow = out_w + s * T * K;
    float* om = out_mask + s * T;
    if (feats_p[s] == 0) {
      std::memset(of, 0, T * D * sizeof(float));
      std::memset(oi, 0, T * K * sizeof(int));
      std::memset(ow, 0, T * K * sizeof(float));
      std::memset(om, 0, T * sizeof(float));
      continue;
    }
    curt[s] = klt_fill_stream(
        T, D, K, delay,
        reinterpret_cast<const float*>(feats_p[s]), lent[s],
        reinterpret_cast<const int*>(ids_p[s]),
        reinterpret_cast<const float*>(w_p[s]), curt[s],
        of, oi, ow, om);
  }
  return S;
}

}  // extern "C"
