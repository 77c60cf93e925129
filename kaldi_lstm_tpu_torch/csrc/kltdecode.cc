// Native Viterbi beam-search core for decode/faster.py (this package's
// copy of native/kltdecode.cc). Host code: io/native.py builds it with
// g++ at first use and binds it with ctypes.
//
// Replicates decode_faster's vectorized numpy semantics exactly
// (including backpointer tie order: within a frame, arcs are relaxed in
// ascending (source-state, arc-id) order and an equal score REPLACES
// the backpointer, matching np.maximum.at + the `cand >= alpha[dst]`
// winner mask), so the Python path remains a drop-in cross-check.
//
// The graph arrives as the same CSR arrays CompiledGraph builds; per
// utterance one call runs the whole frame loop and fills the
// [(T+1), ns] backpointer matrix the Python traceback consumes.
// Returns 0, or -(t+1) if no token survived frame t (beam too tight).
//
// Upstream counterpart: decode-faster-mapped's FasterDecoder
// (ProcessEmitting/ProcessNonemitting); see decode/faster.py.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
constexpr double kNeg = -1e30;

struct EpsClosure {
  // relaxation to fixed point over the epsilon CSR, replicating
  // _eps_closure EXACTLY: each pass is Jacobi from a pass-start
  // snapshot (numpy computes all candidates before np.maximum.at),
  // `>=` replaces so the LAST equal-scoring arc wins the backpointer,
  // and only strict improvements over the pass-start value propagate.
  // Max 32 passes; cutoff drops candidates (strict >). Appends
  // newly-improved states to `grown`. bp may be null (lattice forward
  // records arcs separately).
  static void run(int64_t ns, const int64_t* ptr, const int32_t* dst,
                  const double* w, int64_t num_em, double* alpha,
                  int32_t* bp, std::vector<int32_t>& frontier,
                  double cutoff, std::vector<int32_t>& grown,
                  std::vector<int32_t>& stamp, int32_t& epoch) {
    std::vector<int32_t> next;
    std::vector<double> alpha_old(alpha, alpha + ns);
    for (int pass = 0; pass < 32 && !frontier.empty(); ++pass) {
      ++epoch;
      next.clear();
      if (pass > 0) std::copy(alpha, alpha + ns, alpha_old.begin());
      for (int32_t s : frontier) {
        for (int64_t a = ptr[s]; a < ptr[s + 1]; ++a) {
          const double cand = alpha_old[s] + w[a];
          if (cand <= cutoff) continue;
          const int32_t d = dst[a];
          if (cand > alpha_old[d] && cand >= alpha[d]) {
            alpha[d] = cand;
            if (bp != nullptr) bp[d] = static_cast<int32_t>(num_em + a);
            if (stamp[d] != epoch) {
              stamp[d] = epoch;
              next.push_back(d);
            }
          }
        }
      }
      std::sort(next.begin(), next.end());
      frontier.swap(next);
      grown.insert(grown.end(), frontier.begin(), frontier.end());
    }
  }
};
}  // namespace

namespace {

// Frame-stepping core shared by the whole-utterance entry point
// (klt_decode_faster) and the streaming session API (klt_stream_*):
// holds the CSR graph pointers (caller keeps the arrays alive) and the
// persistent search state (alpha, active frontier, visit stamps).
struct StreamCore {
  int64_t ns;
  const int64_t* em_ptr;
  const int32_t* em_dst;
  const int32_t* em_pdf;
  const double* em_w;
  int64_t num_em;
  const int64_t* eps_ptr;
  const int32_t* eps_dst;
  const double* eps_w;
  double acoustic_scale, beam;
  int64_t max_active;

  std::vector<double> alpha, alpha_next, scores;
  std::vector<int32_t> active, touched, grown, stamp;
  int32_t epoch = 0;

  StreamCore(int64_t ns_, const int64_t* em_ptr_, const int32_t* em_dst_,
             const int32_t* em_pdf_, const double* em_w_, int64_t num_em_,
             const int64_t* eps_ptr_, const int32_t* eps_dst_,
             const double* eps_w_, double ascale, double beam_,
             int64_t max_active_)
      : ns(ns_), em_ptr(em_ptr_), em_dst(em_dst_), em_pdf(em_pdf_),
        em_w(em_w_), num_em(num_em_), eps_ptr(eps_ptr_),
        eps_dst(eps_dst_), eps_w(eps_w_), acoustic_scale(ascale),
        beam(beam_), max_active(max_active_),
        alpha(ns_, kNeg), alpha_next(ns_), stamp(ns_, 0) {}

  void init(int64_t start, int32_t* bp0 /* [ns], pre-set to -1 */) {
    alpha[start] = 0.0;
    active.push_back(static_cast<int32_t>(start));
    grown.clear();
    {
      std::vector<int32_t> frontier = active;
      EpsClosure::run(ns, eps_ptr, eps_dst, eps_w, num_em, alpha.data(),
                      bp0, frontier, kNeg, grown, stamp, epoch);
    }
    for (int32_t s : grown)
      if (alpha[s] > kNeg / 2) active.push_back(s);
    std::sort(active.begin(), active.end());
    active.erase(std::unique(active.begin(), active.end()),
                 active.end());
  }

  // one Viterbi frame; bp is this frame's [ns] backpointer row
  // (pre-set to -1). Returns false when no token survives.
  bool step(const double* em_t, int32_t* bp) {
    std::fill(alpha_next.begin(), alpha_next.end(), kNeg);
    touched.clear();
    ++epoch;
    // emitting relaxation in ascending (state, arc) order; >= replaces
    // the backpointer so the LAST equal-scoring arc wins, like numpy
    for (int32_t s : active) {
      const double base = alpha[s];
      for (int64_t a = em_ptr[s]; a < em_ptr[s + 1]; ++a) {
        const double cand =
            base + em_w[a] + acoustic_scale * em_t[em_pdf[a]];
        const int32_t d = em_dst[a];
        if (cand >= alpha_next[d]) {
          alpha_next[d] = cand;
          bp[d] = static_cast<int32_t>(a);
          if (stamp[d] != epoch) {
            stamp[d] = epoch;
            touched.push_back(d);
          }
        }
      }
    }
    if (touched.empty()) return false;

    double best = kNeg;
    for (int32_t d : touched) best = std::max(best, alpha_next[d]);
    double cutoff = best - beam;
    if (max_active > 0) {
      int64_t above = 0;
      for (int32_t d : touched)
        if (alpha_next[d] > cutoff) ++above;
      if (above > max_active) {
        scores.clear();
        for (int32_t d : touched) scores.push_back(alpha_next[d]);
        std::nth_element(scores.begin(),
                         scores.end() - max_active, scores.end());
        cutoff = std::max(cutoff, *(scores.end() - max_active));
      }
    }
    active.clear();
    for (int32_t d : touched) {
      if (alpha_next[d] < cutoff) {
        alpha_next[d] = kNeg;
        bp[d] = -1;
      } else if (alpha_next[d] > kNeg / 2) {
        active.push_back(d);
      }
    }
    alpha.swap(alpha_next);
    std::sort(active.begin(), active.end());

    grown.clear();
    {
      std::vector<int32_t> frontier = active;
      EpsClosure::run(ns, eps_ptr, eps_dst, eps_w, num_em, alpha.data(),
                      bp, frontier, cutoff, grown, stamp, epoch);
    }
    if (!grown.empty()) {
      for (int32_t s : grown) active.push_back(s);
      std::sort(active.begin(), active.end());
      active.erase(std::unique(active.begin(), active.end()),
                   active.end());
    }
    return true;
  }
};
}  // namespace

extern "C" int64_t klt_decode_faster(
    int64_t ns, int64_t T, int64_t K,
    const int64_t* em_ptr, const int32_t* em_dst, const int32_t* em_pdf,
    const double* em_w, int64_t num_em,
    const int64_t* eps_ptr, const int32_t* eps_dst, const double* eps_w,
    const double* loglik, double acoustic_scale, double beam,
    int64_t max_active, int64_t start,
    double* alpha_out /* [ns] */, int32_t* bps /* [(T+1)*ns] */) {
  StreamCore core(ns, em_ptr, em_dst, em_pdf, em_w, num_em, eps_ptr,
                  eps_dst, eps_w, acoustic_scale, beam, max_active);
  std::memset(bps, 0xff, sizeof(int32_t) * (T + 1) * ns);  // all -1
  core.init(start, bps);
  for (int64_t t = 0; t < T; ++t) {
    if (!core.step(loglik + t * K, bps + (t + 1) * ns)) return -(t + 1);
  }
  std::memcpy(alpha_out, core.alpha.data(), sizeof(double) * ns);
  return 0;
}

// Sparse-backpointer whole-utterance decode for LARGE graphs: the dense
// [(T+1), ns] backpointer matrix of klt_decode_faster costs
// T*ns*4 bytes (3.6 GB/utterance at 1.5M states, 600 frames — the
// memory blowup VERDICT r3 predicted at 10-100x graph scale). Same
// StreamCore search bit-for-bit; per frame the touched entries of one
// reusable dense bp row are compacted into per-level (state, arc)
// arenas — O(T * active) total — and the traceback runs HERE (last
// write wins within a level, replicating the dense row's overwrite
// order), returning the word/tid paths directly.
//
// Returns the word count (>= 0), -(t+1) when no token survived frame
// t, -1000000 on a broken backpointer chain, -1000001 when words_cap
// was too small (caller enlarges; tids_out needs exactly T slots).
extern "C" int64_t klt_decode_faster_sparse(
    int64_t ns, int64_t T, int64_t K,
    const int64_t* em_ptr, const int32_t* em_dst, const int32_t* em_pdf,
    const double* em_w, int64_t num_em,
    const int64_t* eps_ptr, const int32_t* eps_dst, const double* eps_w,
    const int32_t* em_src, const int32_t* em_word, const int32_t* em_tid,
    const int32_t* eps_src, const int32_t* eps_word,
    const double* loglik, double acoustic_scale, double beam,
    int64_t max_active, int64_t start, const double* final_w /* [ns] */,
    double* score_out, int32_t* reached_out,
    int32_t* words_out, int64_t words_cap, int32_t* tids_out) {
  StreamCore core(ns, em_ptr, em_dst, em_pdf, em_w, num_em, eps_ptr,
                  eps_dst, eps_w, acoustic_scale, beam, max_active);
  std::vector<int32_t> bp_row(ns, -1);

  // per-level arenas: entries for level l at [lvl_ptr[l], lvl_ptr[l+1])
  std::vector<int64_t> lvl_ptr(1, 0);
  std::vector<int32_t> arena_state, arena_arc;

  auto compact = [&](const std::vector<int32_t>& states) {
    for (int32_t d : states) {
      if (bp_row[d] != -1) {
        arena_state.push_back(d);
        arena_arc.push_back(bp_row[d]);
        bp_row[d] = -1;
      }
    }
  };
  auto flush_level = [&]() {
    lvl_ptr.push_back(static_cast<int64_t>(arena_state.size()));
  };

  core.init(start, bp_row.data());
  compact(core.grown);
  flush_level();
  for (int64_t t = 0; t < T; ++t) {
    if (!core.step(loglik + t * K, bp_row.data())) return -(t + 1);
    // every touched dst (pre-pruning writes were reset to -1 by the
    // pruning loop in the DENSE path; here pruned states keep their
    // arena absence because step() resets bp[d] = -1 on prune)
    compact(core.touched);
    compact(core.grown);
    flush_level();
  }

  // final-state selection (decode/faster.py lines after the frame loop)
  double best_tot = kNeg, best_alpha = kNeg;
  int64_t state_tot = 0, state_alpha = 0;
  for (int64_t s = 0; s < ns; ++s) {
    const double a = core.alpha[s];
    if (a > best_alpha) { best_alpha = a; state_alpha = s; }
    const double tot = a + final_w[s];
    if (tot > best_tot) { best_tot = tot; state_tot = s; }
  }
  const bool reached = best_tot > kNeg / 2;
  *reached_out = reached ? 1 : 0;
  *score_out = reached ? best_tot : best_alpha;
  int64_t state = reached ? state_tot : state_alpha;

  // traceback (replicates _traceback, decode/faster.py)
  auto lookup = [&](int64_t level, int64_t st) -> int32_t {
    // last write wins within a level
    for (int64_t i = lvl_ptr[level + 1] - 1; i >= lvl_ptr[level]; --i) {
      if (arena_state[i] == st) return arena_arc[i];
    }
    return -1;
  };
  int64_t level = T;
  int64_t n_words = 0, n_tids = 0;
  std::vector<int32_t> words_rev, tids_rev;
  while (!(level == 0 && state == start && lookup(0, state) == -1)) {
    const int32_t arc = lookup(level, state);
    if (arc < 0) return -1000000;  // broken backpointer chain
    if (arc >= num_em) {
      const int64_t e = arc - num_em;
      if (eps_word[e]) words_rev.push_back(eps_word[e]);
      state = eps_src[e];
    } else {
      if (em_word[arc]) words_rev.push_back(em_word[arc]);
      tids_rev.push_back(em_tid[arc]);
      state = em_src[arc];
      --level;
    }
  }
  n_words = static_cast<int64_t>(words_rev.size());
  if (n_words > words_cap) return -1000001;
  n_tids = static_cast<int64_t>(tids_rev.size());
  for (int64_t i = 0; i < n_words; ++i)
    words_out[i] = words_rev[n_words - 1 - i];
  for (int64_t i = 0; i < n_tids; ++i)
    tids_out[i] = tids_rev[n_tids - 1 - i];
  return n_words;
}

// ---------------------------------------------------------------------------
// Streaming session API (decode/online.py OnlineDecoder): the same
// search state persists across chunk calls. The caller OWNS the graph
// CSR arrays and must keep them alive for the session lifetime.
// ---------------------------------------------------------------------------

extern "C" void* klt_stream_new(
    int64_t ns, const int64_t* em_ptr, const int32_t* em_dst,
    const int32_t* em_pdf, const double* em_w, int64_t num_em,
    const int64_t* eps_ptr, const int32_t* eps_dst, const double* eps_w,
    double acoustic_scale, double beam, int64_t max_active,
    int64_t start, int32_t* bp0 /* [ns] */) {
  auto* core = new StreamCore(ns, em_ptr, em_dst, em_pdf, em_w, num_em,
                              eps_ptr, eps_dst, eps_w, acoustic_scale,
                              beam, max_active);
  std::memset(bp0, 0xff, sizeof(int32_t) * ns);
  core->init(start, bp0);
  return core;
}

// advance T frames; fills bps [T*ns] (one row per frame). Returns 0 or
// -(t+1) (0-based t within THIS chunk) when no token survived frame t.
extern "C" int64_t klt_stream_advance(void* handle, const double* loglik,
                                      int64_t T, int64_t K,
                                      int32_t* bps) {
  auto* core = static_cast<StreamCore*>(handle);
  std::memset(bps, 0xff, sizeof(int32_t) * T * core->ns);
  (void)K;
  for (int64_t t = 0; t < T; ++t) {
    if (!core->step(loglik + t * K, bps + t * core->ns))
      return -(t + 1);
  }
  return 0;
}

extern "C" void klt_stream_alpha(void* handle, double* out /* [ns] */) {
  auto* core = static_cast<StreamCore*>(handle);
  std::memcpy(out, core->alpha.data(), sizeof(double) * core->ns);
}

extern "C" void klt_stream_free(void* handle) {
  delete static_cast<StreamCore*>(handle);
}

// Lattice-generating forward pass (decode/lattice_faster.py): the same
// beam search as klt_decode_faster, but it snapshots every level's
// alpha row into `alphas` [(T+1), ns] and records, per level, the
// emitting / epsilon arc ids that land within `lattice_beam` of their
// destination's post-pruning score (the provably sufficient superset
// the Python backward prunes exactly). Emissions arrive PRE-SCALED
// (em = acoustic_scale * loglik, double [T, K]).
//
// Recorded ids go to em_ids (em_ptr [T+1] offsets; frame t's arcs at
// [em_ptr[t], em_ptr[t+1])) and eps_ids (eps_ptr [T+2]; level l at
// [eps_ptr[l], eps_ptr[l+1])). Returns 0 on success, 1 if either
// capacity (em_cap / eps_cap) was exceeded (caller enlarges and
// retries), -(t+1) if no token survived frame t.
extern "C" int64_t klt_decode_lattice(
    int64_t ns, int64_t T, int64_t K,
    const int64_t* em_ptr_csr, const int32_t* em_dst,
    const int32_t* em_pdf, const double* em_w, int64_t num_em,
    const int64_t* eps_ptr_csr, const int32_t* eps_dst,
    const double* eps_w,
    const double* em /* [T, K] pre-scaled */, double beam,
    double lattice_beam, int64_t max_active, int64_t start,
    double* alphas /* [(T+1), ns] */,
    int64_t* em_ids, int64_t em_cap, int64_t* em_ptr /* [T+1] */,
    int64_t* eps_ids, int64_t eps_cap, int64_t* eps_ptr /* [T+2] */) {
  std::vector<int32_t> active, touched, grown, stamp(ns, 0);
  std::vector<double> scores;
  int32_t epoch = 0;
  int64_t em_n = 0, eps_n = 0;
  bool overflow = false;

  // KLT_LATGEN_PROF=1: phase attribution to stderr (fill / relax+prune
  // / eps / record) — the diagnostic that located the O(ns)-per-frame
  // cost at LVCSR graph scale
  const bool prof = std::getenv("KLT_LATGEN_PROF") != nullptr;
  using clk = std::chrono::steady_clock;
  double t_fill = 0, t_relax = 0, t_eps = 0, t_rec = 0;
  auto now = [] { return clk::now(); };
  auto ms = [](clk::time_point a, clk::time_point b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };

  auto tf0 = now();
  std::fill(alphas, alphas + (T + 1) * ns, kNeg);
  if (prof) t_fill += ms(tf0, now());
  double* alpha = alphas;
  alpha[start] = 0.0;
  active.push_back(static_cast<int32_t>(start));
  grown.clear();
  {
    std::vector<int32_t> frontier = active;
    EpsClosure::run(ns, eps_ptr_csr, eps_dst, eps_w, num_em, alpha,
                    nullptr, frontier, kNeg, grown, stamp, epoch);
  }
  for (int32_t s : grown)
    if (alpha[s] > kNeg / 2) active.push_back(s);
  std::sort(active.begin(), active.end());
  active.erase(std::unique(active.begin(), active.end()), active.end());

  auto record_eps = [&](const double* a, int64_t level) {
    eps_ptr[level] = eps_n;
    for (int32_t s : active) {
      if (a[s] <= kNeg / 2) continue;
      for (int64_t e = eps_ptr_csr[s]; e < eps_ptr_csr[s + 1]; ++e) {
        const int32_t d = eps_dst[e];
        if (a[d] <= kNeg / 2) continue;
        if (a[s] + eps_w[e] >= a[d] - lattice_beam) {
          if (eps_n < eps_cap) eps_ids[eps_n] = e;
          else overflow = true;
          ++eps_n;
        }
      }
    }
    eps_ptr[level + 1] = eps_n;
  };
  record_eps(alpha, 0);

  std::vector<int32_t> prev_active;
  for (int64_t t = 0; t < T; ++t) {
    const double* em_t = em + t * K;
    const double* alpha_prev = alphas + t * ns;
    double* alpha_new = alphas + (t + 1) * ns;
    prev_active = active;
    touched.clear();
    ++epoch;
    auto tr0 = now();
    for (int32_t s : prev_active) {
      const double base = alpha_prev[s];
      for (int64_t a = em_ptr_csr[s]; a < em_ptr_csr[s + 1]; ++a) {
        const double cand = base + em_w[a] + em_t[em_pdf[a]];
        const int32_t d = em_dst[a];
        if (cand > alpha_new[d]) alpha_new[d] = cand;
        if (stamp[d] != epoch) {
          stamp[d] = epoch;
          touched.push_back(d);
        }
      }
    }
    if (touched.empty()) return -(t + 1);

    double best = kNeg;
    for (int32_t d : touched) best = std::max(best, alpha_new[d]);
    double cutoff = best - beam;
    if (max_active > 0) {
      int64_t above = 0;
      for (int32_t d : touched)
        if (alpha_new[d] > cutoff) ++above;
      if (above > max_active) {
        scores.clear();
        for (int32_t d : touched) scores.push_back(alpha_new[d]);
        std::nth_element(scores.begin(),
                         scores.end() - max_active, scores.end());
        cutoff = std::max(cutoff, *(scores.end() - max_active));
      }
    }
    active.clear();
    for (int32_t d : touched) {
      if (alpha_new[d] < cutoff) {
        alpha_new[d] = kNeg;
      } else if (alpha_new[d] > kNeg / 2) {
        active.push_back(d);
      }
    }
    std::sort(active.begin(), active.end());
    if (prof) { t_relax += ms(tr0, now()); tr0 = now(); }
    grown.clear();
    {
      std::vector<int32_t> frontier = active;
      EpsClosure::run(ns, eps_ptr_csr, eps_dst, eps_w, num_em,
                      alpha_new, nullptr, frontier, cutoff, grown,
                      stamp, epoch);
    }
    if (!grown.empty()) {
      for (int32_t s : grown) active.push_back(s);
      std::sort(active.begin(), active.end());
      active.erase(std::unique(active.begin(), active.end()),
                   active.end());
    }
    if (prof) { t_eps += ms(tr0, now()); tr0 = now(); }
    // record emitting arcs from the PREVIOUS level's frontier landing
    // within lattice_beam of the destination's post-pruning score
    em_ptr[t] = em_n;
    for (int32_t s : prev_active) {
      const double base = alpha_prev[s];
      for (int64_t a = em_ptr_csr[s]; a < em_ptr_csr[s + 1]; ++a) {
        const int32_t d = em_dst[a];
        const double ds = alpha_new[d];
        if (ds <= kNeg / 2) continue;
        if (base + em_w[a] + em_t[em_pdf[a]] >= ds - lattice_beam) {
          if (em_n < em_cap) em_ids[em_n] = a;
          else overflow = true;
          ++em_n;
        }
      }
    }
    em_ptr[t + 1] = em_n;
    record_eps(alpha_new, t + 1);
    if (prof) t_rec += ms(tr0, now());
  }
  if (prof) {
    std::fprintf(stderr,
                 "klt_decode_lattice prof: fill %.0f ms, relax+prune "
                 "%.0f ms, eps %.0f ms, record %.0f ms (T=%lld, "
                 "ns=%lld)\n",
                 t_fill, t_relax, t_eps, t_rec,
                 static_cast<long long>(T), static_cast<long long>(ns));
  }
  return overflow ? 1 : 0;
}

// Sparse-alpha lattice forward: identical search + recording to
// klt_decode_lattice, but alpha lives in TWO rolling [ns] rows and each
// level's surviving (state, alpha) pairs stream out sparsely — the
// dense [(T+1), ns] float64 snapshot table cost 6.9 s of page-fault
// fill per utterance at 576k states (KLT_LATGEN_PROF attribution)
// against 5 ms of actual search. Level l's states (SORTED) are at
// alev_states[alev_ptr[l] : alev_ptr[l+1]] with values in alev_vals.
// Returns 0, 1 on any capacity overflow (caller enlarges + retries),
// -(t+1) when no token survived frame t.
extern "C" int64_t klt_decode_lattice2(
    int64_t ns, int64_t T, int64_t K,
    const int64_t* em_ptr_csr, const int32_t* em_dst,
    const int32_t* em_pdf, const double* em_w, int64_t num_em,
    const int64_t* eps_ptr_csr, const int32_t* eps_dst,
    const double* eps_w,
    const double* em /* [T, K] pre-scaled */, double beam,
    double lattice_beam, int64_t max_active, int64_t start,
    int32_t* alev_states, double* alev_vals, int64_t alev_cap,
    int64_t* alev_ptr /* [T+2] */,
    int64_t* em_ids, int64_t em_cap, int64_t* em_ptr /* [T+1] */,
    int64_t* eps_ids, int64_t eps_cap, int64_t* eps_ptr /* [T+2] */) {
  std::vector<int32_t> active, touched, grown, stamp(ns, 0);
  std::vector<double> scores;
  std::vector<double> alpha_buf(ns, kNeg), alpha_next_buf(ns, kNeg);
  double* alpha = alpha_buf.data();
  double* alpha_new = alpha_next_buf.data();
  int32_t epoch = 0;
  int64_t em_n = 0, eps_n = 0, alev_n = 0;
  bool overflow = false;

  auto emit_level = [&](const double* a, int64_t level) {
    alev_ptr[level] = alev_n;
    for (int32_t s : active) {
      if (a[s] <= kNeg / 2) continue;
      if (alev_n < alev_cap) {
        alev_states[alev_n] = s;
        alev_vals[alev_n] = a[s];
      } else {
        overflow = true;
      }
      ++alev_n;
    }
    alev_ptr[level + 1] = alev_n;
  };

  alpha[start] = 0.0;
  active.push_back(static_cast<int32_t>(start));
  grown.clear();
  {
    std::vector<int32_t> frontier = active;
    EpsClosure::run(ns, eps_ptr_csr, eps_dst, eps_w, num_em, alpha,
                    nullptr, frontier, kNeg, grown, stamp, epoch);
  }
  for (int32_t s : grown)
    if (alpha[s] > kNeg / 2) active.push_back(s);
  std::sort(active.begin(), active.end());
  active.erase(std::unique(active.begin(), active.end()), active.end());

  auto record_eps = [&](const double* a, int64_t level) {
    eps_ptr[level] = eps_n;
    for (int32_t s : active) {
      if (a[s] <= kNeg / 2) continue;
      for (int64_t e = eps_ptr_csr[s]; e < eps_ptr_csr[s + 1]; ++e) {
        const int32_t d = eps_dst[e];
        if (a[d] <= kNeg / 2) continue;
        if (a[s] + eps_w[e] >= a[d] - lattice_beam) {
          if (eps_n < eps_cap) eps_ids[eps_n] = e;
          else overflow = true;
          ++eps_n;
        }
      }
    }
    eps_ptr[level + 1] = eps_n;
  };
  emit_level(alpha, 0);
  record_eps(alpha, 0);

  std::vector<int32_t> prev_active;
  for (int64_t t = 0; t < T; ++t) {
    const double* em_t = em + t * K;
    prev_active = active;
    touched.clear();
    ++epoch;
    for (int32_t s : prev_active) {
      const double base = alpha[s];
      for (int64_t a = em_ptr_csr[s]; a < em_ptr_csr[s + 1]; ++a) {
        const double cand = base + em_w[a] + em_t[em_pdf[a]];
        const int32_t d = em_dst[a];
        if (stamp[d] != epoch) {
          stamp[d] = epoch;
          touched.push_back(d);
          alpha_new[d] = cand;
        } else if (cand > alpha_new[d]) {
          alpha_new[d] = cand;
        }
      }
    }
    if (touched.empty()) return -(t + 1);

    double best = kNeg;
    for (int32_t d : touched) best = std::max(best, alpha_new[d]);
    double cutoff = best - beam;
    if (max_active > 0) {
      int64_t above = 0;
      for (int32_t d : touched)
        if (alpha_new[d] > cutoff) ++above;
      if (above > max_active) {
        scores.clear();
        for (int32_t d : touched) scores.push_back(alpha_new[d]);
        std::nth_element(scores.begin(),
                         scores.end() - max_active, scores.end());
        cutoff = std::max(cutoff, *(scores.end() - max_active));
      }
    }
    active.clear();
    for (int32_t d : touched) {
      if (alpha_new[d] < cutoff) {
        alpha_new[d] = kNeg;
      } else if (alpha_new[d] > kNeg / 2) {
        active.push_back(d);
      }
    }
    std::sort(active.begin(), active.end());
    grown.clear();
    {
      std::vector<int32_t> frontier = active;
      EpsClosure::run(ns, eps_ptr_csr, eps_dst, eps_w, num_em,
                      alpha_new, nullptr, frontier, cutoff, grown,
                      stamp, epoch);
    }
    if (!grown.empty()) {
      for (int32_t s : grown) active.push_back(s);
      std::sort(active.begin(), active.end());
      active.erase(std::unique(active.begin(), active.end()),
                   active.end());
    }
    em_ptr[t] = em_n;
    for (int32_t s : prev_active) {
      const double base = alpha[s];
      for (int64_t a = em_ptr_csr[s]; a < em_ptr_csr[s + 1]; ++a) {
        const int32_t d = em_dst[a];
        const double ds = alpha_new[d];
        if (ds <= kNeg / 2) continue;
        if (base + em_w[a] + em_t[em_pdf[a]] >= ds - lattice_beam) {
          if (em_n < em_cap) em_ids[em_n] = a;
          else overflow = true;
          ++em_n;
        }
      }
    }
    em_ptr[t + 1] = em_n;
    emit_level(alpha_new, t + 1);
    record_eps(alpha_new, t + 1);

    // roll: clear ONLY the previous level's live entries (O(active),
    // not O(ns)) and swap the rows
    for (int32_t s : prev_active) alpha[s] = kNeg;
    std::swap(alpha, alpha_new);
  }
  return overflow ? 1 : 0;
}
