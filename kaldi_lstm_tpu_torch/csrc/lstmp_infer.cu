// LSTMP inference forward (projected LSTM with peepholes and cell clip),
// float32 throughout with float32 accumulation (lstmp_infer_f32), or with
// bf16 weights and operands (lstmp_infer_bf16, below): one persistent,
// weight-resident cooperative launch per call.
//
// Replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_infer_kernel (the TPU
// kernel behind lstm_scan_pallas's primal, via _infer_call): over T steps
// it computes
//
//   gifo = x_t Wx^T + b + r_{t-1} Wr^T          (gate order g, i, f, o)
//   i = sigmoid(i_pre + c_{t-1} p_i),  f = sigmoid(f_pre + c_{t-1} p_f)
//   c = clip(tanh(g_pre) i + c_{t-1} f, +-cell_clip)   (no clip if <= 0)
//   o = sigmoid(o_pre + c_t p_o)                 (peephole on clipped c_t)
//   r = (tanh(c_t) o) Wrm^T
//
// and writes r for every t and the final c. The final r is r[T-1].
//
// Design. The grid is one CTA per SM (at most), launched cooperatively
// (cudaLaunchKernelExC with cudaLaunchAttributeCooperative, which a CUDA
// graph can capture), so every CTA is resident and the grid-wide
// barrier cannot hang: a grid that cannot be co-resident is refused at
// launch and the wrapper raises. The barrier is a counter in device memory
// (zeroed on the stream before the launch): after a __syncthreads, thread 0
// of each CTA adds to it with release semantics and polls it with acquire
// loads (one round trip to L2 fewer than cooperative_groups' grid sync,
// which fences, adds with a returned value and then polls).
// CTA b owns
//   * cells [b ncell, (b + 1) ncell): the four gate columns of each in
//     [Wx^T; Wr^T] ([I + R, 4C]), kept in shared memory as [I + R][cell][4]
//     for the whole call, with the cells' bias, peepholes and c state;
//   * projection columns [b nq, (b + 1) nq) of Wrm^T ([C, R]), kept as
//     [C][column] in quads of 4 columns.
// At I=40, C=800, R=512 on 132 SMs that is 7 cells (62 KB) and 4 columns
// (13 KB) a CTA; at the deep layer 2's I=512, 115 KB + 13 KB; all the
// weights (8.7 MB / 14.7 MB) stay on chip for the whole call. What does not
// fit a CTA's shared memory (the weight slices of a wide input, from
// I ~ 860 at C=800, R=512; the c state of very many streams) is read from
// device memory by the same kernel instead.
// Each step:
//   gates phase: for each tile of up to 64 streams, the CTA copies
//     [x_t | r_{t-1}] into shared memory with cp.async (two buffers: the
//     next chunk of k is in flight while the current one is summed). A
//     unit of 8 streams x (4 gates of one cell) is summed by KS threads
//     over k = ks (mod KS), KS the largest power of two that keeps the
//     units within 256 threads, so that even S=8 keeps 224 threads busy;
//     the sums of a warp's lanes are added by a fixed xor butterfly of
//     warp shuffles (those of a unit's warps, where KS > 32, in warp order
//     through shared memory), and lane ks does the gate math of streams
//     i = ks (mod KS): c updated, m = tanh(c) o written;
//   grid barrier;
//   projection phase: the same product over all of m, a unit being 8
//     streams x 4 projection columns, writing the CTA's columns of r_t;
//   grid barrier.
// No atomic adds into any result (the barrier's counter is the only atomic),
// and every sum runs in a fixed order, so results repeat from run to run.
// Data other CTAs wrote (m, r) reaches shared memory through cp.async.cg or
// ld.global.cg, from L2, never from a stale L1 line.
//
// What bounds it on an H100: at the serving shape (S=8) neither bytes nor
// operations (35 MFLOP a step) but latency: the 2T grid barriers and the
// per-step round trips to L2 (every CTA stages all of r_{t-1} and all of
// m, 17.7 + 25.6 KB at S=8). The design removes the per-step launches
// and the weight re-reads of the two-launches-a-step design it replaces,
// splits each CTA's contraction over its threads, keeps the copies
// asynchronous (one round trip per chunk), keeps what the gate math reads
// (bias, peepholes, c) in shared memory, and makes each barrier one
// release-add and a poll. At S=256 the per-step L2 traffic (every CTA
// reads the 565 KB of [x | r] and the 819 KB of m) and the f32 FMA rate
// bound it.
//
// bf16 (lstmp_infer_bf16, the --bf16 cross-validation pass): the
// kaldi_lstm_tpu/ops/lstm_pallas.py primal under set_matmul_dtype
// (bfloat16) casts x, Wx, r_{t-1}, Wr, tanh(c) o and Wrm before its dots
// and sums in f32. lstmp_infer_tc_kernel keeps the persistent,
// weight-resident cooperative launch and the grid barrier above, and runs
// both products on the bf16 tensor cores (pk::mma_product, mma.sync
// m16n8k16 with f32 sums): the CTA's weight slices sit in shared memory as
// bf16 rows, laid out for ldmatrix as the A operand (gate rows 4 c + g,
// 4 ncell = whole m16 tiles; 16 projection columns a tile), the streams
// are the n8 tiles (S=8 is exactly one). Every operand is rounded once:
// the weights as the CTA loads its slices (once a call), x into a bf16
// copy in the launch's prologue, m by the gates epilogue (a bf16 copy in
// place of the f32 m), r_t by the projection epilogue (a bf16 copy beside
// the f32 r_out the caller gets; written before the grid barrier that
// publishes it, read from L2 as the f32 r). So a step stages bf16 rows,
// half the bytes, and rounds nothing in a loop. The projection splits
// its work over streams too (make_tc_plan): 32 column groups x 4 stream
// groups at S=256, R=512, so a CTA stages 64 streams of m, not 256. The
// cut-over to weights in device memory (bf16 copies made in the same
// prologue, read through L2) is at I ~ 1540 at C=800, R=512.
// The gates split their streams in two groups from S=128 (make_tc_plan),
// so that a gate CTA stages half the streams of [x_t | r_{t-1}].
// What bounds it on an H100: at S=8 latency, as above (two grid barriers
// and two L2 round trips a step); at S=256 the products' loop first,
// then the staging and the epilogues (tools/bench_infer_parts.py cuts
// each part out); a warp summing all its m16 tiles of an n8 tile at
// once, with conflict-free partial sums, measured no faster.
//
// Advance mask (lstmp_infer_masked_f32 / _bf16, the sticky server's ragged
// ticks; kaldi_lstm_tpu/ops/lstm_cell.py::lstm_scan's advance_mask): a
// byte mask at any strides, 0 where stream s must keep its state through
// step t. Every stream still runs its arithmetic; the gates epilogue
// writes c only where the mask is set, and the projection epilogue writes
// r_{t-1} (read from L2: other threads wrote it before the last grid
// barrier) into row t where it is not, so that the next step and the
// final state read the carried r. Each epilogue call reads its stream's
// byte (through the read-only cache: the threads of a CTA that own that
// stream's cells or projection quads all read it). Two grid barriers a
// step, as without the mask.
//
// The block product, the cell math, the grid barrier and the cooperative
// launch live in csrc/persistent.cuh, shared with K7's two-layer
// wavefront (csrc/lstmp_stack.cu).
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/lstm_infer.py through ctypes; that module's
// `k5_plan` and `lstm_infer_sliced_plain` mirror the plan and the sums.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "persistent.cuh"
#include "precision.cuh"

namespace {

using pk::kStageFloats;
using pk::kThreads;
using pk::kUnitFloats;
using pk::kWarps;
using pk::round4;

struct Params {
  const float* x;       // [T, S, I]
  const float* w_cat;   // [I + R, 4C] = [Wx^T; Wr^T]
  const float* bias;    // [4C]
  const float* peep;    // [3, C]
  const float* wrm_t;   // [C, R]
  const float* r0;      // [S, R]
  float* c;             // [S, C] in/out
  float* m;             // [S, C] scratch
  float* r_out;         // [T, S, R]
  int T, S, I, C, R;
  float cell_clip;
  int ncell, nq;        // cells / projection columns per CTA
  int wld, qld;         // row strides of the resident slices (floats)
  int cst_smem;         // the cells' bias and peepholes in shared memory
  int c_smem;           // the cells' c state in shared memory
  unsigned* bar;        // grid barrier arrivals, zero at launch
  const unsigned char* amask;  // advance mask at (t, s), or null (all set)
  long long mts, mss;          // its strides (bytes) along t and along s
};

template <bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
lstmp_infer_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int C = p.C, R = p.R, S = p.S, I = p.I;
  float* stage = reinterpret_cast<float*>(smem4);
  float* cst = stage + kStageFloats;                      // [7][ncell]
  float* cs = cst + (p.cst_smem ? round4(7 * (size_t)p.ncell) : 0);
  float* wg = cs + (p.c_smem ? round4((size_t)S * p.ncell) : 0);
  const int K = p.I + p.R;                                // wg: [K][wld]
  float* wq = wg + (size_t)K * p.wld;                     // [C][qld]
  const size_t C4 = 4 * (size_t)C;
  const int j0 = blockIdx.x * p.ncell;
  const int nc = max(0, min(p.ncell, C - j0));
  const int q0 = blockIdx.x * p.nq;
  const int nqc = max(0, min(p.nq, R - q0));
  const int nquad = (nqc + 3) / 4;

  // The epilogue reads bias gate g of cell c at bsrc[g bstr + c], peephole
  // w at psrc[w bstr + c] and c state at csrc[s cstr + c]: from shared
  // memory where the plan placed them there (copied in here, c copied
  // back at the end), else from device memory.
  const float* bsrc = p.bias + j0;
  const float* psrc = p.peep + j0;
  int bstr = C;
  if (p.cst_smem) {
    for (int e = threadIdx.x; e < 7 * nc; e += kThreads) {
      const int g = e / nc, c = e % nc;
      cst[g * p.ncell + c] = g < 4 ? p.bias[(size_t)g * C + j0 + c]
                                   : p.peep[(size_t)(g - 4) * C + j0 + c];
    }
    bsrc = cst;
    psrc = cst + 4 * p.ncell;
    bstr = p.ncell;
  }
  float* csrc = p.c + j0;
  int cstr = C;
  if (p.c_smem) {
    for (int e = threadIdx.x; e < S * nc; e += kThreads) {
      cs[(e / nc) * p.ncell + e % nc] = p.c[(size_t)(e / nc) * C + j0 + e % nc];
    }
    csrc = cs;
    cstr = p.ncell;
  }

  if (RESIDENT) {
    for (int e = threadIdx.x; e < K * nc * 4; e += kThreads) {
      const int k = e / (nc * 4), rem = e % (nc * 4);
      const int c = rem / 4, g = rem % 4;
      wg[(size_t)k * p.wld + 4 * c + g] =
          p.w_cat[(size_t)k * C4 + (size_t)g * C + j0 + c];
    }
    // the last quad's columns past nqc are zero
    for (int e = threadIdx.x; e < C * 4 * nquad; e += kThreads) {
      const int k = e / (4 * nquad), q = e % (4 * nquad);
      wq[(size_t)k * p.qld + q] =
          q < nqc ? p.wrm_t[(size_t)k * R + q0 + q] : 0.f;
    }
    // (block_product synchronises before its first read)
  }

  auto load_wg = [&](int k, int c, float (&w)[4]) {
    if (RESIDENT) {
      pk::load4(wg + (size_t)k * p.wld + 4 * c, w);
    } else {
      const float* row = p.w_cat + (size_t)k * C4 + j0 + c;
      #pragma unroll
      for (int g = 0; g < 4; ++g) {
        w[g] = __ldg(row + (size_t)g * C);
      }
    }
  };
  auto load_wq = [&](int k, int quad, float (&w)[4]) {
    if (RESIDENT) {
      pk::load4(wq + (size_t)k * p.qld + 4 * quad, w);
    } else {
      #pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int q = 4 * quad + g;
        w[g] = q < nqc ? __ldg(p.wrm_t + (size_t)k * R + q0 + q) : 0.f;
      }
    }
  };

  pk::GridBarrier grid{p.bar, 0};
  const size_t r_step = (size_t)S * R;
  int t = 0;
  // whether stream s advances at step t: one byte load in each epilogue
  // call, i.e. for every (t, s) once per cell (gates) and once per quad of
  // projection columns (projection) that the CTA owns; the threads of a
  // stream read the same byte, so after the first these hit L1 (the mask
  // is read-only for the whole launch)
  auto advances = [&](int s) {
    return p.amask == nullptr ||
           __ldg(p.amask + t * p.mts + s * p.mss) != 0;
  };
  for (t = 0; t < p.T; ++t) {
    const float* x_t = p.x + (size_t)t * S * I;
    const float* r_prev = t == 0 ? p.r0 : p.r_out + (size_t)(t - 1) * r_step;
    float* r_t = p.r_out + (size_t)t * r_step;

    if (nc > 0) {
      pk::block_product<VEC>(
          stage, pk::kBufFloats, S, K, nc,
          [&](int s, int k) {
            return k < I ? x_t + (size_t)s * I + k
                         : r_prev + (size_t)s * R + (k - I);
          },
          pk::FullRange{K}, load_wg,
          [&](int s, int c, const float (&a)[4]) {
            float* cp = csrc + (size_t)s * cstr + c;
            const float c_prev = *cp;
            float cn;
            const float mv = pk::cell_step(
                a[0] + bsrc[c], a[1] + bsrc[bstr + c],
                a[2] + bsrc[2 * bstr + c], a[3] + bsrc[3 * bstr + c], c_prev,
                psrc[c], psrc[bstr + c], psrc[2 * bstr + c], p.cell_clip,
                &cn);
            // a masked stream keeps its c; its m is written all the
            // same, and the projection epilogue discards what it gives
            if (advances(s)) *cp = cn;
            p.m[(size_t)s * C + j0 + c] = mv;
          });
    }
    grid.sync();
    if (nquad > 0) {
      pk::block_product<VEC>(
          stage, pk::kBufFloats, S, C, nquad,
          [&](int s, int k) { return p.m + (size_t)s * C + k; },
          pk::FullRange{C}, load_wq,
          [&](int s, int quad, const float (&a)[4]) {
            // a masked stream carries r_{t-1} into row t, where the next
            // step (and the caller, at t = T-1) reads the carried r;
            // r_{t-1} was written before the last grid barrier: from L2
            const bool adv = advances(s);
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int q = 4 * quad + g;
              if (q < nqc) {
                const size_t e = (size_t)s * R + q0 + q;
                r_t[e] = adv ? a[g] : __ldcg(r_prev + e);
              }
            }
          });
    }
    grid.sync();
  }
  if (p.c_smem) {   // every thread passed the last barrier
    for (int e = threadIdx.x; e < S * nc; e += kThreads) {
      p.c[(size_t)(e / nc) * C + j0 + e % nc] = cs[(e / nc) * p.ncell + e % nc];
    }
  }
}

struct Plan {
  int grid, ncell, nq, wld, qld, smem, resident, sms, cst_smem, c_smem;
};

// One CTA per SM at most: cells and projection columns are dealt out in
// equal slices of ceil(C / SMs) and ceil(R / SMs).
cudaError_t make_plan(int S, int I, int C, int R, Plan* pl) {
  if (S <= 0 || I <= 0 || C <= 0 || R <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  const cudaError_t err = pk::device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  pl->sms = sms;
  pl->ncell = (C + sms - 1) / sms;
  pl->nq = (R + sms - 1) / sms;
  pl->grid = std::max((C + pl->ncell - 1) / pl->ncell,
                      (R + pl->nq - 1) / pl->nq);
  // strides in elements (4 per cell or per quad of projection columns, an
  // odd number of quads) that keep the weight reads of neighbouring k on
  // distinct banks: 16 bytes a read, an odd multiple of it a row
  const int nquad = (pl->nq + 3) / 4;
  pl->wld = 4 * pl->ncell + (pl->ncell % 2 == 0 ? 4 : 0);
  pl->qld = 4 * nquad + (nquad % 2 == 0 ? 4 : 0);
  // shared memory, each part where it still fits, in this order: the
  // staging buffers, the cells' bias and peepholes, the weight slices, the
  // cells' c state (laid out as stage | bias, peepholes | c | weights)
  const size_t room = static_cast<size_t>(optin) / sizeof(float);
  const size_t cst = round4(7 * (size_t)pl->ncell);
  const size_t welems = (size_t)(I + R) * pl->wld + (size_t)C * pl->qld;
  const size_t weights = welems;
  const size_t cstate = round4((size_t)S * pl->ncell);
  size_t used = kStageFloats;
  pl->cst_smem = used + cst <= room;
  if (pl->cst_smem) used += cst;
  pl->resident = used + weights <= room;
  if (pl->resident) used += weights;
  pl->c_smem = used + cstate <= room;
  if (pl->c_smem) used += cstate;
  pl->smem = static_cast<int>(used * sizeof(float));
  return cudaSuccess;
}

int infer_f32(const float* x, const float* w_cat, const float* bias,
              const float* peep, const float* wrm_t, const float* r0,
              float* c, float* m, float* r_out, unsigned* bar, int T, int S,
              int I, int C, int R, float cell_clip,
              const unsigned char* amask, long long mts, long long mss,
              void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = make_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging copies need every row of x, r and m 16-byte aligned
  const bool vec = I % 4 == 0 && R % 4 == 0 && C % 4 == 0;
  const void* kernel =
      pl.resident
          ? (vec ? reinterpret_cast<const void*>(
                       lstmp_infer_kernel<true, true>)
                 : reinterpret_cast<const void*>(
                       lstmp_infer_kernel<true, false>))
          : (vec ? reinterpret_cast<const void*>(
                       lstmp_infer_kernel<false, true>)
                 : reinterpret_cast<const void*>(
                       lstmp_infer_kernel<false, false>));
  Params prm{x, w_cat, bias, peep, wrm_t, r0, c, m, r_out, T, S, I, C, R,
             cell_clip, pl.ncell, pl.nq, pl.wld, pl.qld, pl.cst_smem,
             pl.c_smem, bar, amask, mts, mss};
  void* args[] = {&prm};
  return static_cast<int>(pk::launch_cooperative(
      kernel, pl.grid, pl.smem, pl.sms, bar, args,
      static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// K5 in bf16: the persistent recurrence on the bf16 tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTileStreams = 64;   // streams a staged tile holds at most

__host__ __device__ __forceinline__ int up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The bf16 kernel's plan (ops/lstm_infer.py::k5_bf16_plan mirrors it).
struct TcPlan {
  int grid, sms;
  int ncell, gcgroups, gsgroups, gnsg, gate_ctas, mg;
                                   // cells a CTA (a multiple of 4), cell
                                   // groups, stream groups, streams a
                                   // group (a multiple of 8), CTAs with
                                   // cells, gate rows 4 ncell
  int mq, qgroups, sgroups, nsg;   // projection columns a CTA (a multiple
                                   // of 16), column groups, stream groups,
                                   // streams a group (a multiple of 8)
  int ip, rp, kg, ksg;             // x, r padded to 8; the gate
                                   // contraction [x | r] padded to 16;
                                   // its staged and resident row stride
  int cp, kq, ksq;                 // m padded to 8; the projection
                                   // contraction padded to 16; row stride
  int ns_g, ns_q;                  // streams a staged tile, each phase
  int resident, c_smem;
  int part_floats, stage_elems;    // partial sums; one staging buffer
  int off_cst, off_c, off_w, off_stage, smem;   // bytes
};

// The plan with the gate streams in gs groups. Gates: the CTAs of a
// stream group take ncell = ceil(C gs / SMs) cells each, rounded up to a
// multiple of 4 (4 ncell rows fill whole m16 tiles). Projection: columns
// in groups of mq = 16 (one m16 tile; more only when R > 16 SMs), and the
// streams in as many groups of nsg (a multiple of 8) as the SMs left over
// by the column groups allow: at S=256, R=512 32 x 4 CTAs each stage 64
// streams of m, not all 256. Shared memory, in this order of precedence:
// the partial sums and the cells' bias and peepholes; the weight slices
// (resident) if they leave room for two 8-stream staging tiles; the
// cells' c state; the rest to the staging tiles (at most 64 streams, the
// tiles of a group as even as multiples of 8 allow).
cudaError_t tc_plan_for(int S, int I, int C, int R, int sms, int optin,
                        int gs, TcPlan* pl) {
  TcPlan q{};
  q.sms = sms;
  q.ncell = up((C + sms / gs - 1) / (sms / gs), 4);
  q.gcgroups = (C + q.ncell - 1) / q.ncell;
  q.gnsg = up((S + gs - 1) / gs, 8);
  q.gsgroups = (S + q.gnsg - 1) / q.gnsg;
  q.gate_ctas = q.gcgroups * q.gsgroups;
  q.mg = 4 * q.ncell;
  q.mq = 16 * (((R + 15) / 16 + sms - 1) / sms);
  q.qgroups = (R + q.mq - 1) / q.mq;
  q.sgroups = std::max(1, std::min(sms / q.qgroups, (S + 7) / 8));
  q.nsg = up((S + q.sgroups - 1) / q.sgroups, 8);
  q.sgroups = (S + q.nsg - 1) / q.nsg;
  q.grid = std::max(q.gate_ctas, q.qgroups * q.sgroups);
  q.ip = up(I, 8);
  q.rp = up(R, 8);
  q.kg = up(q.ip + q.rp, 16);
  q.ksg = q.kg + 8;
  q.cp = up(C, 8);
  q.kq = up(q.cp, 16);
  q.ksq = q.kq + 8;
  q.part_floats = kUnitFloats * kWarps *
                  std::max(1, std::max(q.mg, q.mq) / 16);
  const long long part = 4LL * q.part_floats;
  const long long cst = 4LL * up(7 * q.ncell, 4);
  const long long cstate = 4LL * up(q.gnsg * q.ncell, 4);
  const long long wbytes =
      up(2 * (q.mg * q.ksg + q.mq * q.ksq), 16);
  const int ksmax = std::max(q.ksg, q.ksq);
  const long long stage_min = 2LL * 2 * 8 * ksmax;
  long long used = part + cst;
  q.resident = used + wbytes + stage_min <= optin;
  if (q.resident) used += wbytes;
  q.c_smem = used + cstate + stage_min <= optin;
  if (q.c_smem) used += cstate;
  const long long avail = optin - used;
  if (avail < stage_min) return cudaErrorInvalidValue;
  // tiles of at most what fits, as even as multiples of 8 allow
  auto even = [](int n, long long most) {
    const int tiles = static_cast<int>((n + most - 1) / most);
    return up((n + tiles - 1) / tiles, 8);
  };
  q.ns_g = even(q.gnsg, std::min<long long>(kTileStreams,
                                            avail / (4LL * q.ksg) / 8 * 8));
  q.ns_q = even(q.nsg, std::min<long long>(kTileStreams,
                                           avail / (4LL * q.ksq) / 8 * 8));
  q.stage_elems = std::max(q.ns_g * q.ksg, q.ns_q * q.ksq);
  q.off_cst = static_cast<int>(part);
  q.off_c = static_cast<int>(part + cst);
  q.off_w = q.off_c + (q.c_smem ? static_cast<int>(cstate) : 0);
  q.off_stage = q.off_w + (q.resident ? static_cast<int>(wbytes) : 0);
  q.smem = q.off_stage + 2 * 2 * q.stage_elems;
  *pl = q;
  return cudaSuccess;
}

// One gate stream group, or two from S = 128 on where that plan keeps the
// weights resident with tiles of 32 streams or more: every gate CTA
// stages every stream of [x_t | r_{t-1}] each step, so two groups halve
// that L2 traffic (29 to 15 MB a step at S=256, I=40) for twice the
// weight rows a CTA.
cudaError_t make_tc_plan(int S, int I, int C, int R, int sms, int optin,
                         TcPlan* pl) {
  if (S <= 0 || I <= 0 || C <= 0 || R <= 0 || sms < 2) {
    return cudaErrorInvalidValue;
  }
  if (S >= 128) {
    TcPlan two;
    if (tc_plan_for(S, I, C, R, sms, optin, 2, &two) == cudaSuccess &&
        two.resident && two.ns_g >= 32) {
      *pl = two;
      return cudaSuccess;
    }
  }
  return tc_plan_for(S, I, C, R, sms, optin, 1, pl);
}

struct TcParams {
  const float* x;       // [T, S, I]
  const float* wx;      // [4C, I]  (Kaldi orientation, as the params hold
  const float* wr;      // [4C, R]   them: the CTA reads its rows once)
  const float* bias;    // [4C]
  const float* peep;    // [3, C]
  const float* wrm;     // [R, C]
  const float* r0;      // [S, R]
  float* c;             // [S, C] in/out
  float* r_out;         // [T, S, R]
  bf16* xb;             // [T, S, ip] x rounded, once a call
  bf16* rb;             // [S, rp] r_{t-1} rounded (the projection writes it)
  bf16* mb;             // [S, cp] m = tanh(c) o rounded (the gates write it)
  bf16* wg;             // [grid, mg, kg], [grid, mq, kq]: the weight slices
  bf16* wq;             //   rounded, where they are not resident; else null
  int T, S, I, C, R;
  float cell_clip;
  TcPlan pl;
  unsigned* bar;
  const unsigned char* amask;
  long long mts, mss;
};

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
lstmp_infer_tc_kernel(TcParams p) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const TcPlan& pl = p.pl;
  const int C = p.C, R = p.R, S = p.S, I = p.I;
  const int tid = threadIdx.x, b = blockIdx.x;
  float* part = reinterpret_cast<float*>(sm);
  float* cst = reinterpret_cast<float*>(sm + pl.off_cst);   // [7][ncell]
  bf16* stage = reinterpret_cast<bf16*>(sm + pl.off_stage);

  // this CTA's cells and their streams, its projection columns and
  // their streams
  const int j0 = (b % pl.gcgroups) * pl.ncell;
  const int nc = b < pl.gate_ctas ? min(pl.ncell, C - j0) : 0;
  const int sg0 = b < pl.gate_ctas ? (b / pl.gcgroups) * pl.gnsg : 0;
  const int sg1 = b < pl.gate_ctas ? min(S, sg0 + pl.gnsg) : 0;
  const bool proj = b < pl.qgroups * pl.sgroups;
  const int q0 = (b % pl.qgroups) * pl.mq;
  const int nqc = proj ? min(pl.mq, R - q0) : 0;
  const int sq0 = proj ? (b / pl.qgroups) * pl.nsg : 0;
  const int sq1 = proj ? min(S, sq0 + pl.nsg) : 0;

  // the weight slices in bf16, rounded once: gate row m = 4 c + g (gate g
  // of cell j0 + c) over k in the padded [x | r] layout, projection row q
  // (column q0 + q) over the cells; zero where there is no weight
  bf16* wg = RESIDENT ? reinterpret_cast<bf16*>(sm + pl.off_w)
                      : p.wg + (size_t)b * pl.mg * pl.kg;
  const int wgld = RESIDENT ? pl.ksg : pl.kg;
  bf16* wq = RESIDENT ? wg + (size_t)pl.mg * pl.ksg
                      : p.wq + (size_t)b * pl.mq * pl.kq;
  const int wqld = RESIDENT ? pl.ksq : pl.kq;
  // (row by row, neighbouring threads on neighbouring k; 8 loads a
  // thread in flight: the weights come from device memory)
  if (nc > 0) {
    pk::batched_fill(pl.mg * pl.kg, [&](int e) {
      const int m = e / pl.kg, k = e % pl.kg, c = m >> 2, g = m & 3;
      const size_t row = (size_t)g * C + j0 + c;
      if (c >= nc) return 0.f;
      if (k < I) return __ldg(p.wx + row * I + k);
      if (k >= pl.ip && k - pl.ip < R) {
        return __ldg(p.wr + row * R + (k - pl.ip));
      }
      return 0.f;
    }, [&](int e, float v) {
      wg[(size_t)(e / pl.kg) * wgld + e % pl.kg] = __float2bfloat16_rn(v);
    });
  }
  if (nqc > 0) {
    pk::batched_fill(pl.mq * pl.kq, [&](int e) {
      const int m = e / pl.kq, k = e % pl.kq;
      return m < nqc && k < C ? __ldg(p.wrm + (size_t)(q0 + m) * C + k)
                              : 0.f;
    }, [&](int e, float v) {
      wq[(size_t)(e / pl.kq) * wqld + e % pl.kq] = __float2bfloat16_rn(v);
    });
  }
  for (int e = tid; e < 7 * nc; e += kThreads) {
    const int g = e / nc, c = e % nc;
    cst[g * pl.ncell + c] = g < 4 ? p.bias[(size_t)g * C + j0 + c]
                                  : p.peep[(size_t)(g - 4) * C + j0 + c];
  }
  // the c state of (stream sg0 + i, cell j0 + c) at csrc[i cstr + c]
  float* csrc = p.c + (size_t)sg0 * C + j0;
  int cstr = C;
  if (pl.c_smem) {
    float* cs = reinterpret_cast<float*>(sm + pl.off_c);
    for (int e = tid; e < (sg1 - sg0) * nc; e += kThreads) {
      cs[(e / nc) * pl.ncell + e % nc] =
          p.c[(size_t)(sg0 + e / nc) * C + j0 + e % nc];
    }
    csrc = cs;
    cstr = pl.ncell;
  }
  // the bf16 copies every CTA stages: x (once a call), r0, and the zero
  // padding of r and m (the epilogues write only the real columns)
  {
    const size_t gt = (size_t)gridDim.x * kThreads;
    const size_t gi = (size_t)b * kThreads + tid;
    const size_t nx = (size_t)p.T * S * pl.ip;
    for (size_t e = gi; e < nx; e += gt) {
      const int k = static_cast<int>(e % pl.ip);
      p.xb[e] = __float2bfloat16_rn(k < I ? p.x[(e / pl.ip) * I + k] : 0.f);
    }
    for (size_t e = gi; e < (size_t)S * pl.rp; e += gt) {
      const int k = static_cast<int>(e % pl.rp);
      p.rb[e] = __float2bfloat16_rn(k < R ? p.r0[(e / pl.rp) * R + k] : 0.f);
    }
    const int mpad = pl.cp - C;
    for (size_t e = gi; e < (size_t)S * mpad; e += gt) {
      p.mb[(e / mpad) * pl.cp + C + e % mpad] = __float2bfloat16_rn(0.f);
    }
  }
  pk::GridBarrier grid{p.bar, 0};
  grid.sync();   // the copies are complete, the slices in place

  int t = 0;
  auto advances = [&](int s) {
    return p.amask == nullptr ||
           __ldg(p.amask + t * p.mts + s * p.mss) != 0;
  };
  const size_t r_step = (size_t)S * R;
  for (t = 0; t < p.T; ++t) {
    const float* r_prev = t == 0 ? p.r0 : p.r_out + (size_t)(t - 1) * r_step;
    float* r_t = p.r_out + (size_t)t * r_step;
    if (nc > 0) {
      const bf16* x_t = p.xb + (size_t)t * S * pl.ip;
      pk::mma_product<RESIDENT>(
          stage, pl.stage_elems, part, sg0, sg1, pl.ns_g, pl.ksg, pl.kg / 16,
          wg, wgld, pl.mg / 16,
          [&](bf16* buf, int s0, int sn) {
            const int nch = pl.kg / 8;
            const int total = up(sn, 8) * nch;
            for (int e = tid; e < total; e += kThreads) {
              const int sl = e / nch, k = (e % nch) * 8;
              const bf16* src = p.xb;
              int bytes = 0;
              if (sl < sn) {
                const int s = s0 + sl;
                if (k < pl.ip) {
                  src = x_t + (size_t)s * pl.ip + k;
                  bytes = 16;
                } else if (k < pl.ip + pl.rp) {
                  src = p.rb + (size_t)s * pl.rp + (k - pl.ip);
                  bytes = 16;
                }
              }
              pk::cp_async16z(buf + (size_t)sl * pl.ksg + k, src, bytes);
            }
            pk::cp_async_commit();
          },
          [&](int s0, int sn, const pk::MmaSum& sum) {
            for (int e = tid; e < sn * nc; e += kThreads) {
              const int sl = e / nc, c = e % nc, s = s0 + sl;
              float* cp = csrc + (size_t)(s - sg0) * cstr + c;
              const float c_prev = *cp;
              float cn;
              const float* bs = cst + c;
              const int bstr = pl.ncell;
              const float mv = pk::cell_step(
                  sum(4 * c, sl) + bs[0], sum(4 * c + 1, sl) + bs[bstr],
                  sum(4 * c + 2, sl) + bs[2 * bstr],
                  sum(4 * c + 3, sl) + bs[3 * bstr], c_prev, bs[4 * bstr],
                  bs[5 * bstr], bs[6 * bstr], p.cell_clip, &cn);
              // a masked stream keeps its c; its m is written all the
              // same, and the projection epilogue discards what it gives
              if (advances(s)) *cp = cn;
              p.mb[(size_t)s * pl.cp + j0 + c] = __float2bfloat16_rn(mv);
            }
          });
    }
    grid.sync();
    if (nqc > 0) {
      pk::mma_product<RESIDENT>(
          stage, pl.stage_elems, part, sq0, sq1, pl.ns_q, pl.ksq, pl.kq / 16,
          wq, wqld, pl.mq / 16,
          [&](bf16* buf, int s0, int sn) {
            const int nch = pl.kq / 8;
            const int total = up(sn, 8) * nch;
            for (int e = tid; e < total; e += kThreads) {
              const int sl = e / nch, k = (e % nch) * 8;
              const bool ok = sl < sn && k < pl.cp;
              pk::cp_async16z(buf + (size_t)sl * pl.ksq + k,
                              ok ? p.mb + (size_t)(s0 + sl) * pl.cp + k
                                 : p.mb,
                              ok ? 16 : 0);
            }
            pk::cp_async_commit();
          },
          [&](int s0, int sn, const pk::MmaSum& sum) {
            for (int e = tid; e < sn * nqc; e += kThreads) {
              const int sl = e / nqc, q = e % nqc, s = s0 + sl;
              const size_t at = (size_t)s * R + q0 + q;
              const float v = sum(q, sl);
              // a masked stream carries r_{t-1} into row t (and keeps its
              // rounded copy); r_{t-1} was written before the last grid
              // barrier: from L2
              if (advances(s)) {
                r_t[at] = v;
                p.rb[(size_t)s * pl.rp + q0 + q] = __float2bfloat16_rn(v);
              } else {
                r_t[at] = __ldcg(r_prev + at);
              }
            }
          });
    }
    grid.sync();
  }
  if (pl.c_smem) {   // every thread passed the last barrier
    const float* cs = reinterpret_cast<const float*>(sm + pl.off_c);
    for (int e = tid; e < (sg1 - sg0) * nc; e += kThreads) {
      p.c[(size_t)(sg0 + e / nc) * C + j0 + e % nc] =
          cs[(e / nc) * pl.ncell + e % nc];
    }
  }
}

int infer_bf16(const float* x, const float* wx, const float* wr,
               const float* bias, const float* peep, const float* wrm,
               const float* r0,
               float* c, float* r_out, bf16* xb, bf16* rb, bf16* mb, bf16* wg,
               bf16* wq, unsigned* bar, int T, int S, int I, int C, int R,
               float cell_clip, const unsigned char* amask, long long mts,
               long long mss, void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  cudaError_t err = pk::device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  TcPlan pl;
  err = make_tc_plan(S, I, C, R, sms, optin, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!pl.resident && (wg == nullptr || wq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel =
      pl.resident ? reinterpret_cast<const void*>(
                        lstmp_infer_tc_kernel<true>)
                  : reinterpret_cast<const void*>(
                        lstmp_infer_tc_kernel<false>);
  TcParams prm{x, wx, wr, bias, peep, wrm, r0, c, r_out, xb, rb, mb, wg, wq,
               T, S, I, C, R, cell_clip, pl, bar, amask, mts, mss};
  void* args[] = {&prm};
  return static_cast<int>(pk::launch_cooperative(
      kernel, pl.grid, pl.smem, pl.sms, bar, args,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The f32 kernel's launch plan for these widths on the current device:
// out[0..9] = grid, cells per CTA, projection columns per CTA, gate-slice
// stride, projection-slice stride, dynamic shared memory bytes, weights
// resident (1) or read from device memory (0), SM count, the cells' bias
// and peepholes in shared memory (1) or not, their c state in shared
// memory (1) or not. Returns a CUDA error code.
extern "C" int lstmp_infer_plan(int S, int I, int C, int R, int* out) {
  Plan pl;
  const cudaError_t err = make_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[10] = {pl.grid, pl.ncell, pl.nq, pl.wld, pl.qld, pl.smem,
                     pl.resident, pl.sms, pl.cst_smem, pl.c_smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The bf16 kernel's plan on the current device (sms, optin <= 0) or on a
// card with those limits: out[0..29] = TcPlan's fields in order
// (ops/lstm_infer.py::BF16_PLAN_KEYS). Returns a CUDA error code.
extern "C" int lstmp_infer_bf16_plan(int S, int I, int C, int R, int sms,
                                     int optin, int* out) {
  if (sms <= 0 || optin <= 0) {
    const cudaError_t err = pk::device_limits(&sms, &optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  TcPlan pl;
  const cudaError_t err = make_tc_plan(S, I, C, R, sms, optin, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(sizeof(TcPlan) == 30 * sizeof(int), "30 int fields");
  const int* v = reinterpret_cast<const int*>(&pl);
  for (int i = 0; i < 30; ++i) out[i] = v[i];
  return 0;
}
// Runs the T-step recurrence on `stream` as one cooperative launch: no
// synchronisation, no allocation. x [T, S, I] time-major; c holds c0 on
// entry and the final c on return; m is [S, C] scratch; r_out [T, S, R];
// bar is one unsigned of scratch for the grid barrier, zeroed on `stream`
// here before the launch (a call's own: concurrent calls need their own).
// Returns a CUDA error code (0 on success): a grid that cannot be
// co-resident is refused, never run.
extern "C" int lstmp_infer_f32(const float* x, const float* w_cat,
                               const float* bias, const float* peep,
                               const float* wrm_t, const float* r0,
                               float* c, float* m, float* r_out,
                               unsigned* bar, int T, int S, int I, int C,
                               int R, float cell_clip, void* stream) {
  return infer_f32(x, w_cat, bias, peep, wrm_t, r0, c, m, r_out, bar, T, S,
                   I, C, R, cell_clip, nullptr, 0, 0, stream);
}

// K5 in bf16 (the --bf16 cross-validation pass): x, bias, peep, r0, c
// and r_out as for lstmp_infer_f32, the weights as the params hold them
// (w_gifo_x [4C, I], w_gifo_r [4C, R], w_r_m [R, C]; the kernel rounds
// its slices once as it loads them), and bf16 scratch in place of m: xb
// [T, S, ld8(I)], rb [S, ld8(R)], mb [S, ld8(C)] (ld8: padded to a
// multiple of 8), and where the plan does not keep the weights resident
// wg [grid, mg, kg] and wq [grid, mq, kq] (the plan's fields; null
// otherwise). Products on the bf16 tensor cores, sums and state f32.
extern "C" int lstmp_infer_bf16(const float* x, const float* w_gifo_x,
                                const float* w_gifo_r, const float* bias,
                                const float* peep, const float* w_r_m,
                                const float* r0, float* c, float* r_out,
                                __nv_bfloat16* xb, __nv_bfloat16* rb,
                                __nv_bfloat16* mb, __nv_bfloat16* wg,
                                __nv_bfloat16* wq, unsigned* bar, int T,
                                int S, int I, int C, int R, float cell_clip,
                                void* stream) {
  return infer_bf16(x, w_gifo_x, w_gifo_r, bias, peep, w_r_m, r0, c, r_out,
                    xb, rb, mb, wg, wq, bar, T, S, I, C, R, cell_clip,
                    nullptr, 0, 0, stream);
}

// K5 with per-frame state gating (the sticky server's ragged ticks): the
// arguments of lstmp_infer_f32 and amask, a 0/1 byte mask on the device
// whose entry (t, s) is amask[t mts + s mss] (so a [S, T] batch-major mask
// needs no transpose). Where it is 0 stream s keeps its (c, r) through step t:
// c is not written and r_out[t, s] holds r_{t-1} (r0 at t = 0), so the
// final state is (c, r_out[T-1]) as without a mask. Those rows are the
// carried r, not an output; callers discard them. For a 0/1 mask and
// finite values this is the blend a c_new + (1 - a) c_{t-1} of the plain
// scan; it selects instead of blending, so an inf in a masked stream's new
// state does not turn its carried state into NaN.
extern "C" int lstmp_infer_masked_f32(const float* x, const float* w_cat,
                                      const float* bias, const float* peep,
                                      const float* wrm_t, const float* r0,
                                      float* c, float* m, float* r_out,
                                      unsigned* bar, int T, int S, int I,
                                      int C, int R, float cell_clip,
                                      const unsigned char* amask,
                                      long long mts, long long mss,
                                      void* stream) {
  if (amask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return infer_f32(x, w_cat, bias, peep, wrm_t, r0, c, m, r_out, bar, T, S,
                   I, C, R, cell_clip, amask, mts, mss, stream);
}

// lstmp_infer_bf16 with the advance mask of lstmp_infer_masked_f32.
extern "C" int lstmp_infer_masked_bf16(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* bias, const float* peep, const float* w_r_m,
    const float* r0, float* c, float* r_out, __nv_bfloat16* xb,
    __nv_bfloat16* rb, __nv_bfloat16* mb, __nv_bfloat16* wg,
    __nv_bfloat16* wq, unsigned* bar, int T, int S, int I, int C, int R,
    float cell_clip, const unsigned char* amask, long long mts,
    long long mss, void* stream) {
  if (amask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return infer_bf16(x, w_gifo_x, w_gifo_r, bias, peep, w_r_m, r0, c, r_out,
                    xb, rb, mb, wg, wq, bar, T, S, I, C, R, cell_clip, amask,
                    mts, mss, stream);
}
