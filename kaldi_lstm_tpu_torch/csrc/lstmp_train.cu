// LSTMP training forward with residuals (K1) and its BPTT backward (K2),
// float32 throughout with float32 accumulation.
//
// K1 replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_fwd_kernel. Over T steps
// (gate order g, i, f, o; Kaldi weight orientation):
//
//   xw  = x_t Wx^T, times keep_mask_t * inv_keep when dropout is on,
//         then + bias                            (dropout before the bias)
//   pre = xw + r_{t-1} Wr^T
//   g = tanh(g_pre), i = sigmoid(i_pre + c_{t-1} p_i),
//   f = sigmoid(f_pre + c_{t-1} p_f)
//   c = clip(g i + c_{t-1} f, +-cell_clip)           (no clip if <= 0)
//   o = sigmoid(o_pre + c_t p_o)                     (clipped c_t)
//   r = (tanh(c_t) o) Wrm^T
//
// and writes the POST-activation gates g, i, f, o, the clipped c and r for
// every t (the residuals K2 reads). Two launches per step on the caller's
// stream, as in lstmp_infer.cu: gates (a thread owns one (stream, cell)
// pair, x_t and r_{t-1} rows of the block's 8 streams staged in shared
// memory), then the projection.
//
// K2 replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_bwd_kernel. A grid has
// no carry from block to block, so it is split in two:
//   (a) a serial reverse loop over t, two launches per step:
//       bwd_cell:  dr_total = g_r[t] + dr, with dr the sum of the previous
//                  step's split-K partials taken in a fixed order;
//                  dm = dr_total Wrm; the gate gradients (from the
//                  post-activation residuals); the dc carry through f and
//                  the i/f peepholes, straight through the clip. Writes
//                  dgifo[t], dr_total[t], h o = tanh(c) o [t] and, with a
//                  keep-mask, dxw[t] = dgifo[t] * mask * inv_keep.
//       dr:        dr = dgifo[t] Wr on the tensor cores (tc_gemm.cuh's
//                  3xTF32 mainloop, 64 x 64 tiles), split over the 4C
//                  contraction into `sp_dr` partials so that the step
//                  fills the card at S=256 (32 tiles x 9 splits).
//   (b) after the loop, the frame-axis contractions over N = T*S rows on
//       the same mainloop, each from operands materialised in (a):
//       dWx = dxw^T x, dWr = dgifo^T r_prev (r_prev = [r0; r_seq[:T-1]]
//       copied contiguous by two cudaMemcpyAsync), dWrm = dr_total^T (h o),
//       and dx = dxw Wx when asked; a product with too few 64 x 64 tiles
//       to fill the card (dWx at I=40: 50) is split over its contraction
//       too. dbias and the three peephole sums come from col_reduce. One
//       last launch adds every product's partials in split order and
//       writes dr0.
//   No atomics: every output value is one thread's sum in a fixed order,
//   so the gradients are the same from run to run. The split counts come
//   from the caller (ops/lstm_train.py::bwd_plan), which also sizes the
//   partial buffers.
//
// What bounds them on an H100: operations. At the flagship shape (T=20,
// S=256, I=40, C=800, R=512) K1 does 22.3 GFLOP and K2 43.3 GFLOP of f32
// multiply-adds against a few hundred MB of residual traffic. K1 is the
// simple design: CUDA-core fma from shared-memory tiles, weights served
// from L2, two launches a step. K2 puts 39.1 GFLOP of products on the
// tensor cores (3 TF32 mma per product, float32-accurate); what stays on
// the CUDA cores is bwd_cell's dm product (2 N R C = 4.2 GFLOP) and the
// serial chain of 2T launches.
//
// Built with nvcc into a shared library with a plain C entry point per
// kernel, loaded by kaldi_lstm_tpu_torch/ops/lstm_train.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "tc_gemm.cuh"

namespace {

constexpr int kCells = 32;    // threadIdx.x: cells / output columns
constexpr int kStreams = 8;   // threadIdx.y: streams per block
constexpr int kChunk = 512;   // staged K elements per stream and pass

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// K1: one step of the forward
// ---------------------------------------------------------------------------

// x_t [S, I], r_prev [S, R], w_cat [(I + R), 4C] = [Wx^T; Wr^T], bias [4C],
// peep [3, C] (i, f, o), c_prev [S, C], mask_t [S, 4C] int8 or null.
// Out: gifo_t [S, 4C] (activations), c_t [S, C], m [S, C] = tanh(c_t) o.
__global__ void train_gates_kernel(const float* __restrict__ x_t,
                                   const float* __restrict__ r_prev,
                                   const float* __restrict__ w_cat,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ peep,
                                   const float* __restrict__ c_prev,
                                   const int8_t* __restrict__ mask_t,
                                   float inv_keep,
                                   float* __restrict__ gifo_t,
                                   float* __restrict__ c_t,
                                   float* __restrict__ m,
                                   int S, int I, int R, int C,
                                   float cell_clip) {
  __shared__ float rows[kStreams][kChunk];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (j < C) && (s < S);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  // phase 0 contracts x_t with Wx^T, phase 1 r_{t-1} with Wr^T; the
  // dropout mask and the bias land between the two, as in _fwd_kernel
  for (int phase = 0; phase < 2; ++phase) {
    const float* src = phase == 0 ? x_t : r_prev;
    const int K = phase == 0 ? I : R;
    const float* wbase = w_cat + (phase == 0 ? 0 : (size_t)I * C4);
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kn = min(kChunk, K - k0);
      for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
        const int ss = e / kn;
        const int kk = e % kn;
        const int sg = s0 + ss;
        rows[ss][kk] = (sg < S) ? src[(size_t)sg * K + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (active) {
        const float* w = wbase + (size_t)k0 * C4 + j;
        #pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float v = rows[sl][kk];
          acc[0] = fmaf(v, w[0], acc[0]);
          acc[1] = fmaf(v, w[C], acc[1]);
          acc[2] = fmaf(v, w[2 * (size_t)C], acc[2]);
          acc[3] = fmaf(v, w[3 * (size_t)C], acc[3]);
          w += C4;
        }
      }
      __syncthreads();
    }
    if (phase == 0 && active) {
      #pragma unroll
      for (int g = 0; g < 4; ++g) {
        float xw = acc[g];
        if (mask_t != nullptr) {
          xw = xw * ((float)mask_t[(size_t)s * C4 + (size_t)g * C + j] *
                     inv_keep);
        }
        acc[g] = xw + bias[(size_t)g * C + j];
      }
    }
  }
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const float cp = c_prev[idx];
  const float g = tanhf(acc[0]);
  const float i = sigmoid_f(acc[1] + cp * peep[j]);
  const float f = sigmoid_f(acc[2] + cp * peep[C + j]);
  float cn = g * i + cp * f;
  if (cell_clip > 0.f) {
    // written out (not fminf/fmaxf) so that a NaN propagates like clip
    cn = cn < -cell_clip ? -cell_clip : (cn > cell_clip ? cell_clip : cn);
  }
  const float o = sigmoid_f(acc[3] + cn * peep[2 * C + j]);
  float* gr = gifo_t + (size_t)s * C4;
  gr[j] = g;
  gr[C + j] = i;
  gr[2 * (size_t)C + j] = f;
  gr[3 * (size_t)C + j] = o;
  c_t[idx] = cn;
  m[idx] = tanhf(cn) * o;
}

// out[s, q] = sum_k a[s, k] w[k, q] for s < S, q < Q, k < K: a [S, K],
// w [K, Q] row-major: the K1 projection (a = m, w = Wrm^T).
__global__ void rows_times_mat_kernel(const float* __restrict__ a,
                                      const float* __restrict__ w,
                                      float* __restrict__ out,
                                      int S, int K, int Q) {
  __shared__ float rows[kStreams][kChunk];
  const int q = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (q < Q) && (s < S);
  float acc = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
      const int ss = e / kn;
      const int sg = s0 + ss;
      rows[ss][e % kn] = (sg < S) ? a[(size_t)sg * K + k0 + e % kn] : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* wp = w + (size_t)k0 * Q + q;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        acc = fmaf(rows[sl][kk], *wp, acc);
        wp += Q;
      }
    }
    __syncthreads();
  }
  if (active) out[(size_t)s * Q + q] = acc;
}

// ---------------------------------------------------------------------------
// K2 (a): one step of the reverse recurrence
// ---------------------------------------------------------------------------

// g_r_t [S, R] (cotangent of r_t from the layer above); drp [ndrp, S, R]
// the split-K partials of dr (gradient into r_t through step t+1), added
// in order (no partials: dr = 0); wrm [R, C] (Kaldi orientation), gifo_t
// [S, 4C] activations, c_t and c_prev [S, C], peep [3, C], mask_t [S, 4C]
// int8 or null; dc [S, C] in: gradient into c_t from step t+1, out: into
// c_{t-1}. Out: dgifo_t [S, 4C] pre-activation gradients, drt_t [S, R]
// dr_total, ho_t [S, C] = tanh(c_t) o, and with a mask dxw_t [S, 4C] =
// dgifo_t * mask_t * inv_keep.
__global__ void bwd_cell_kernel(const float* __restrict__ g_r_t,
                                const float* __restrict__ drp, int ndrp,
                                const float* __restrict__ wrm,
                                const float* __restrict__ gifo_t,
                                const float* __restrict__ c_t,
                                const float* __restrict__ c_prev,
                                const float* __restrict__ peep,
                                const int8_t* __restrict__ mask_t,
                                float inv_keep,
                                float* __restrict__ dc,
                                float* __restrict__ dgifo_t,
                                float* __restrict__ drt_t,
                                float* __restrict__ ho_t,
                                float* __restrict__ dxw_t,
                                int S, int R, int C) {
  __shared__ float rows[kStreams][kChunk];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const size_t SR = (size_t)S * R;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (j < C) && (s < S);
  float dm = 0.f;

  for (int k0 = 0; k0 < R; k0 += kChunk) {
    const int kn = min(kChunk, R - k0);
    for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
      const int ss = e / kn;
      const int kk = e % kn;
      const int sg = s0 + ss;
      float v = 0.f;
      if (sg < S) {
        const size_t o = (size_t)sg * R + k0 + kk;
        float dr = 0.f;
        for (int p = 0; p < ndrp; ++p) dr += drp[p * SR + o];
        v = g_r_t[o] + dr;
        if (blockIdx.x == 0) drt_t[o] = v;   // one writer per row
      }
      rows[ss][kk] = v;
    }
    __syncthreads();
    if (active) {
      const float* w = wrm + (size_t)k0 * C + j;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        dm = fmaf(rows[sl][kk], *w, dm);
        w += C;
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const float* gr = gifo_t + (size_t)s * C4;
  const float g = gr[j];
  const float i = gr[C + j];
  const float f = gr[2 * (size_t)C + j];
  const float o = gr[3 * (size_t)C + j];
  const float c = c_t[idx];
  const float cp = c_prev[idx];
  const float h = tanhf(c);
  const float dh = dm * o;
  const float dc_from_h = dh * (1.0f - h * h);
  const float d_o = dm * h * o * (1.0f - o);
  // straight-through clip: dc flows through the forward clip unchanged
  const float dc_total = dc[idx] + dc_from_h + d_o * peep[2 * C + j];
  const float df = dc_total * cp * f * (1.0f - f);
  const float di = dc_total * g * i * (1.0f - i);
  const float dg = dc_total * i * (1.0f - g * g);
  const float dgate[4] = {dg, di, df, d_o};
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t at = (size_t)s * C4 + (size_t)q * C + j;
    dgifo_t[at] = dgate[q];
    if (dxw_t != nullptr) {
      dxw_t[at] = dgate[q] * ((float)mask_t[at] * inv_keep);
    }
  }
  ho_t[idx] = h * o;
  dc[idx] = dc_total * f + di * peep[j] + df * peep[C + j];
}

// ---------------------------------------------------------------------------
// K2: products on the tensor cores
// ---------------------------------------------------------------------------

// out[p][m][n] = sum over k in split p of A(m, k) B(n, k), m < M, n < N,
// with A(m, k) = a[m lda + k] (A K-major) or a[k lda + m], B likewise;
// split p covers k in [p kchunk, (p + 1) kchunk), kchunk a multiple of
// 32. One CTA per (64 x 64 tile, split) walks its split in order.
struct Contract {
  const float* a;
  int lda;
  const float* b;
  int ldb;
  float* out;
  int M, N, K, kchunk;
};

template <bool AK, bool BK>
using TileGemm = tc::Gemm<64, 64, 2, 2, AK, BK>;

template <class G>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int rows,
                                           int cols, int m0, int n0,
                                           const typename G::Acc& acc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = G::warp_m0(), wn0 = G::warp_n0();
  #pragma unroll
  for (int i = 0; i < G::kMT; ++i) {
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + 16 * i + g + 8 * h;
      if (m >= rows) continue;
      #pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const int n = n0 + wn0 + 8 * j + 2 * t;
        if (n < cols) out[(size_t)m * cols + n] = acc[i][j][2 * h];
        if (n + 1 < cols) out[(size_t)m * cols + n + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <bool AK, bool BK, bool VA, bool VB>
__global__ void __launch_bounds__(TileGemm<AK, BK>::kThreads)
contract_tc_kernel(Contract c) {
  using G = TileGemm<AK, BK>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const int k0 = blockIdx.z * c.kchunk;
  const int kext = min(c.kchunk, c.K - k0);
  float* out = c.out + (size_t)blockIdx.z * c.M * c.N;
  if (kext <= 0) {              // an empty split contributes zeros
    typename G::Acc acc;
    tc::zero(acc);
    store_tile<G>(out, c.M, c.N, m0, n0, acc);
    return;
  }
  const tc::Operand A{AK ? c.a + k0 : c.a + (size_t)k0 * c.lda, c.lda, c.M,
                      kext};
  const tc::Operand B{BK ? c.b + k0 : c.b + (size_t)k0 * c.ldb, c.ldb, c.N,
                      kext};
  G::template run<VA, VB>(
      smem, A, B, m0, n0, 1,
      [&](int, typename G::Acc& acc) {
        store_tile<G>(out, c.M, c.N, m0, n0, acc);
      },
      [](const float*, const float*) {});
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out = A B over `splits` consecutive ranges of k: out holds `splits`
// partial products [splits][M][N] (the product itself when splits = 1).
template <bool AK, bool BK>
cudaError_t contract(cudaStream_t st, const float* a, int lda,
                     const float* b, int ldb, float* out, int M, int N,
                     int K, int splits) {
  using G = TileGemm<AK, BK>;
  splits = std::max(1, splits);
  const int ksteps = (K + tc::kBK - 1) / tc::kBK;
  const int per = (ksteps + splits - 1) / splits;
  const Contract c{a, lda, b, ldb, out, M, N, K, per * tc::kBK};
  const bool va = lda % 4 == 0 && aligned16(a);
  const bool vb = ldb % 4 == 0 && aligned16(b);
  auto kernel = va ? (vb ? contract_tc_kernel<AK, BK, true, true>
                         : contract_tc_kernel<AK, BK, true, false>)
                   : (vb ? contract_tc_kernel<AK, BK, false, true>
                         : contract_tc_kernel<AK, BK, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + G::kBM - 1) / G::kBM, (N + G::kBN - 1) / G::kBN,
                  splits);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(c);
  return cudaGetLastError();
}

// out[i] = sum_p part[p][i] for p = 0, 1, ... in order, one segment per
// blockIdx.y; a segment with count 0 is skipped.
struct Seg {
  const float* part;
  float* out;
  int parts;
  int count;
};
constexpr int kSegs = 5;
struct Segs {
  Seg s[kSegs];
};

__global__ void reduce_parts_kernel(Segs segs) {
  const Seg sg = segs.s[blockIdx.y];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < sg.count;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int p = 0; p < sg.parts; ++p) v += sg.part[(size_t)p * sg.count + i];
    sg.out[i] = v;
  }
}

constexpr int kRedCols = 32;   // columns per block
constexpr int kRedRows = 8;    // row groups per column, summed in order

// Column sums over the N = T*S frame rows of dgifo [N, 4C]:
//   col < 4C:        dbias[col] = sum_n dgifo[n, col]
//   col = 4C + w*C + j (w = 0, 1, 2):
//                    dpeep[w, j] = sum_n dgifo[n, (w+1)C + j] * cc(n, j)
//   with cc = c_{t-1} for the i and f peepholes (c0 at t = 0) and the
//   clipped c_t for the o peephole.
// Each thread sums one column over the rows n = rg (mod 8), then the 8
// partial sums are added in a fixed order: reproducible.
__global__ void col_reduce_kernel(const float* __restrict__ dgifo,
                                  const float* __restrict__ c_seq,
                                  const float* __restrict__ c0,
                                  float* __restrict__ dbias,
                                  float* __restrict__ dpeep,
                                  int N, int S, int C) {
  __shared__ float part[kRedRows][kRedCols];
  const int cl = threadIdx.x % kRedCols;
  const int rg = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + cl;
  const size_t C4 = 4 * (size_t)C;
  float acc = 0.f;
  if (col < 7 * C) {
    if (col < (int)C4) {
      for (int n = rg; n < N; n += kRedRows) acc += dgifo[(size_t)n * C4 + col];
    } else {
      const int q = col - (int)C4;
      const int w = q / C;
      const int j = q % C;
      const float* gcol = dgifo + (size_t)(w + 1) * C + j;
      for (int n = rg; n < N; n += kRedRows) {
        float cc;
        if (w == 2) {
          cc = c_seq[(size_t)n * C + j];
        } else {
          cc = n < S ? c0[(size_t)n * C + j] : c_seq[(size_t)(n - S) * C + j];
        }
        acc += gcol[(size_t)n * C4] * cc;
      }
    }
  }
  part[rg][cl] = acc;
  __syncthreads();
  if (rg != 0 || col >= 7 * C) return;
  float sum = 0.f;
  #pragma unroll
  for (int g = 0; g < kRedRows; ++g) sum += part[g][cl];
  if (col < (int)C4) {
    dbias[col] = sum;
  } else {
    dpeep[col - (int)C4] = sum;
  }
}

}  // namespace

// K1. Runs the T-step forward on `stream`: 2 launches per step, no
// synchronisation, no allocation. x [T, S, I] time-major; w_cat
// [(I + R), 4C] = [Wx^T; Wr^T]; wrm_t [C, R] = Wrm^T; mask [T, S, 4C] int8
// or null. Out: gifo [T, S, 4C] (g, i, f, o activations), c_out [T, S, C],
// r_out [T, S, R]; m is [S, C] scratch. Returns cudaGetLastError().
extern "C" int lstmp_train_fwd_f32(const float* x, const float* w_cat,
                                   const float* bias, const float* peep,
                                   const float* wrm_t, const float* c0,
                                   const float* r0, const int8_t* mask,
                                   float inv_keep, float* gifo, float* c_out,
                                   float* r_out, float* m, int T, int S,
                                   int I, int C, int R, float cell_clip,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kCells, kStreams);
  const int sblocks = (S + kStreams - 1) / kStreams;
  const dim3 grid_a((C + kCells - 1) / kCells, sblocks);
  const dim3 grid_b((R + kCells - 1) / kCells, sblocks);
  const size_t x_step = (size_t)S * I;
  const size_t g_step = (size_t)S * 4 * C;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  for (int t = 0; t < T; ++t) {
    const float* r_prev = (t == 0) ? r0 : r_out + (t - 1) * r_step;
    const float* c_prev = (t == 0) ? c0 : c_out + (t - 1) * c_step;
    const int8_t* mask_t = mask ? mask + t * g_step : nullptr;
    train_gates_kernel<<<grid_a, block, 0, st>>>(
        x + t * x_step, r_prev, w_cat, bias, peep, c_prev, mask_t, inv_keep,
        gifo + t * g_step, c_out + t * c_step, m, S, I, R, C, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_times_mat_kernel<<<grid_b, block, 0, st>>>(m, wrm_t,
                                                    r_out + t * r_step,
                                                    S, C, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}


// K2. Residuals as K1 wrote them (gifo, c_seq, r_seq [T, S, .]), the
// chunk's initial state c0 [S, C], r0 [S, R], x [T, S, I], the weights in
// Kaldi orientation (w_gifo_x [4C, I], w_gifo_r [4C, R], w_r_m [R, C]),
// peep [3, C], mask [T, S, 4C] int8 or null. g_r [T, S, R] is the
// cotangent of every r_t, the final r's already added at T-1.
// In/out: dc [S, C] holds the final c's cotangent on entry and dc0 on
// return. Out: dr [S, R] = dr0.
// Scratch: dgifo [T, S, 4C], drt [T, S, R], ho [T, S, C], dxw [T, S, 4C]
// (with a mask, else null), r_prev [T, S, R], drp [sp_dr, S, R], and the
// partials of each frame-axis product split in more than one (part_wx
// [sp_wx, 4C, I], part_wr [sp_wr, 4C, R], part_wrm [sp_wrm, R, C],
// part_dx [sp_dx, T S, I]; null where the split count is 1).
// Out: dx [T, S, I] (skipped when null), dwx [4C, I], dwr [4C, R],
// dwrm [R, C], dbias [4C], dpeep [3, C].
// 2T + 5 launches (+1 with dx). Returns a CUDA error code (0 on success).
extern "C" int lstmp_train_bwd_f32(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* w_r_m, const float* peep, const float* c0, const float* r0,
    const float* gifo, const float* c_seq, const float* r_seq,
    const int8_t* mask, float inv_keep, const float* g_r, float* dc,
    float* dr, float* dgifo, float* drt, float* ho, float* dxw,
    float* r_prev, float* drp, float* part_wx, float* part_wr,
    float* part_wrm, float* part_dx, float* dx, float* dwx, float* dwr,
    float* dwrm, float* dbias, float* dpeep, int T, int S, int I, int C,
    int R, int sp_dr, int sp_wx, int sp_wr, int sp_wrm, int sp_dx,
    void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 || sp_dr < 1 ||
      sp_wx < 1 || sp_wr < 1 || sp_wrm < 1 || sp_dx < 1 ||
      (mask != nullptr) != (dxw != nullptr) ||
      (sp_wx > 1 && part_wx == nullptr) ||
      (sp_wr > 1 && part_wr == nullptr) ||
      (sp_wrm > 1 && part_wrm == nullptr) ||
      (dx != nullptr && sp_dx > 1 && part_dx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kCells, kStreams);
  const int sblocks = (S + kStreams - 1) / kStreams;
  const dim3 grid_cell((C + kCells - 1) / kCells, sblocks);
  const size_t C4 = 4 * (size_t)C;
  const size_t g_step = (size_t)S * C4;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  cudaError_t err;
  for (int t = T - 1; t >= 0; --t) {
    const float* c_prev = (t == 0) ? c0 : c_seq + (t - 1) * c_step;
    bwd_cell_kernel<<<grid_cell, block, 0, st>>>(
        g_r + t * r_step, drp, t == T - 1 ? 0 : sp_dr, w_r_m,
        gifo + t * g_step, c_seq + t * c_step, c_prev, peep,
        mask ? mask + t * g_step : nullptr, inv_keep, dc, dgifo + t * g_step,
        drt + t * r_step, ho + t * c_step, dxw ? dxw + t * g_step : nullptr,
        S, R, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dr [S, R] = dgifo[t] [S, 4C] Wr [4C, R], split over 4C
    err = contract<true, false>(st, dgifo + t * g_step, 4 * C, w_gifo_r, R,
                                drp, S, R, 4 * C, sp_dr);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int N = T * S;
  const float* dxw_or_dgifo = dxw ? dxw : dgifo;   // dropout: dx, dWx only
  err = cudaMemcpyAsync(r_prev, r0, r_step * sizeof(float),
                        cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess && T > 1) {
    err = cudaMemcpyAsync(r_prev + r_step, r_seq,
                          (T - 1) * r_step * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWx [4C, I] = dxw^T x
  err = contract<false, false>(st, dxw_or_dgifo, 4 * C, x, I,
                               sp_wx > 1 ? part_wx : dwx, 4 * C, I, N,
                               sp_wx);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWr [4C, R] = dgifo^T r_prev
  err = contract<false, false>(st, dgifo, 4 * C, r_prev, R,
                               sp_wr > 1 ? part_wr : dwr, 4 * C, R, N,
                               sp_wr);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWrm [R, C] = dr_total^T (h o)
  err = contract<false, false>(st, drt, R, ho, C,
                               sp_wrm > 1 ? part_wrm : dwrm, R, C, N,
                               sp_wrm);
  if (err != cudaSuccess) return static_cast<int>(err);
  col_reduce_kernel<<<(7 * C + kRedCols - 1) / kRedCols,
                      kRedCols * kRedRows, 0, st>>>(dgifo, c_seq, c0, dbias,
                                                    dpeep, N, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dx != nullptr) {
    // dx [N, I] = dxw Wx
    err = contract<true, false>(st, dxw_or_dgifo, 4 * C, w_gifo_x, I,
                                sp_dx > 1 ? part_dx : dx, N, I, 4 * C,
                                sp_dx);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the partials of every split product, and dr0 from the last step's
  auto seg = [](const float* part, float* out, int parts, size_t count) {
    return Seg{part, out, parts, parts > 1 ? static_cast<int>(count) : 0};
  };
  Segs segs{{seg(drp, dr, sp_dr, r_step), seg(part_wx, dwx, sp_wx, C4 * I),
             seg(part_wr, dwr, sp_wr, C4 * R),
             seg(part_wrm, dwrm, sp_wrm, (size_t)R * C),
             seg(part_dx, dx, dx ? sp_dx : 1, (size_t)N * I)}};
  segs.s[0].count = static_cast<int>(r_step);
  int most = 0;
  for (const Seg& sg : segs.s) most = std::max(most, sg.count);
  const int blocks = std::min((most + 255) / 256, 1024);
  reduce_parts_kernel<<<dim3(blocks, kSegs), 256, 0, st>>>(segs);
  return static_cast<int>(cudaGetLastError());
}
