// Fused senone affine + softmax + masked cross-entropy, forward (K3) and
// backward (K4), float32 in and out, on Hopper's tensor cores: products
// float32-accurate (the _f32 entry points, below) or in bf16 (the _bf16
// ones, their own design at the end of this file).
//
// K3 replaces kaldi_lstm_tpu/ops/xent_pallas.py::_fwd_kernel (:51). For
// frames r [N, R] and the output layer W [K, R] (Kaldi orientation), b [K]:
//   z = r W^T + b, per row: lse = logsumexp(z), picked = sum_j tw[j] z[id_j],
//   the max of z and its FIRST index (Kaldi's FindRowMaxId).
// K4 replaces xent_pallas.py::_bwd_kernel (:148). With
//   dz = scale (wtot exp(z - lse) - sum_j tw_j onehot(id_j)),
// where scale is the loss cotangent times the frame mask and
// wtot = sum_j tw_j, it produces dr = dz W, dW = dz^T r and db = sum_n dz.
//
// What bounds them on an H100: operations. At the flagship shape
// (N = 5120, R = 512, K = 8000) one logits product is 2NKR = 41.9 GFLOP
// against ~18 MB of compulsory traffic. The Pallas kernels keep [N, K] out
// of HBM because the TPU is short of HBM bandwidth; this card is not: dz
// written once and read twice costs 3 x 164 MB, ~0.15 ms at 3.35 TB/s,
// where recomputing the logits costs another 41.9 GFLOP. So:
//
//   - every product runs through tc_gemm.cuh: cp.async-fed shared-memory
//     tiles and mma.sync TF32 in the 3xTF32 split, float32-accurate;
//   - K3, launch 1: CTA (128-frame row tile, chunk of `chunk` classes,
//     1024 from the wrapper) walks its chunk's 128-class tiles; the epilogue keeps, in registers,
//     each row's running max with its first index, sum of exp(z - max)
//     and weighted picked logit, then merges the warps of the CTA and
//     writes per-(chunk, row) partials. At the flagship shape that is
//     40 x 8 CTAs, at K = 16624 40 x 17, where one CTA per 128 rows would
//     leave the 132 SMs a third busy. The logits never reach memory.
//   - K3, launch 2: one thread per row merges the chunks in increasing
//     order with a strict > (so the first of tied maxima wins, as the
//     Pallas kernel's running argmax does) and writes lse, picked, amax,
//     aidx.
//   - K4, launch 1: the same logits walk with a dz epilogue, dz stored
//     once to a scratch [N, ldz] the wrapper allocates;
//     launch 2: dr = dz W in 128 x 64 tiles (320 CTAs at N = 5120, R = 512);
//     launch 3: dW = dz^T r in 128 x 128 tiles, walking the frame axis;
//     the CTAs of the first column of tiles also sum db from the dz tiles
//     they stage. Three products instead of the four of a design that
//     recomputes the logits in a dr pass and a dW pass.
//
// No float atomics and no split of a sum across CTAs: every output value
// is summed by one thread in a fixed order, so results repeat bit for bit
// from run to run. Rows with scale 0 (masked frames) give dz = 0 exactly:
// exp(z - lse) is at most ~1 for the row's own lse, so no inf * 0 arises
// from a large bias, and their dr rows are exactly 0. Frames past N and
// classes past K are masked in the kernels; nothing is padded.
//
// bf16 (the _bf16 entry points, the --bf16 path): see the bf16 section
// below.
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/xent_affine.py through ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "tc_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

// The logits tiles (K3, K4 launch 1) and dW: 128 x 128, 8 warps of
// 64 x 32, one CTA per SM (up to 255 registers a thread). dr: 128 x 64,
// 4 warps, two CTAs per SM. (4 warps of 64 x 64, two 128 x 64 CTAs per
// SM, or a 4-deep ring ran no faster on an H100.)
template <class P>
using LogitsGemmP = tc::Gemm<128, 128, 2, 4, true, true, P>;
template <class P>
using DwGemmP = tc::Gemm<128, 128, 2, 4, false, false, P>;
template <class P>
using DrGemmP = tc::Gemm<128, 64, 2, 2, true, false, P>;
// (the shapes, threads and shared memory do not depend on P)
using LogitsGemm = LogitsGemmP<tc::F32>;
using DwGemm = DwGemmP<tc::F32>;
using DrGemm = DrGemmP<tc::F32>;
using LAcc = LogitsGemm::Acc;
constexpr int kMT = LogitsGemm::kMT;
constexpr int kNT = LogitsGemm::kNT;
constexpr int kWN = LogitsGemm::kWarpN;
constexpr int kBM = LogitsGemm::kBM;
constexpr int kBN = LogitsGemm::kBN;
constexpr int kCombineThreads = 256;

struct Partials {
  float* v;   // [nch, N] chunk max
  float* s;   // [nch, N] sum of exp(z - chunk max)
  float* p;   // [nch, N] weighted picked logits inside the chunk
  int* i;     // [nch, N] first index of the chunk max
};

__device__ __forceinline__ Partials partials(float* part, int nch, int N) {
  const size_t plane = (size_t)nch * N;
  return {part, part + plane, part + 2 * plane,
          reinterpret_cast<int*>(part + 3 * plane)};
}

// (v, i, s) <- the merge of two (max, first index, sum of exp(z - max)).
__device__ __forceinline__ void merge(float& v, int& i, float& s, float v2,
                                      int i2, float s2) {
  const float m = fmaxf(v, v2);
  s = s * expf(v - m) + s2 * expf(v2 - m);
  if (v2 > v || (v2 == v && i2 < i)) i = i2;
  v = m;
}

// K3, launch 1. grid (ceil(N / 128), ceil(K / chunk)), 256 threads.
template <bool VEC, class P>
__global__ void __launch_bounds__(LogitsGemm::kThreads)
xent_fwd_chunk_kernel(const float* __restrict__ r,
                      const float* __restrict__ w,
                      const float* __restrict__ b,
                      const int* __restrict__ ids,
                      const float* __restrict__ tw, float* part, int N,
                      int R, int K, int Km, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = LogitsGemm::warp_m0(), wn0 = LogitsGemm::warp_n0();
  const int m0 = blockIdx.x * kBM;
  const int ch = blockIdx.y;
  const int c_begin = ch * chunk;
  const int c_end = min(K, c_begin + chunk);
  const int ntiles = (c_end - c_begin + kBN - 1) / kBN;

  // this thread's 8 rows: slot 2 i + h is row wm0 + 16 i + g + 8 h
  float bv[2 * kMT], bs[2 * kMT], bp[2 * kMT];
  int bi[2 * kMT];
  #pragma unroll
  for (int q = 0; q < 2 * kMT; ++q) {
    bv[q] = kNeg;
    bs[q] = 0.f;
    bp[q] = 0.f;
    bi[q] = kNoIndex;
  }

  auto epi = [&](int tile, LAcc& acc) {
    const int cw = c_begin + tile * kBN + wn0;   // the warp's first class
    float bias[kNT][2];
    bool ok[kNT][2];
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cw + 8 * j + 2 * t + e;
        ok[j][e] = c < c_end;
        bias[j][e] = ok[j][e] ? b[c] : 0.f;
      }
    }
    #pragma unroll
    for (int i = 0; i < kMT; ++i) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * i + h;
        float tmax = kNeg;
        int targ = kNoIndex;
        #pragma unroll
        for (int j = 0; j < kNT; ++j) {
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = acc[i][j][2 * h + e] + bias[j][e];
            acc[i][j][2 * h + e] = z;
            // columns rise with (j, e): strict > keeps the first max
            if (ok[j][e] && z > tmax) {
              tmax = z;
              targ = cw + 8 * j + 2 * t + e;
            }
          }
        }
        if (tmax > bv[q]) {     // tiles rise too: strict > across tiles
          bs[q] *= expf(bv[q] - tmax);
          bv[q] = tmax;
          bi[q] = targ;
        }
        float se = 0.f;
        #pragma unroll
        for (int j = 0; j < kNT; ++j) {
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ok[j][e]) se += expf(acc[i][j][2 * h + e] - bv[q]);
          }
        }
        bs[q] += se;
        const int n = m0 + wm0 + 16 * i + g + 8 * h;
        if (n < N) {
          for (int jj = 0; jj < Km; ++jj) {
            const int off = ids[(size_t)n * Km + jj] - (cw + 2 * t);
            if (off < 0 || off >= kWN || (off & 6) != 0) continue;
            // the target is one of this thread's columns of the tile
            float z = 0.f;
            #pragma unroll
            for (int j = 0; j < kNT; ++j) {
              #pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (off == 8 * j + e && ok[j][e]) z = acc[i][j][2 * h + e];
              }
            }
            bp[q] += tw[(size_t)n * Km + jj] * z;
          }
        }
      }
    }
  };

  const tc::Operand A{r, R, N, R};
  const tc::Operand B{w, R, K, R};
  LogitsGemmP<P>::template run<VEC, VEC>(smem, A, B, m0, c_begin, ntiles,
                                         epi,
                                         [](const float*, const float*) {});

  // merge the 4 lanes of a quad (they share rows), then the warps that
  // share rows, in a fixed order
  #pragma unroll
  for (int q = 0; q < 2 * kMT; ++q) {
    #pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv[q], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, bs[q], o);
      const float p2 = __shfl_xor_sync(0xffffffffu, bp[q], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi[q], o);
      merge(bv[q], bi[q], bs[q], v2, i2, s2);
      bp[q] += p2;
    }
  }
  constexpr int kWarpsN = kBN / kWN;
  float* red_v = smem;                  // [kWarpsN][kBM], smem is free now
  float* red_s = red_v + kWarpsN * kBM;
  float* red_p = red_s + kWarpsN * kBM;
  int* red_i = reinterpret_cast<int*>(red_p + kWarpsN * kBM);
  const int wn = wn0 / kWN;
  if (t == 0) {
    #pragma unroll
    for (int i = 0; i < kMT; ++i) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + 16 * i + g + 8 * h;
        const int q = 2 * i + h;
        red_v[wn * kBM + row] = bv[q];
        red_s[wn * kBM + row] = bs[q];
        red_p[wn * kBM + row] = bp[q];
        red_i[wn * kBM + row] = bi[q];
      }
    }
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row < kBM && m0 + row < N) {
    float v = red_v[row], s = red_s[row], p = red_p[row];
    int i = red_i[row];
    for (int k = 1; k < kWarpsN; ++k) {
      merge(v, i, s, red_v[k * kBM + row], red_i[k * kBM + row],
            red_s[k * kBM + row]);
      p += red_p[k * kBM + row];
    }
    const int nch = gridDim.y;
    const Partials P = partials(part, nch, N);
    const size_t o = (size_t)ch * N + m0 + row;
    P.v[o] = v;
    P.s[o] = s;
    P.p[o] = p;
    P.i[o] = i;
  }
}

// K3, launch 2: one thread per row merges the chunks in increasing order.
__global__ void xent_fwd_combine_kernel(const float* part, int nch, int N,
                                        float* __restrict__ lse,
                                        float* __restrict__ picked,
                                        float* __restrict__ amax,
                                        int* __restrict__ aidx) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Partials P = partials(const_cast<float*>(part), nch, N);
  float v = P.v[n], s = P.s[n], p = P.p[n];
  int i = P.i[n];
  for (int c = 1; c < nch; ++c) {
    const size_t o = (size_t)c * N + n;
    const float v2 = P.v[o];
    if (v2 > v) {               // strictly greater: the first max wins
      s = s * expf(v - v2) + P.s[o];
      v = v2;
      i = P.i[o];
    } else {
      s = s + P.s[o] * expf(v2 - v);
    }
    p += P.p[o];
  }
  lse[n] = v + logf(s);
  picked[n] = p;
  amax[n] = v;
  aidx[n] = i;
}

// K4, launch 1: the logits walk of K3 with a dz epilogue.
// grid (ceil(N / 128), ceil(K / chunk)), 256 threads.
template <bool VEC, class P>
__global__ void __launch_bounds__(LogitsGemm::kThreads)
xent_bwd_dz_kernel(const float* __restrict__ r, const float* __restrict__ w,
                   const float* __restrict__ b, const int* __restrict__ ids,
                   const float* __restrict__ tw,
                   const float* __restrict__ lse,
                   const float* __restrict__ scale,
                   const float* __restrict__ wtot, float* __restrict__ dz,
                   int ldz, int N, int R, int K, int Km, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* row_lse = smem + tc::kStages * LogitsGemm::kStageFloats;
  float* row_scale = row_lse + kBM;
  float* row_wtot = row_scale + kBM;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = LogitsGemm::warp_m0(), wn0 = LogitsGemm::warp_n0();
  const int m0 = blockIdx.x * kBM;
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(K, c_begin + chunk);
  const int ntiles = (c_end - c_begin + kBN - 1) / kBN;
  for (int e = threadIdx.x; e < kBM; e += LogitsGemm::kThreads) {
    const int n = m0 + e;
    row_lse[e] = n < N ? lse[n] : 0.f;
    row_scale[e] = n < N ? scale[n] : 0.f;
    row_wtot[e] = n < N ? wtot[n] : 0.f;
  }
  // (the mainloop synchronises the CTA before the first epilogue)

  auto epi = [&](int tile, LAcc& acc) {
    const int cw = c_begin + tile * kBN + wn0;
    float bias[kNT][2];
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cw + 8 * j + 2 * t + e;
        bias[j][e] = c < c_end ? b[c] : 0.f;
      }
    }
    #pragma unroll
    for (int i = 0; i < kMT; ++i) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + 16 * i + g + 8 * h;
        const int n = m0 + row;
        if (n >= N) continue;
        const float l = row_lse[row], wt = row_wtot[row];
        float d[kNT][2];
        #pragma unroll
        for (int j = 0; j < kNT; ++j) {
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            d[j][e] = expf(acc[i][j][2 * h + e] + bias[j][e] - l) * wt;
          }
        }
        for (int jj = 0; jj < Km; ++jj) {
          const int off = ids[(size_t)n * Km + jj] - (cw + 2 * t);
          if (off < 0 || off >= kWN || (off & 6) != 0) continue;
          const float tv = tw[(size_t)n * Km + jj];
          #pragma unroll
          for (int j = 0; j < kNT; ++j) {
            #pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (off == 8 * j + e) d[j][e] -= tv;
            }
          }
        }
        const float sc = row_scale[row];
        float* out = dz + (size_t)n * ldz;
        #pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = cw + 8 * j + 2 * t;   // even, ldz % 4 == 0
          if (c + 1 < c_end) {
            *reinterpret_cast<float2*>(out + c) =
                make_float2(d[j][0] * sc, d[j][1] * sc);
          } else if (c < c_end) {
            out[c] = d[j][0] * sc;
          }
        }
      }
    }
  };

  const tc::Operand A{r, R, N, R};
  const tc::Operand B{w, R, K, R};
  LogitsGemmP<P>::template run<VEC, VEC>(smem, A, B, m0, c_begin, ntiles,
                                         epi,
                                         [](const float*, const float*) {});
}

// Store a finished tile of out [rows, cols] (leading dimension ld).
template <class G>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int ld,
                                           int rows, int cols, int m0,
                                           int n0,
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
        if (n < cols) out[(size_t)m * ld + n] = acc[i][j][2 * h];
        if (n + 1 < cols) out[(size_t)m * ld + n + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// K4, launch 2: dr [N, R] = dz [N, K] W [K, R].
// grid (ceil(N / 128), ceil(R / 64)), 128 threads.
template <bool VEC, class P>
__global__ void __launch_bounds__(DrGemm::kThreads)
xent_bwd_dr_kernel(const float* __restrict__ dz, int ldz,
                   const float* __restrict__ w, float* __restrict__ dr,
                   int N, int R, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * DrGemm::kBM, n0 = blockIdx.y * DrGemm::kBN;
  const tc::Operand A{dz, ldz, N, K};
  const tc::Operand B{w, R, R, K};
  DrGemmP<P>::template run<true, VEC>(
      smem, A, B, m0, n0, 1,
      [&](int, DrGemm::Acc& acc) {
        store_tile<DrGemm>(dr, R, N, R, m0, n0, acc);
      },
      [](const float*, const float*) {});
}

// K4, launch 3: dW [K, R] = dz^T r, and db [K] = sum_n dz in the CTAs of
// the first column of tiles. grid (ceil(K / 128), ceil(R / 128)), 256
// threads.
template <bool VEC, class P>
__global__ void __launch_bounds__(DwGemm::kThreads)
xent_bwd_dw_kernel(const float* __restrict__ dz, int ldz,
                   const float* __restrict__ r, float* __restrict__ dw,
                   float* __restrict__ db, int N, int R, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * DwGemm::kBM, n0 = blockIdx.y * DwGemm::kBN;
  const bool sums_db = blockIdx.y == 0 && threadIdx.x < DwGemm::kBM;
  float db_acc = 0.f;           // class m0 + threadIdx.x, frames in order
  const tc::Operand A{dz, ldz, K, N};
  const tc::Operand B{r, R, R, N};
  DwGemmP<P>::template run<true, VEC>(
      smem, A, B, m0, n0, 1,
      [&](int, DwGemm::Acc& acc) {
        store_tile<DwGemm>(dw, R, K, R, m0, n0, acc);
      },
      [&](const float* sa, const float*) {
        if (sums_db) {
          #pragma unroll 8
          for (int k = 0; k < tc::kBK; ++k) {
            db_acc += sa[DwGemm::TA::at(threadIdx.x, k)];
          }
        }
      });
  if (sums_db && m0 + threadIdx.x < K) db[m0 + threadIdx.x] = db_acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <class P>
int xent_fwd(const float* r, const float* w, const float* b,
             const int* ids, const float* tw, float* lse, float* picked,
             float* amax, int* aidx, float* part, int N, int R, int K,
             int Km, int chunk, void* stream) {
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (K + chunk - 1) / chunk;
  const dim3 grid((N + kBM - 1) / kBM, nch);
  const int smem = LogitsGemm::kSmemBytes;
  const bool vec = R % 4 == 0 && aligned16(r) && aligned16(w);
  auto kernel = vec ? xent_fwd_chunk_kernel<true, P>
                    : xent_fwd_chunk_kernel<false, P>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, LogitsGemm::kThreads, smem, st>>>(r, w, b, ids, tw, part,
                                                   N, R, K, Km, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_fwd_combine_kernel<<<(N + kCombineThreads - 1) / kCombineThreads,
                            kCombineThreads, 0, st>>>(part, nch, N, lse,
                                                      picked, amax, aidx);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int xent_bwd(const float* r, const float* w, const float* b,
             const int* ids, const float* tw, const float* lse,
             const float* scale, const float* wtot, float* dr, float* dw,
             float* db, float* dz, int ldz, int N, int R, int K, int Km,
             int chunk, void* stream) {
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % kBN != 0 || ldz < K || ldz % 4 != 0 || !aligned16(dz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_rw = R % 4 == 0 && aligned16(r) && aligned16(w);
  const int smem_dz = LogitsGemm::kSmemBytes + 3 * kBM * sizeof(float);
  auto dz_kernel = vec_rw ? xent_bwd_dz_kernel<true, P>
                          : xent_bwd_dz_kernel<false, P>;
  cudaError_t err = allow_smem(dz_kernel, smem_dz);
  if (err != cudaSuccess) return static_cast<int>(err);
  dz_kernel<<<dim3((N + kBM - 1) / kBM, (K + chunk - 1) / chunk),
              LogitsGemm::kThreads, smem_dz, st>>>(
      r, w, b, ids, tw, lse, scale, wtot, dz, ldz, N, R, K, Km, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool vec_w = R % 4 == 0 && aligned16(w);
  auto dr_kernel = vec_w ? xent_bwd_dr_kernel<true, P>
                         : xent_bwd_dr_kernel<false, P>;
  err = allow_smem(dr_kernel, DrGemm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dr_kernel<<<dim3((N + DrGemm::kBM - 1) / DrGemm::kBM,
                   (R + DrGemm::kBN - 1) / DrGemm::kBN), DrGemm::kThreads,
              DrGemm::kSmemBytes, st>>>(dz, ldz, w, dr, N, R, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool vec_r = R % 4 == 0 && aligned16(r);
  auto dw_kernel = vec_r ? xent_bwd_dw_kernel<true, P>
                         : xent_bwd_dw_kernel<false, P>;
  err = allow_smem(dw_kernel, DwGemm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3((K + DwGemm::kBM - 1) / DwGemm::kBM,
                   (R + DwGemm::kBN - 1) / DwGemm::kBN), DwGemm::kThreads,
              DwGemm::kSmemBytes, st>>>(dz, ldz, r, dw, db, N, R, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 (the _bf16 entry points): K3 and K4 on wg_gemm.cuh
// ---------------------------------------------------------------------------
//
// The same functions under the JAX package's set_matmul_dtype(bf16):
// xent_pallas.py::_fwd_kernel casts r and W to bf16 before its dot (:66,
// W in _pad_inputs :257), ::_bwd_kernel recomputes the logits from them
// (:165) and casts dz to bf16 once (:182, dzc) for dr = dzc W and dW =
// dzc^T r; every product sums in f32, and db is summed from the f32 dz
// (:188).
//
// What bounds them on an H100: the products, 2NKR each at 989 TFLOP/s
// (0.042 ms at N = 5120, R = 512, K = 8000: K3 one, K4 three); then the
// logits epilogues (an exp and a max per logit), dz's bytes (82 MB in
// bf16, written once, read by dr and dW) and L2's rate at feeding the
// tiles. The design:
//   - a prologue launch rounds r and W to bf16 once a call (cvt.rn, as
//     torch's .to(bfloat16)) into scratch the wrapper allocates, lines
//     padded to a multiple of 8 elements for TMA; never cached across
//     calls, since the optimizer updates W in place;
//   - every product on wg_gemm.cuh: 128 x 128 tiles, TMA-fed 64-deep
//     stages, wgmma m64n128k16 in two consumer warpgroups, persistent
//     CTAs walking items, each side's next tile's loads under the current
//     tile's epilogue;
//   - K3 (3 launches): prologue; the chunk walk of the f32 design on the
//     wgmma fragment (per-(chunk, row) max, first index, sum-exp, picked
//     logit), items (128-frame row tile, class chunk of the plan), the
//     epilogue branch-free but in a chunk's last tile (the max by a tree,
//     exp by ex2.approx, the sums split four ways); the merge of the
//     chunks (xent_fwd_combine_kernel, shared with the f32 design);
//   - K4 (5 launches): prologue; the same walk with the dz epilogue,
//     which rounds dz to bf16 once into a swizzled staging tile written
//     by TMA stores, and sums the f32 dz per (128-frame tile, class) for
//     db; dr = dz W; dW = dz^T r; a fold adding db's frame tiles in
//     order.
// No float atomics: every output value is summed in a fixed order, so
// results repeat bit for bit. Masked rows (scale 0) give dz = 0 exactly,
// so their dr rows are 0. The -1e30 guard of padded classes becomes the
// c < c_end masks of a chunk's last tile; TMA's zero fill covers rows and
// k past an operand's extent (R = 130, K = 1003, N = 1001).

using bf16 = __nv_bfloat16;

inline int ld8(int n) { return (n + 7) / 8 * 8; }

// One rounding of the prologue: rows x cols f32 (dense) to bf16 with line
// stride dld.
struct Cvt16 {
  const float* src;
  bf16* dst;
  int rows, cols, dld;
};
struct Cvts16 {
  Cvt16 c[2];
};

__device__ __forceinline__ void round_copy(const Cvt16& c) {
  if ((c.cols & 3) == 0) {
    // four neighbouring values an item (one 16-byte load, one 8-byte
    // store), four items a thread in flight at once
    const int quads = c.cols / 4;
    const int total = c.rows * quads;
    const int stride = gridDim.x * blockDim.x;
    const float4* src = reinterpret_cast<const float4*>(c.src);
    for (int e0 = blockIdx.x * blockDim.x + threadIdx.x; e0 < total;
         e0 += 4 * stride) {
      float4 v[4];
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e0 + u * stride < total) v[u] = src[e0 + u * stride];
      }
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * stride;
        if (e >= total) continue;
        const int row = e / quads, q = e - row * quads;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
        uint2 w;
        w.x = *reinterpret_cast<const unsigned*>(&lo);
        w.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(c.dst + (size_t)row * c.dld + 4 * q) = w;
      }
    }
    return;
  }
  // else a row per block in turn, two neighbouring values a thread (an
  // 8-byte load where the row width is even, a 4-byte store)
  const bool even = (c.cols & 1) == 0;
  const int pairs = (c.cols + 1) / 2;
  for (int row = blockIdx.x; row < c.rows; row += gridDim.x) {
    const float* s = c.src + (size_t)row * c.cols;
    bf16* d = c.dst + (size_t)row * c.dld;
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int k = 2 * q;
      if (k + 1 < c.cols) {
        const float2 v = even ? *reinterpret_cast<const float2*>(s + k)
                              : make_float2(s[k], s[k + 1]);
        *reinterpret_cast<__nv_bfloat162*>(d + k) =
            __floats2bfloat162_rn(v.x, v.y);
      } else {
        d[k] = __float2bfloat16_rn(s[k]);
      }
    }
  }
}

// K3's and K4's prologues (r and W; one conversion per blockIdx.y). One
// body under two names: chip_smoke.py files a traced kernel under its
// entry point by name alone, so a kernel both entry points launched could
// not be counted against either.
__global__ void xent16_fwd_prep_kernel(Cvts16 cv) {
  round_copy(cv.c[blockIdx.y]);
}
__global__ void xent16_bwd_prep_kernel(Cvts16 cv) {
  round_copy(cv.c[blockIdx.y]);
}

// The tile row of this consumer thread's fragment row h (wg_gemm.cuh).
__device__ __forceinline__ int frag_row(int h) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// The logits walk: item -> (first frame m0, classes [c_begin, c_end)),
// row tiles fastest.
struct ChunkItem {
  int rt, ch, m0, c_begin, c_end;
  __device__ ChunkItem(int it, int nrt, int chunk, int K)
      : rt(it % nrt), ch(it / nrt), m0(rt * wg::kBM),
        c_begin(ch * chunk), c_end(min(K, ch * chunk + chunk)) {}
};

// The rings: the logits walk's (both operands K-major), dz's shallower
// (its epilogue keeps more registers, and a smaller ring leaves L1 more
// room), dr's (B MN-major) and dW's (both MN-major).
using LogitsRing = wg::Ring<false, false, 6>;
using DzRing = wg::Ring<false, false, 4>;
using DrRing = wg::Ring<false, true, 6>;
using DwRing = wg::Ring<true, true, 6>;

constexpr float kLog2e = 1.4426950408889634f;

// e^x for the softmax sums: ex2.approx of x log2(e) (about 2 ulp; results
// under 2^-126 flush to 0, as e^kNeg does).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// The producer's side of the logits walk.
template <class Ring>
__device__ __forceinline__ void produce_logits(Ring& ring,
                                               const CUtensorMap* mr,
                                               const CUtensorMap* mw,
                                               int items, int nrt, int chunk,
                                               int K, int R) {
  wg::tma_prefetch(mr);
  wg::tma_prefetch(mw);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const ChunkItem ci(it, nrt, chunk, K);
    for (int c0 = ci.c_begin; c0 < ci.c_end; c0 += wg::kBN) {
      for (int k0 = 0; k0 < R; k0 += wg::kBK) {
        ring.produce(mr, mw, ci.m0, c0, k0);
      }
    }
  }
}

// z = acc + b for this thread's columns c0 + 8 j + 2 t + e of a tile; a
// column past c_end (only in a chunk's last tile: FULL false) gets
// z = kNeg.
template <bool FULL>
__device__ __forceinline__ void add_bias(float (&acc)[64],
                                         const float* __restrict__ b, int c0,
                                         int c_end) {
  const int t = threadIdx.x & 3;
  #pragma unroll
  for (int j = 0; j < 16; ++j) {
    #pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      if (FULL || c < c_end) {
        const float bb = __ldg(b + c);
        acc[4 * j + e] += bb;
        acc[4 * j + 2 + e] += bb;
      } else {
        acc[4 * j + e] = kNeg;
        acc[4 * j + 2 + e] = kNeg;
      }
    }
  }
}

// The largest of this thread's 32 values of fragment row h (a tree).
__device__ __forceinline__ float row_max(const float (&acc)[64], int h) {
  float m[16];
  #pragma unroll
  for (int j = 0; j < 16; ++j) {
    m[j] = fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  #pragma unroll
  for (int s = 1; s < 16; s <<= 1) {
    #pragma unroll
    for (int j = 0; j < 16; j += 2 * s) m[j] = fmaxf(m[j], m[j + s]);
  }
  return m[0];
}

// K3's epilogue of one tile: the row's running max, its first index, the
// sum of exp(z - max) and the weighted picked logit (bv, bi, bs, bp), as
// xent_fwd_chunk_kernel's, over the tile's logits z (in acc).
template <bool FULL>
__device__ __forceinline__ void fwd_tile(float (&acc)[64],
                                         const float* __restrict__ b,
                                         const int* __restrict__ ids,
                                         const float* __restrict__ tw,
                                         int c0, int c_end, int m0, int N,
                                         int Km, float (&bv)[2],
                                         int (&bi)[2], float (&bs)[2],
                                         float (&bp)[2]) {
  const int t = threadIdx.x & 3;
  add_bias<FULL>(acc, b, c0, c_end);
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tmax = row_max(acc, h);
    // its first column: columns rise with (j, e), so the lowest (j, e)
    // holding the max
    int q0 = 32;
    #pragma unroll
    for (int q = 31; q >= 0; --q) {
      q0 = acc[4 * (q >> 1) + 2 * h + (q & 1)] == tmax ? q : q0;
    }
    if (tmax > bv[h]) {     // tiles rise too: strict > across tiles
      bs[h] *= exp_approx(bv[h] - tmax);
      bv[h] = tmax;
      bi[h] = c0 + 2 * t + 8 * (q0 >> 1) + (q0 & 1);
    }
    float se[4] = {0.f, 0.f, 0.f, 0.f};
    #pragma unroll
    for (int j = 0; j < 16; ++j) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = exp_approx(acc[4 * j + 2 * h + e] - bv[h]);
        se[(2 * j + e) & 3] +=
            (FULL || c0 + 8 * j + 2 * t + e < c_end) ? x : 0.f;
      }
    }
    bs[h] += (se[0] + se[1]) + (se[2] + se[3]);
    const int n = m0 + frag_row(h);
    if (n < N) {
      for (int jj = 0; jj < Km; ++jj) {
        const int id = ids[(size_t)n * Km + jj];
        const int off = id - (c0 + 2 * t);
        if (id >= c_end || off < 0 || off >= wg::kBN || (off & 6) != 0) {
          continue;
        }
        // the target is one of this thread's columns of the tile
        float z = 0.f;
        #pragma unroll
        for (int j = 0; j < 16; ++j) {
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (off == 8 * j + e) z = acc[4 * j + 2 * h + e];
          }
        }
        bp[h] += tw[(size_t)n * Km + jj] * z;
      }
    }
  }
}

// K3, launch 2 of 3: persistent; item = (row tile, class chunk), its
// 128-class tiles in order, the epilogue of xent_fwd_chunk_kernel on the
// wgmma fragment (the max by a tree, the first index by the lowest (j, e)
// holding it, exp by ex2.approx, the sums split four ways, no branch but
// in a chunk's last tile). grid min(items, SMs), wg::kThreads threads.
__global__ void __launch_bounds__(wg::kThreads, 1)
xent16_fwd_chunk_kernel(const __grid_constant__ CUtensorMap mr,
                        const __grid_constant__ CUtensorMap mw,
                        const float* __restrict__ b,
                        const int* __restrict__ ids,
                        const float* __restrict__ tw, float* part, int N,
                        int R, int K, int Km, int chunk) {
  extern __shared__ float4 smem4[];
  LogitsRing ring(smem4);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int nrt = (N + wg::kBM - 1) / wg::kBM;
  const int nch = (K + chunk - 1) / chunk;
  const int items = nrt * nch;
  const int ksteps = (R + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x >= wg::kProducer) {
    if (threadIdx.x == wg::kProducer) {
      produce_logits(ring, &mr, &mw, items, nrt, chunk, K, R);
    }
    return;
  }
  const int t = threadIdx.x & 3;
  const int wgi = threadIdx.x >> 7;
  const Partials P = partials(part, nch, N);
  float acc[64];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const ChunkItem ci(it, nrt, chunk, K);
    // this thread's rows m0 + frag_row(h), h = 0, 1
    float bv[2], bs[2], bp[2];
    int bi[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      bv[h] = kNeg;
      bs[h] = 0.f;
      bp[h] = 0.f;
      bi[h] = kNoIndex;
    }
    for (int c0 = ci.c_begin; c0 < ci.c_end; c0 += wg::kBN) {
      ring.consume(acc, ksteps, wgi);
      if (c0 + wg::kBN <= ci.c_end) {
        fwd_tile<true>(acc, b, ids, tw, c0, ci.c_end, ci.m0, N, Km, bv, bi,
                       bs, bp);
      } else {
        fwd_tile<false>(acc, b, ids, tw, c0, ci.c_end, ci.m0, N, Km, bv, bi,
                        bs, bp);
      }
    }
    // merge the 4 lanes of a quad (they share rows; each row belongs to
    // one warp), then write the item's partials
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      #pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, bv[h], o);
        const float s2 = __shfl_xor_sync(0xffffffffu, bs[h], o);
        const float p2 = __shfl_xor_sync(0xffffffffu, bp[h], o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi[h], o);
        merge(bv[h], bi[h], bs[h], v2, i2, s2);
        bp[h] += p2;
      }
      const int n = ci.m0 + frag_row(h);
      if (t == 0 && n < N) {
        const size_t o = (size_t)ci.ch * N + n;
        P.v[o] = bv[h];
        P.s[o] = bs[h];
        P.p[o] = bp[h];
        P.i[o] = bi[h];
      }
    }
  }
}

// K4's epilogue of one tile: acc = dz in f32 (0 past c_end and in rows
// past N); the column sums of the f32 dz over the warp's 16 rows into rb
// [warp][column].
template <bool FULL>
__device__ __forceinline__ void dz_tile(
    float (&acc)[64], const float* __restrict__ b,
    const int* __restrict__ ids, const float* __restrict__ tw, float* rb,
    int c0, int c_end, const int (&n)[2], const bool (&live)[2],
    const float (&l)[2], const float (&sc)[2], const float (&wt)[2],
    int Km) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  #pragma unroll
  for (int j = 0; j < 16; ++j) {
    #pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      const bool ok = FULL || c < c_end;
      const float bb = ok ? __ldg(b + c) : 0.f;
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 4 * j + 2 * h + e;
        const float x = exp_approx(acc[q] + bb - l[h]) * wt[h];
        acc[q] = (ok && live[h]) ? x : 0.f;
      }
    }
  }
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    for (int jj = 0; jj < Km; ++jj) {
      const int id = ids[(size_t)n[h] * Km + jj];
      const int off = id - (c0 + 2 * t);
      if (id >= c_end || off < 0 || off >= wg::kBN || (off & 6) != 0) {
        continue;
      }
      const float tv = tw[(size_t)n[h] * Km + jj];
      #pragma unroll
      for (int j = 0; j < 16; ++j) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (off == 8 * j + e) acc[4 * j + 2 * h + e] -= tv;
        }
      }
    }
  }
  #pragma unroll
  for (int j = 0; j < 16; ++j) {
    float cs[2] = {0.f, 0.f};
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[4 * j + 2 * h + e] *= sc[h];
        cs[e] += acc[4 * j + 2 * h + e];
      }
    }
    // the warp's 16 rows: the 8 lanes of a column, in a fixed tree
    #pragma unroll
    for (int e = 0; e < 2; ++e) {
      #pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
      }
      if (lane < 4) rb[warp * wg::kBN + 8 * j + 2 * t + e] = cs[e];
    }
  }
}

// K4, launch 2 of 5: the logits walk of K3 with the dz epilogue: dz =
// scale (wtot exp(z - lse) - sum_j tw_j onehot(id_j)) in f32, rounded to
// bf16 into a swizzled staging tile that two TMA stores write to dz [N,
// ldz] (mdz: boxes of {64 classes, 128 frames}; rows past N and classes
// past K are not written); and per (row tile, class) the sum of the f32
// dz over the tile's 128 frames into dbp [nrt, K] (a quad lane's two
// rows, the 8 lanes of a column by shuffles, then the 8 warps in order).
__global__ void __launch_bounds__(wg::kThreads, 1)
xent16_bwd_dz_kernel(const __grid_constant__ CUtensorMap mr,
                     const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap mdz,
                     const float* __restrict__ b,
                     const int* __restrict__ ids,
                     const float* __restrict__ tw,
                     const float* __restrict__ lse,
                     const float* __restrict__ scale,
                     const float* __restrict__ wtot,
                     float* __restrict__ dbp, int N, int R, int K, int Km,
                     int chunk) {
  extern __shared__ float4 smem4[];
  DzRing ring(smem4);
  // after the ring: the staging tile (32 KB, 1024-byte aligned), then the
  // warps' column sums [8 warps][128 columns]
  char* tail = static_cast<char*>(DzRing::tail(smem4));
  char* stage = tail + ((1024u - (wg::smem_u32(tail) & 1023u)) & 1023u);
  float* rb = reinterpret_cast<float*>(stage + 2 * wg::kTileBytes);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int nrt = (N + wg::kBM - 1) / wg::kBM;
  const int items = nrt * ((K + chunk - 1) / chunk);
  const int ksteps = (R + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x >= wg::kProducer) {
    if (threadIdx.x == wg::kProducer) {
      wg::tma_prefetch(&mdz);
      produce_logits(ring, &mr, &mw, items, nrt, chunk, K, R);
    }
    return;
  }
  const int wgi = threadIdx.x >> 7, t = threadIdx.x & 3;
  float acc[64];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const ChunkItem ci(it, nrt, chunk, K);
    int n[2];
    bool live[2];
    float l[2], sc[2], wt[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      n[h] = ci.m0 + frag_row(h);
      live[h] = n[h] < N;
      l[h] = live[h] ? lse[n[h]] : 0.f;
      sc[h] = live[h] ? scale[n[h]] : 0.f;
      wt[h] = live[h] ? wtot[n[h]] : 0.f;
    }
    for (int c0 = ci.c_begin; c0 < ci.c_end; c0 += wg::kBN) {
      ring.consume(acc, ksteps, wgi);
      if (c0 + wg::kBN <= ci.c_end) {
        dz_tile<true>(acc, b, ids, tw, rb, c0, ci.c_end, n, live, l, sc, wt,
                      Km);
      } else {
        dz_tile<false>(acc, b, ids, tw, rb, c0, ci.c_end, n, live, l, sc,
                       wt, Km);
      }
      // the last tile's stores have read the staging tile; rb is full
      if (threadIdx.x == 0) wg::tma_store_wait_read();
      wg::consumers_sync();
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(
              stage + wg::staged_offset(frag_row(h), 8 * j + 2 * t)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
        }
      }
      wg::fence_async_smem();
      if (threadIdx.x < wg::kBN &&
          c0 + static_cast<int>(threadIdx.x) < ci.c_end) {
        float s = rb[threadIdx.x];
        for (int w = 1; w < wg::kConsumerWarps; ++w) {
          s += rb[w * wg::kBN + threadIdx.x];
        }
        dbp[(size_t)ci.rt * K + c0 + threadIdx.x] = s;
      }
      wg::consumers_sync();
      if (threadIdx.x == 0) {
        const uint32_t src = wg::smem_u32(stage);
        wg::tma_store(&mdz, src, c0, ci.m0);
        wg::tma_store(&mdz, src + wg::kTileBytes, c0 + 64, ci.m0);
        wg::tma_store_commit();
      }
    }
  }
  if (threadIdx.x == 0) wg::tma_store_wait();
}

// Store this consumer thread's fragment of a finished 128 x 128 tile of
// out [rows, cols] (leading dimension ld) at (m0, n0).
__device__ __forceinline__ void store_frag(float* __restrict__ out, int ld,
                                           int rows, int cols, int m0,
                                           int n0, const float (&acc)[64]) {
  const int t = threadIdx.x & 3;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + frag_row(h);
    if (m >= rows) continue;
    float* o = out + (size_t)m * ld;
    #pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c < cols) o[c] = acc[4 * j + 2 * h];
      if (c + 1 < cols) o[c + 1] = acc[4 * j + 2 * h + 1];
    }
  }
}

// K4, launch 3 of 5: dr [N, R] = dz W, A = dz [N, ldz] K-major, B = W
// [K, R8] MN-major. Item = (row tile, column tile), columns fastest (the
// items that share a dz block run together), each over the whole
// contraction.
__global__ void __launch_bounds__(wg::kThreads, 1)
xent16_bwd_dr_kernel(const __grid_constant__ CUtensorMap mdz,
                     const __grid_constant__ CUtensorMap mw,
                     float* __restrict__ dr, int N, int R, int K) {
  extern __shared__ float4 smem4[];
  DrRing ring(smem4);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int njt = (R + wg::kBN - 1) / wg::kBN;
  const int items = (N + wg::kBM - 1) / wg::kBM * njt;
  const int kst = (K + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x >= wg::kProducer) {
    if (threadIdx.x == wg::kProducer) {
      wg::tma_prefetch(&mdz);
      wg::tma_prefetch(&mw);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
        for (int s = 0; s < kst; ++s) {
          ring.produce(&mdz, &mw, m0, n0, s * wg::kBK);
        }
      }
    }
    return;
  }
  float acc[64];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
    ring.consume(acc, kst, threadIdx.x >> 7);
    store_frag(dr, R, N, R, m0, n0, acc);
  }
}

// K4, launch 4 of 5: dW [K, R] = dz^T r, A = dz [N, ldz] MN-major (the
// classes along its lines), B = r [N, R8] MN-major. Item = (class tile,
// column tile), columns fastest.
__global__ void __launch_bounds__(wg::kThreads, 1)
xent16_bwd_dw_kernel(const __grid_constant__ CUtensorMap mdz,
                     const __grid_constant__ CUtensorMap mr,
                     float* __restrict__ dw, int N, int R, int K) {
  extern __shared__ float4 smem4[];
  DwRing ring(smem4);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int njt = (R + wg::kBN - 1) / wg::kBN;
  const int items = (K + wg::kBM - 1) / wg::kBM * njt;
  const int kst = (N + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x >= wg::kProducer) {
    if (threadIdx.x == wg::kProducer) {
      wg::tma_prefetch(&mdz);
      wg::tma_prefetch(&mr);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
        for (int s = 0; s < kst; ++s) {
          ring.produce(&mdz, &mr, m0, n0, s * wg::kBK);
        }
      }
    }
    return;
  }
  float acc[64];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
    ring.consume(acc, kst, threadIdx.x >> 7);
    store_frag(dw, R, K, R, m0, n0, acc);
  }
}

// K4, launch 5 of 5: db = dbp's frame tiles added in order.
__global__ void xent16_bwd_fold_kernel(const float* __restrict__ dbp,
                                       int nrt, float* __restrict__ db,
                                       int K) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < K;
       c += gridDim.x * blockDim.x) {
    float v = dbp[c];
    for (int rt = 1; rt < nrt; ++rt) v += dbp[(size_t)rt * K + c];
    db[c] = v;
  }
}

// K4's dz walk after its ring: alignment slack, the staging tile, the
// column sums
constexpr int kDzExtraBytes = 1024 + 2 * wg::kTileBytes +
                              wg::kConsumerWarps * wg::kBN * 4;
constexpr int kPrepThreads = 256;

cudaError_t launch_prep(bool fwd, const float* r, const float* w, bf16* r16,
                        bf16* w16, int N, int R, int K, cudaStream_t st) {
  const Cvts16 cv{{{r, r16, N, R, ld8(R)}, {w, w16, K, R, ld8(R)}}};
  // the larger conversion's items four to a thread (or its rows)
  const long long items = (long long)std::max(N, K) * ((R + 3) / 4);
  const int blocks = static_cast<int>(std::max<long long>(
      std::min<long long>((items + 4 * kPrepThreads - 1) /
                              (4 * kPrepThreads),
                          4096),
      std::min(std::max(N, K), 2048)));
  if (fwd) {
    xent16_fwd_prep_kernel<<<dim3(blocks, 2), kPrepThreads, 0, st>>>(cv);
  } else {
    xent16_bwd_prep_kernel<<<dim3(blocks, 2), kPrepThreads, 0, st>>>(cv);
  }
  return cudaGetLastError();
}

int xent16_fwd(const float* r, const float* w, const float* b,
               const int* ids, const float* tw, float* lse, float* picked,
               float* amax, int* aidx, float* part, bf16* r16, bf16* w16,
               int N, int R, int K, int Km, int chunk, int sms,
               void* stream) {
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % wg::kBN != 0 || sms <= 0 || !aligned16(r16) ||
      !aligned16(w16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prep(true, r, w, r16, w16, N, R, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mr, mw;
  if (!wg::operand_map(&mr, r16, false, N, R, ld8(R)) ||
      !wg::operand_map(&mw, w16, false, K, R, ld8(R))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nch = (K + chunk - 1) / chunk;
  const int items = (N + wg::kBM - 1) / wg::kBM * nch;
  err = allow_smem(xent16_fwd_chunk_kernel, LogitsRing::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent16_fwd_chunk_kernel<<<std::min(items, sms), wg::kThreads,
                            LogitsRing::kBytes, st>>>(mr, mw, b, ids, tw, part, N, R, K, Km,
                                  chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_fwd_combine_kernel<<<(N + kCombineThreads - 1) / kCombineThreads,
                            kCombineThreads, 0, st>>>(part, nch, N, lse,
                                                      picked, amax, aidx);
  return static_cast<int>(cudaGetLastError());
}

int xent16_bwd(const float* r, const float* w, const float* b,
               const int* ids, const float* tw, const float* lse,
               const float* scale, const float* wtot, float* dr, float* dw,
               float* db, bf16* r16, bf16* w16, bf16* dz, int ldz,
               float* dbp, int N, int R, int K, int Km, int chunk, int sms,
               void* stream) {
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % wg::kBN != 0 || sms <= 0 || ldz < K || ldz % 8 != 0 ||
      !aligned16(r16) || !aligned16(w16) || !aligned16(dz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prep(false, r, w, r16, w16, N, R, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R8 = ld8(R);
  CUtensorMap mr_k, mw_k, mdz_k, mw_mn, mdz_mn, mr_mn;
  if (!wg::operand_map(&mr_k, r16, false, N, R, R8) ||
      !wg::operand_map(&mw_k, w16, false, K, R, R8) ||
      !wg::operand_map(&mdz_k, dz, false, N, K, ldz) ||
      !wg::operand_map(&mw_mn, w16, true, R, K, R8) ||
      !wg::operand_map(&mdz_mn, dz, true, K, N, ldz) ||
      !wg::operand_map(&mr_mn, r16, true, R, N, R8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nrt = (N + wg::kBM - 1) / wg::kBM;
  const int njt = (R + wg::kBN - 1) / wg::kBN;

  const int smem_dz = DzRing::kBytes + kDzExtraBytes;
  err = allow_smem(xent16_bwd_dz_kernel, smem_dz);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dz_items = nrt * ((K + chunk - 1) / chunk);
  xent16_bwd_dz_kernel<<<std::min(dz_items, sms), wg::kThreads, smem_dz,
                         st>>>(mr_k, mw_k, mdz_k, b, ids, tw, lse, scale,
                               wtot, dbp, N, R, K, Km, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(xent16_bwd_dr_kernel, DrRing::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent16_bwd_dr_kernel<<<std::min(nrt * njt, sms), wg::kThreads,
                         DrRing::kBytes, st>>>(mdz_k, mw_mn, dr, N, R, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(xent16_bwd_dw_kernel, DwRing::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dw_items = (K + wg::kBM - 1) / wg::kBM * njt;
  xent16_bwd_dw_kernel<<<std::min(dw_items, sms), wg::kThreads,
                         DwRing::kBytes, st>>>(mdz_mn, mr_mn, dw, N, R, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  xent16_bwd_fold_kernel<<<(K + kPrepThreads - 1) / kPrepThreads,
                           kPrepThreads, 0, st>>>(dbp, nrt, db, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: two launches. r [N, R], w [K, R], b [K], ids/tw [N, Km]. part:
// scratch of 4 ceil(K / chunk) N floats; chunk a positive multiple of
// 128. Out: lse, picked, amax [N] float, aidx [N] int32. Returns a CUDA
// error code (0 on success).
extern "C" int xent_affine_fwd_f32(const float* r, const float* w,
                                   const float* b, const int* ids,
                                   const float* tw, float* lse,
                                   float* picked, float* amax, int* aidx,
                                   float* part, int N, int R, int K, int Km,
                                   int chunk, void* stream) {
  return xent_fwd<tc::F32>(r, w, b, ids, tw, lse, picked, amax, aidx,
                            part, N, R, K, Km, chunk, stream);
}

// K3 in bf16 (the --bf16 path): three launches (the prologue rounding r
// and w into r16 [N, ld8(R)] and w16 [K, ld8(R)], bf16 scratch 16-byte
// aligned; the chunk walk on wgmma as a persistent grid of min(items,
// sms) CTAs; the merge). The other arguments as xent_affine_fwd_f32's;
// chunk a positive multiple of 128 (ops/xent_affine.py::xent_bf16_plan).
extern "C" int xent_affine_fwd_bf16(const float* r, const float* w,
                                    const float* b, const int* ids,
                                    const float* tw, float* lse,
                                    float* picked, float* amax, int* aidx,
                                    float* part, bf16* r16, bf16* w16,
                                    int N, int R, int K, int Km, int chunk,
                                    int sms, void* stream) {
  return xent16_fwd(r, w, b, ids, tw, lse, picked, amax, aidx, part, r16,
                    w16, N, R, K, Km, chunk, sms, stream);
}

// K4: three launches (dz, dr, dW/db). lse [N] from K3, scale [N] = loss
// cotangent x frame mask, wtot [N] = sum_j tw. dz: scratch [N, ldz] with
// ldz >= K a multiple of 4, 16-byte aligned. Out: dr [N, R], dw [K, R],
// db [K]. Returns a CUDA error code (0 on success).
extern "C" int xent_affine_bwd_f32(const float* r, const float* w,
                                   const float* b, const int* ids,
                                   const float* tw, const float* lse,
                                   const float* scale, const float* wtot,
                                   float* dr, float* dw, float* db,
                                   float* dz, int ldz, int N, int R, int K,
                                   int Km, int chunk, void* stream) {
  return xent_bwd<tc::F32>(r, w, b, ids, tw, lse, scale, wtot, dr, dw,
                            db, dz, ldz, N, R, K, Km, chunk, stream);
}

// K4 in bf16 (the --bf16 path): five launches (the prologue; dz in bf16
// into dz [N, ldz] (ldz >= K a multiple of 8) with the db partials dbp
// [ceil(N / 128), K]; dr; dW; the fold of db's partials). r16 / w16 as
// xent_affine_fwd_bf16's; the other arguments as xent_affine_bwd_f32's.
// db is summed from the f32 dz.
extern "C" int xent_affine_bwd_bf16(const float* r, const float* w,
                                    const float* b, const int* ids,
                                    const float* tw, const float* lse,
                                    const float* scale, const float* wtot,
                                    float* dr, float* dw, float* db,
                                    bf16* r16, bf16* w16, bf16* dz, int ldz,
                                    float* dbp, int N, int R, int K, int Km,
                                    int chunk, int sms, void* stream) {
  return xent16_bwd(r, w, b, ids, tw, lse, scale, wtot, dr, dw, db, r16,
                    w16, dz, ldz, dbp, N, R, K, Km, chunk, sms, stream);
}
