// Fused senone affine + softmax + masked cross-entropy, forward (K3) and
// backward (K4), float32 in and out, on Hopper's tensor cores.
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
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/xent_affine.py through ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

// The logits tiles (K3, K4 launch 1) and dW: 128 x 128, 8 warps of
// 64 x 32, one CTA per SM (up to 255 registers a thread). dr: 128 x 64,
// 4 warps, two CTAs per SM. (4 warps of 64 x 64, two 128 x 64 CTAs per
// SM, or a 4-deep ring ran no faster on an H100.)
using LogitsGemm = tc::Gemm<128, 128, 2, 4, true, true>;
using DwGemm = tc::Gemm<128, 128, 2, 4, false, false>;
using DrGemm = tc::Gemm<128, 64, 2, 2, true, false>;
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
template <bool VEC>
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
  LogitsGemm::run<VEC, VEC>(smem, A, B, m0, c_begin, ntiles, epi,
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
template <bool VEC>
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
  LogitsGemm::run<VEC, VEC>(smem, A, B, m0, c_begin, ntiles, epi,
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
template <bool VEC>
__global__ void __launch_bounds__(DrGemm::kThreads)
xent_bwd_dr_kernel(const float* __restrict__ dz, int ldz,
                   const float* __restrict__ w, float* __restrict__ dr,
                   int N, int R, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * DrGemm::kBM, n0 = blockIdx.y * DrGemm::kBN;
  const tc::Operand A{dz, ldz, N, K};
  const tc::Operand B{w, R, R, K};
  DrGemm::run<true, VEC>(
      smem, A, B, m0, n0, 1,
      [&](int, DrGemm::Acc& acc) {
        store_tile<DrGemm>(dr, R, N, R, m0, n0, acc);
      },
      [](const float*, const float*) {});
}

// K4, launch 3: dW [K, R] = dz^T r, and db [K] = sum_n dz in the CTAs of
// the first column of tiles. grid (ceil(K / 128), ceil(R / 128)), 256
// threads.
template <bool VEC>
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
  DwGemm::run<true, VEC>(
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
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (K + chunk - 1) / chunk;
  const dim3 grid((N + kBM - 1) / kBM, nch);
  const int smem = LogitsGemm::kSmemBytes;
  const bool vec = R % 4 == 0 && aligned16(r) && aligned16(w);
  auto kernel = vec ? xent_fwd_chunk_kernel<true>
                    : xent_fwd_chunk_kernel<false>;
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
  if (N <= 0 || R <= 0 || K <= 0 || Km <= 0 || chunk <= 0 ||
      chunk % kBN != 0 || ldz < K || ldz % 4 != 0 || !aligned16(dz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_rw = R % 4 == 0 && aligned16(r) && aligned16(w);
  const int smem_dz = LogitsGemm::kSmemBytes + 3 * kBM * sizeof(float);
  auto dz_kernel = vec_rw ? xent_bwd_dz_kernel<true>
                          : xent_bwd_dz_kernel<false>;
  cudaError_t err = allow_smem(dz_kernel, smem_dz);
  if (err != cudaSuccess) return static_cast<int>(err);
  dz_kernel<<<dim3((N + kBM - 1) / kBM, (K + chunk - 1) / chunk),
              LogitsGemm::kThreads, smem_dz, st>>>(
      r, w, b, ids, tw, lse, scale, wtot, dz, ldz, N, R, K, Km, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool vec_w = R % 4 == 0 && aligned16(w);
  auto dr_kernel = vec_w ? xent_bwd_dr_kernel<true>
                         : xent_bwd_dr_kernel<false>;
  err = allow_smem(dr_kernel, DrGemm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dr_kernel<<<dim3((N + DrGemm::kBM - 1) / DrGemm::kBM,
                   (R + DrGemm::kBN - 1) / DrGemm::kBN), DrGemm::kThreads,
              DrGemm::kSmemBytes, st>>>(dz, ldz, w, dr, N, R, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool vec_r = R % 4 == 0 && aligned16(r);
  auto dw_kernel = vec_r ? xent_bwd_dw_kernel<true>
                         : xent_bwd_dw_kernel<false>;
  err = allow_smem(dw_kernel, DwGemm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3((K + DwGemm::kBM - 1) / DwGemm::kBM,
                   (R + DwGemm::kBN - 1) / DwGemm::kBN), DwGemm::kThreads,
              DwGemm::kSmemBytes, st>>>(dz, ldz, r, dw, db, N, R, K);
  return static_cast<int>(cudaGetLastError());
}
