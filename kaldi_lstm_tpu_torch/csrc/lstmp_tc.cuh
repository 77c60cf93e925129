// K1's tensor-core pieces, shared by K1/K2 (csrc/lstmp_train.cu) and K6's
// two-layer wavefront (csrc/lstmp_stack.cu): the gate-interleaved copy of
// Wr, the hoisted input projection, the per-step gates tile with the cell
// math in its epilogue, and the plain contraction tile of the projection
// and of K2's products. Each tile is a device function of its block
// indices, so that a kernel over two layers (blockIdx.z picking the layer)
// runs the same tile code as the one-layer kernels. Everything runs on
// tc_gemm.cuh's mainloop, 3xTF32 or bf16 (precision.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "tc_gemm.cuh"

namespace k1 {

constexpr int kGateBN = 64;                // columns of a gate tile
constexpr int kGateCells = kGateBN / 4;    // cells per gate tile

template <int BM, int BN, bool AK, bool BK, class P = tc::F32>
using TileGemm = tc::Gemm<BM, BN, 2, 2, AK, BK, P>;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The gate-interleaved copy of w_gifo_r [4C, R]: row p = 64 b + 16 q + l of
// wr_perm [4 Cp, R] is row q C + j of w_gifo_r, gate q (g, i, f, o) of cell
// j = 16 b + l, so that gate tile b (columns 64 b .. 64 b + 63 of the
// per-step product) holds all four gates of cells 16 b .. 16 b + 15. Rows
// of the padding cells j >= C are zero. Elements first, first + stride,
// ... are this thread's.
__device__ __forceinline__ void interleave_rows(const float* __restrict__ wr,
                                                float* __restrict__ wr_perm,
                                                int C, int Cp, int R,
                                                size_t first, size_t stride) {
  const size_t total = (size_t)4 * Cp * R;
  for (size_t e = first; e < total; e += stride) {
    const int p = static_cast<int>(e / R);
    const int k = static_cast<int>(e % R);
    const int q = (p % kGateBN) / kGateCells;
    const int j = (p / kGateBN) * kGateCells + p % kGateCells;
    wr_perm[e] = j < C ? wr[((size_t)q * C + j) * R + k] : 0.f;
  }
}

__global__ void interleave_gate_rows_kernel(const float* __restrict__ wr,
                                            float* __restrict__ wr_perm,
                                            int C, int Cp, int R) {
  interleave_rows(wr, wr_perm, C, Cp, R,
                  (size_t)blockIdx.x * blockDim.x + threadIdx.x,
                  (size_t)gridDim.x * blockDim.x);
}

// The hoisted input projection over all N = T S rows: xw [N, 4C] =
// x [N, I] w_gifo_x^T, times mask * inv_keep where a keep-mask [N, 4C] is
// given, then + bias: the reference's order.
struct XwArgs {
  const float* x;
  const float* wx;
  const float* bias;
  const int8_t* mask;
  float inv_keep;
  float* xw;
  int N, I, C4;
};

template <bool VA, bool VB, class P>
__global__ void __launch_bounds__(TileGemm<64, 64, true, true>::kThreads)
xw_tc_kernel(XwArgs a) {
  using G = TileGemm<64, 64, true, true, P>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const tc::Operand A{a.x, a.I, a.N, a.I};
  const tc::Operand B{a.wx, a.I, a.C4, a.I};
  G::template run<VA, VB>(
      smem, A, B, m0, n0, 1,
      [&](int, typename G::Acc& acc) {
        const int lane = threadIdx.x & 31;
        const int g = lane >> 2, t = lane & 3;
        const int wm0 = G::warp_m0(), wn0 = G::warp_n0();
        #pragma unroll
        for (int i = 0; i < G::kMT; ++i) {
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm0 + 16 * i + g + 8 * h;
            if (m >= a.N) continue;
            #pragma unroll
            for (int j = 0; j < G::kNT; ++j) {
              #pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + wn0 + 8 * j + 2 * t + e;
                if (n >= a.C4) continue;
                const size_t at = (size_t)m * a.C4 + n;
                float v = acc[i][j][2 * h + e];
                if (a.mask != nullptr) {
                  v = v * ((float)a.mask[at] * a.inv_keep);
                }
                a.xw[at] = v + a.bias[n];
              }
            }
          }
        }
      },
      [](const float*, const float*) {});
}

// One step's gates: pre = r_{t-1} wr_perm^T on the tensor cores, one
// BM x 64 tile (16 cells x 4 gates) per CTA, staged through shared
// memory; then each thread takes (stream, cell)
// pairs of the tile: adds xw_t, applies the peepholes, g/i/f, the clip,
// o on the clipped c, and writes gifo_t [S, 4C] in g|i|f|o blocks,
// c_t [S, C] and m [S, C] = tanh(c_t) o. The pairs' xw_t, c_{t-1} and
// peepholes do not depend on the product: they are loaded into
// registers before the mainloop, which hides their latency.
template <class P>
struct GateArgs {
  const float* r_prev;    // [S, R]
  const float* wr_perm;   // [4 Cp, R]
  const float* xw_t;      // [S, 4C]
  const float* c_prev;    // [S, C]
  const float* peep;      // [3, C]: i, f, o
  float* gifo_t;
  float* c_t;
  float* m;
  int S, R, C, Cp;
  float cell_clip;
};

// The gates tile at rows bx BM, cell tile by (columns 64 by) of `a`.
template <int BM, bool VA, bool VB, class P>
__device__ __forceinline__ void gates_tile(const GateArgs<P>& a, int bx,
                                           int by) {
  using G = TileGemm<BM, kGateBN, true, true, P>;
  constexpr int kRows = G::kThreads / kGateCells;   // tile rows a round
  constexpr int kPairs = BM / kRows;                // pairs per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = bx * BM, n0 = by * kGateBN;
  const size_t C4 = 4 * (size_t)a.C;
  const int jl = threadIdx.x % kGateCells;
  const int cell = by * kGateCells + jl;
  const bool live = cell < a.C;
  float pi = 0.f, pf = 0.f, po = 0.f;
  if (live) {
    pi = a.peep[cell];
    pf = a.peep[a.C + cell];
    po = a.peep[2 * a.C + cell];
  }
  float xq[kPairs][4], cq[kPairs];
  #pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int s = m0 + static_cast<int>(threadIdx.x) / kGateCells + p * kRows;
    const bool ok = live && s < a.S;
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      xq[p][q] = ok ? a.xw_t[(size_t)s * C4 + (size_t)q * a.C + cell]
                     : 0.f;
    }
    cq[p] = ok ? a.c_prev[(size_t)s * a.C + cell] : 0.f;
  }
  const tc::Operand A{a.r_prev, a.R, a.S, a.R};
  const tc::Operand B{a.wr_perm, a.R, 4 * a.Cp, a.R};
  typename G::Acc pre;
  G::template run<VA, VB>(
      smem, A, B, m0, n0, 1,
      [&](int, typename G::Acc& acc) {
        #pragma unroll
        for (int i = 0; i < G::kMT; ++i) {
          #pragma unroll
          for (int j = 0; j < G::kNT; ++j) {
            #pragma unroll
            for (int e = 0; e < 4; ++e) pre[i][j][e] = acc[i][j][e];
          }
        }
      },
      [](const float*, const float*) {});

  // run() returned with the ring idle: stage the tile [BM][64 + 4]
  constexpr int kLd = kGateBN + 4;
  {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm0 = G::warp_m0(), wn0 = G::warp_n0();
    #pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int j = 0; j < G::kNT; ++j) {
          float* at = smem + (wm0 + 16 * i + g + 8 * h) * kLd + wn0 + 8 * j +
                      2 * t;
          at[0] = pre[i][j][2 * h];
          at[1] = pre[i][j][2 * h + 1];
        }
      }
    }
  }
  __syncthreads();

  #pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int sl = static_cast<int>(threadIdx.x) / kGateCells + p * kRows;
    const int s = m0 + sl;
    if (!live || s >= a.S) continue;
    const float* row = smem + sl * kLd + jl;
    const size_t idx = (size_t)s * a.C + cell;
    const float cp = cq[p];
    const float g = tanhf(xq[p][0] + row[0]);
    const float i = sigmoid_f(xq[p][1] + row[kGateCells] + cp * pi);
    const float f = sigmoid_f(xq[p][2] + row[2 * kGateCells] + cp * pf);
    float cn = g * i + cp * f;
    if (a.cell_clip > 0.f) {
      // written out (not fminf/fmaxf) so that a NaN propagates like clip
      cn = cn < -a.cell_clip ? -a.cell_clip
                             : (cn > a.cell_clip ? a.cell_clip : cn);
    }
    const float o = sigmoid_f(xq[p][3] + row[3 * kGateCells] + cn * po);
    float* gr = a.gifo_t + (size_t)s * C4 + cell;
    gr[0] = g;
    gr[a.C] = i;
    gr[2 * (size_t)a.C] = f;
    gr[3 * (size_t)a.C] = o;
    a.c_t[idx] = cn;
    a.m[idx] = tanhf(cn) * o;
  }
}

template <int BM, bool VA, bool VB, class P>
__global__ void __launch_bounds__(TileGemm<BM, kGateBN, true, true>::kThreads)
gates_tc_kernel(GateArgs<P> a) {
  gates_tile<BM, VA, VB, P>(a, blockIdx.x, blockIdx.y);
}

// out[p][m][n] = sum over k in split p of A(m, k) B(n, k), m < M, n < N,
// with A(m, k) = a[m lda + k] (A K-major) or a[k lda + m], B likewise;
// split p covers k in [p kchunk, (p + 1) kchunk), kchunk a multiple of
// 32. One CTA per (BM x BN tile, split) walks its split in order: 64 x 64
// in K2, 32 x 32 or 64 x 64 in K1's projection.
struct Contract {
  const float* a;
  int lda;
  const float* b;
  int ldb;
  float* out;
  int M, N, K, kchunk;
};

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

// The output tile (bx, by) of split bz of `c`.
template <int BM, int BN, bool AK, bool BK, bool VA, bool VB, class P>
__device__ __forceinline__ void contract_tile(const Contract& c, int bx,
                                              int by, int bz) {
  using G = TileGemm<BM, BN, AK, BK, P>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = bx * G::kBM, n0 = by * G::kBN;
  const int k0 = bz * c.kchunk;
  const int kext = min(c.kchunk, c.K - k0);
  float* out = c.out + (size_t)bz * c.M * c.N;
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

template <int BM, int BN, bool AK, bool BK, bool VA, bool VB, class P>
__global__ void __launch_bounds__(TileGemm<BM, BN, AK, BK>::kThreads)
contract_tc_kernel(Contract c) {
  contract_tile<BM, BN, AK, BK, VA, VB, P>(c, blockIdx.x, blockIdx.y,
                                           blockIdx.z);
}

// The contraction of `splits` consecutive ranges of k into [splits][M][N]
// partials (the product itself when splits = 1): Contract's kchunk.
inline Contract make_contract(const float* a, int lda, const float* b,
                              int ldb, float* out, int M, int N, int K,
                              int splits) {
  const int ksteps = (K + tc::kBK - 1) / tc::kBK;
  const int per = (ksteps + splits - 1) / splits;
  return Contract{a, lda, b, ldb, out, M, N, K, per * tc::kBK};
}

// out = A B over `splits` consecutive ranges of k: out holds `splits`
// partial products [splits][M][N] (the product itself when splits = 1).
template <class P, bool AK, bool BK, int BM = 64, int BN = 64>
cudaError_t contract(cudaStream_t st, const float* a, int lda,
                     const float* b, int ldb, float* out, int M, int N,
                     int K, int splits) {
  using G = TileGemm<BM, BN, AK, BK, P>;
  splits = std::max(1, splits);
  const Contract c = make_contract(a, lda, b, ldb, out, M, N, K, splits);
  const bool va = lda % 4 == 0 && aligned16(a);
  const bool vb = ldb % 4 == 0 && aligned16(b);
  auto kernel =
      va ? (vb ? contract_tc_kernel<BM, BN, AK, BK, true, true, P>
               : contract_tc_kernel<BM, BN, AK, BK, true, false, P>)
         : (vb ? contract_tc_kernel<BM, BN, AK, BK, false, true, P>
               : contract_tc_kernel<BM, BN, AK, BK, false, false, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + G::kBM - 1) / G::kBM, (N + G::kBN - 1) / G::kBN,
                  splits);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(c);
  return cudaGetLastError();
}

// Launch helpers: each picks the 16-byte-copy variant where both operands
// allow it, raises the dynamic shared-memory limit, launches on `st`.
template <bool VA, bool VB, class P>
cudaError_t launch_xw_as(cudaStream_t st, const XwArgs& a) {
  using G = TileGemm<64, 64, true, true, P>;
  auto kernel = xw_tc_kernel<VA, VB, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + G::kBM - 1) / G::kBM, (a.C4 + G::kBN - 1) / G::kBN);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch_xw(cudaStream_t st, const XwArgs& a) {
  const bool va = a.I % 4 == 0 && aligned16(a.x);
  const bool vb = a.I % 4 == 0 && aligned16(a.wx);
  return va ? (vb ? launch_xw_as<true, true, P>(st, a)
                  : launch_xw_as<true, false, P>(st, a))
            : (vb ? launch_xw_as<false, true, P>(st, a)
                  : launch_xw_as<false, false, P>(st, a));
}

template <int BM, class P>
cudaError_t launch_gates(cudaStream_t st, const GateArgs<P>& a) {
  using G = TileGemm<BM, kGateBN, true, true, P>;
  const bool va = a.R % 4 == 0 && aligned16(a.r_prev);
  const bool vb = a.R % 4 == 0 && aligned16(a.wr_perm);
  auto kernel = va ? (vb ? gates_tc_kernel<BM, true, true, P>
                         : gates_tc_kernel<BM, true, false, P>)
                   : (vb ? gates_tc_kernel<BM, false, true, P>
                         : gates_tc_kernel<BM, false, false, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BM - 1) / BM, a.Cp / kGateCells);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace k1
