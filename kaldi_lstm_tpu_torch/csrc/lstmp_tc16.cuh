// K1's bf16 forward tiles, shared by K1 in bf16 (csrc/lstmp_train.cu's
// fwd16_* kernels) and K6 in bf16 (csrc/lstmp_stack.cu's stack16_*
// kernels, both layers of the wavefront): the prologue's rounding of the
// operands into bf16 copies, the hoisted input projection on either
// route (tc_gemm.cuh's Gemm16 tiles, or wg_gemm.cuh's wgmma ring fed by
// TMA), the per-step gates tile with the cell math in its epilogue, and
// the per-step projection tile. Each tile is a device function of its
// block indices and the kernel's dynamic shared memory, so that a kernel
// over two layers (blockIdx.z picking the layer) runs the same code as
// K1's one-layer kernels. Every operand is bf16 in device memory, rounded
// once where it is made; nothing is rounded in a mainloop.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lstmp_tc.cuh"
#include "wg_gemm.cuh"

namespace k16 {

using bf16 = __nv_bfloat16;

// The leading dimension of a bf16 copy: its width padded to a multiple of
// 8 elements (16 bytes), so that every tile copy is one 16-byte cp.async.
inline int ld8(int n) { return (n + 7) / 8 * 8; }

template <class G, class K, class A>
cudaError_t launch_tile(cudaStream_t st, K kernel, dim3 grid, const A& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the prologue: operands rounded once into bf16 copies
// ---------------------------------------------------------------------------

// One rounding of the prologue: rows x cols f32 (row stride cols) to bf16
// (row stride dld); rows 0 skips it. cells > 0: the gate interleave of
// w_gifo_r at gate tiles of 4 cells columns, where row p of the copy is
// gate q = (p % 4 cells) / cells of cell j = (p / 4 cells) cells + p %
// cells, a zero row for a padding cell j >= C (ops/lstm_train.py::
// gate_interleave).
struct FwdCvt {
  const float* src;
  bf16* dst;
  int rows, cols, dld, cells, C;
};
template <int N>
struct FwdCvts {
  FwdCvt c[N];
};

// Where cols is a multiple of 4 and the source 16-byte aligned, four
// neighbouring values an item (one 16-byte load, one 8-byte store); else
// one.
__device__ __forceinline__ int cvt_vec(const FwdCvt& c) {
  return c.cols % 4 == 0 && (reinterpret_cast<uintptr_t>(c.src) & 15u) == 0
             ? 4 : 1;
}

// The rounding c, its items dealt over the grid's x dimension.
__device__ __forceinline__ void round_rows(const FwdCvt& c) {
  const int vec = cvt_vec(c);
  const int per_row = c.cols / vec;
  const int n = c.rows * per_row;
  const int bn = 4 * c.cells;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const int r = e / per_row;
    const int k = (e - r * per_row) * vec;
    const float* src = c.src + (size_t)r * c.cols + k;
    if (c.cells > 0) {
      const int q = (r % bn) / c.cells;
      const int j = (r / bn) * c.cells + r % c.cells;
      src = j < c.C ? c.src + ((size_t)q * c.C + j) * c.cols + k : nullptr;
    }
    bf16* dst = c.dst + (size_t)r * c.dld + k;
    if (vec == 4) {
      const float4 v = src != nullptr
          ? *reinterpret_cast<const float4*>(src)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 w;
      w.x = *reinterpret_cast<const unsigned*>(&lo);
      w.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(dst) = w;
    } else {
      *dst = __float2bfloat16_rn(src != nullptr ? *src : 0.f);
    }
  }
}

// The grid of a prologue over these conversions: one per blockIdx.y.
template <int N>
dim3 prep_grid(const FwdCvts<N>& cv) {
  int most = 0;
  for (const FwdCvt& c : cv.c) most = std::max(most, c.rows * c.cols);
  return dim3(std::max(1, std::min((most + 255) / 256, 1024)), N);
}

// ---------------------------------------------------------------------------
// the hoisted input projection
// ---------------------------------------------------------------------------

// Its operands and epilogue: xw [N, 4C] = x_b [N, I8] wx_b [4C, I8]^T,
// times mask * inv_keep where a keep-mask [N, 4C] is given, then + bias
// (the reference's order), in f32.
struct Xw16Args {
  const bf16* x_b;
  const bf16* wx_b;
  const float* bias;
  const int8_t* mask;
  float inv_keep;
  float* xw;
  int N, I, C4, I8;
};

// Outputs (m, n) and (m, n + 1), n even (4C is even, so both exist): one
// 8-byte store (xw is the wrapper's, 16-byte aligned).
__device__ __forceinline__ void xw_store2(const Xw16Args& a, int m, int n,
                                          float v0, float v1) {
  const size_t at = (size_t)m * a.C4 + n;
  if (a.mask != nullptr) {
    v0 *= (float)a.mask[at] * a.inv_keep;
    v1 *= (float)a.mask[at + 1] * a.inv_keep;
  }
  *reinterpret_cast<float2*>(a.xw + at) =
      make_float2(v0 + a.bias[n], v1 + a.bias[n + 1]);
}

// The mma route: 64 x 64 tiles of Gemm16; the tile is staged in shared
// memory (the ring is idle once run() returns), so that each row of it
// goes out as whole 16-byte stores.
using XwGemm16 = tc::Gemm16<64, 64, 2, 2, true, true, 4, 64>;

__device__ __forceinline__ void xw_tile(const Xw16Args& a, int bx, int by,
                                        float4* smem4) {
  using G = XwGemm16;
  constexpr int kLd = G::kBN + 4;
  static_assert(G::kBM * kLd * 4 <= G::kSmemBytes,
                "the staged tile fits in the ring's shared memory");
  const int m0 = bx * G::kBM, n0 = by * G::kBN;
  const tc::Operand16 A{a.x_b, a.I8, a.N, a.I};
  const tc::Operand16 B{a.wx_b, a.I8, a.C4, a.I};
  typename G::Acc out;
  G::run(reinterpret_cast<bf16*>(smem4), A, B, m0, n0,
         [&](typename G::Acc& acc) {
    #pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      #pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) out[i][j][e] = acc[i][j][e];
      }
    }
  });
  float* smem = reinterpret_cast<float*>(smem4);
  {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    #pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int j = 0; j < G::kNT; ++j) {
          float* at = smem + (G::warp_m0() + 16 * i + g + 8 * h) * kLd +
                      G::warp_n0() + 8 * j + 2 * t;
          at[0] = out[i][j][2 * h];
          at[1] = out[i][j][2 * h + 1];
        }
      }
    }
  }
  __syncthreads();
  // four neighbouring columns an item (4C and n0 are multiples of 4)
  constexpr int kQuads = G::kBN / 4;
  for (int q = threadIdx.x; q < G::kBM * kQuads; q += G::kThreads) {
    const int r = q / kQuads, c = 4 * (q % kQuads);
    const int m = m0 + r, n = n0 + c;
    if (m >= a.N || n >= a.C4) continue;
    float4 v = *reinterpret_cast<const float4*>(smem + r * kLd + c);
    const size_t at = (size_t)m * a.C4 + n;
    if (a.mask != nullptr) {
      v.x *= (float)a.mask[at] * a.inv_keep;
      v.y *= (float)a.mask[at + 1] * a.inv_keep;
      v.z *= (float)a.mask[at + 2] * a.inv_keep;
      v.w *= (float)a.mask[at + 3] * a.inv_keep;
    }
    v.x += a.bias[n];
    v.y += a.bias[n + 1];
    v.z += a.bias[n + 2];
    v.w += a.bias[n + 3];
    *reinterpret_cast<float4*>(a.xw + at) = v;
  }
}

// The wgmma route: wg_gemm.cuh's 128 x 128 tiles, both operands K-major
// and fed by TMA, a persistent grid walking the tiles (columns fastest),
// the whole contraction in the wgmma accumulators. mx and mw are the
// kernel's __grid_constant__ tensor maps.
using XwRing = wg::Ring<false, false, 4>;

__device__ __forceinline__ void xw_wg(const CUtensorMap* mx,
                                      const CUtensorMap* mw,
                                      const Xw16Args& a, float4* smem4) {
  XwRing ring(smem4);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int njt = (a.C4 + wg::kBN - 1) / wg::kBN;
  const int items = (a.N + wg::kBM - 1) / wg::kBM * njt;
  const int kst = (a.I + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x >= wg::kProducer) {
    if (threadIdx.x == wg::kProducer) {
      wg::tma_prefetch(mx);
      wg::tma_prefetch(mw);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
        for (int s = 0; s < kst; ++s) {
          ring.produce(mx, mw, m0, n0, s * wg::kBK);
        }
      }
    }
    return;
  }
  float acc[64];
  const int t = threadIdx.x & 3;
  // this thread's fragment rows (wg_gemm.cuh's accumulator layout)
  const int row = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = it / njt * wg::kBM, n0 = it % njt * wg::kBN;
    ring.consume(acc, kst, threadIdx.x >> 7);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      if (m >= a.N) continue;
      #pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n < a.C4) {
          xw_store2(a, m, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// One launch of the hoisted projection: on the wgmma route (`wgmma`: a
// persistent grid of at most sms CTAs of kernel_wg, the tensor maps
// encoded here) or on Gemm16 tiles (kernel_mma).
template <class KMma, class KWg>
cudaError_t launch_xw(cudaStream_t st, KMma kernel_mma, KWg kernel_wg,
                      const Xw16Args& xa, bool wgmma, int sms) {
  if (!wgmma) {
    const dim3 grid((xa.N + XwGemm16::kBM - 1) / XwGemm16::kBM,
                    (xa.C4 + XwGemm16::kBN - 1) / XwGemm16::kBN);
    return launch_tile<XwGemm16>(st, kernel_mma, grid, xa);
  }
  CUtensorMap mx, mw;
  if (!wg::operand_map(&mx, xa.x_b, false, xa.N, xa.I, xa.I8) ||
      !wg::operand_map(&mw, xa.wx_b, false, xa.C4, xa.I, xa.I8)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
      XwRing::kBytes);
  if (err != cudaSuccess) return err;
  const int items = (xa.N + wg::kBM - 1) / wg::kBM *
                    ((xa.C4 + wg::kBN - 1) / wg::kBN);
  kernel_wg<<<std::min(items, sms), wg::kThreads, XwRing::kBytes, st>>>(
      mx, mw, xa);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one step: the gates tile and the projection tile
// ---------------------------------------------------------------------------

// One step's gates: pre = r_{t-1} wr_b^T on Gemm16 tiles of 64 rows x 128
// columns (32 cells, their four gates: the interleave's width), then the
// cell math on the tile staged in shared memory, writing gifo_t in bf16,
// c_t in f32 and m = tanh(c_t) o in bf16 only (the projection's A
// operand, rounded where the reference rounds h o at its dot).
struct Gate16Args {
  const bf16* r_b;      // [S, R8] r_{t-1} rounded
  const bf16* wr_b;     // [4 Cp, R8] the gate-interleaved Wr rounded
  const float* xw_t;    // [S, 4C]
  const float* c_prev;  // [S, C]
  const float* peep;    // [3, C]: i, f, o
  bf16* gifo_t;         // [S, 4C]
  float* c_t;           // [S, C]
  bf16* m_b;            // [S, C8]
  int S, R, C, Cp, R8, C8;
  float cell_clip;
};

using GateGemm16 = tc::Gemm16<64, 128, 2, 4, true, true, 4, 64>;
constexpr int kGateCells16 = GateGemm16::kBN / 4;

__device__ __forceinline__ void gates_tile(const Gate16Args& a, int bx,
                                           int by, float4* smem4) {
  using G = GateGemm16;
  constexpr int BM = G::kBM, BN = G::kBN;
  constexpr int kCellsT = BN / 4;                 // cells of the tile
  constexpr int kRows = G::kThreads / kCellsT;    // tile rows a round
  static_assert(BM % kRows == 0, "whole rounds of tile rows");
  constexpr int kPairs = BM / kRows;              // pairs per thread
  constexpr int kLd = BN + 4;
  static_assert(BM * kLd * 4 <= G::kSmemBytes,
                "the staged tile fits in the ring's shared memory");
  const int m0 = bx * BM, n0 = by * BN;
  const size_t C4 = 4 * (size_t)a.C;
  const int jl = threadIdx.x % kCellsT;
  const int cell = by * kCellsT + jl;
  const bool live = cell < a.C;
  float pi = 0.f, pf = 0.f, po = 0.f;
  if (live) {
    pi = a.peep[cell];
    pf = a.peep[a.C + cell];
    po = a.peep[2 * a.C + cell];
  }
  const tc::Operand16 A{a.r_b, a.R8, a.S, a.R};
  const tc::Operand16 B{a.wr_b, a.R8, 4 * a.Cp, a.R};
  // the pairs' xw_t and c_{t-1}, loaded before the mainloop
  float xq[kPairs][4], cq[kPairs];
  #pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int s = m0 + static_cast<int>(threadIdx.x) / kCellsT + p * kRows;
    const bool ok = live && s < a.S;
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      xq[p][q] = ok ? a.xw_t[(size_t)s * C4 + (size_t)q * a.C + cell] : 0.f;
    }
    cq[p] = ok ? a.c_prev[(size_t)s * a.C + cell] : 0.f;
  }
  typename G::Acc pre;
  G::run(reinterpret_cast<bf16*>(smem4), A, B, m0, n0,
         [&](typename G::Acc& acc) {
    #pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      #pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) pre[i][j][e] = acc[i][j][e];
      }
    }
  });

  // run() returned with the ring idle: stage the tile [BM][BN + 4] f32
  float* smem = reinterpret_cast<float*>(smem4);
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
    const int sl = static_cast<int>(threadIdx.x) / kCellsT + p * kRows;
    const int s = m0 + sl;
    if (!live || s >= a.S) continue;
    const float* row = smem + sl * kLd + jl;
    const float cp = cq[p];
    const float g = tanhf(xq[p][0] + row[0]);
    const float i = k1::sigmoid_f(xq[p][1] + row[kCellsT] + cp * pi);
    const float f = k1::sigmoid_f(xq[p][2] + row[2 * kCellsT] + cp * pf);
    float cn = g * i + cp * f;
    if (a.cell_clip > 0.f) {
      // written out (not fminf/fmaxf) so that a NaN propagates like clip
      cn = cn < -a.cell_clip ? -a.cell_clip
                             : (cn > a.cell_clip ? a.cell_clip : cn);
    }
    const float o = k1::sigmoid_f(xq[p][3] + row[3 * kCellsT] + cn * po);
    bf16* gr = a.gifo_t + (size_t)s * C4 + cell;
    gr[0] = __float2bfloat16_rn(g);
    gr[a.C] = __float2bfloat16_rn(i);
    gr[2 * (size_t)a.C] = __float2bfloat16_rn(f);
    gr[3 * (size_t)a.C] = __float2bfloat16_rn(o);
    a.c_t[(size_t)s * a.C + cell] = cn;
    a.m_b[(size_t)s * a.C8 + cell] = __float2bfloat16_rn(tanhf(cn) * o);
  }
}

// One step's projection r_t = m_b Wrm^T [S, R] over C, unsplit, on 32 x 32
// tiles; the epilogue writes r_t in f32 (the residual and the output) and
// its bf16 copy r_b, the next step's A operand.
struct Proj16Args {
  const bf16* m_b;     // [S, C8]
  const bf16* wrm_b;   // [R, C8]
  float* r_t;          // [S, R]
  bf16* r_b;           // [S, R8]
  int S, R, C, C8, R8;
};

using ProjGemm16 = tc::Gemm16<32, 32, 2, 2, true, true, 8, 64>;

__device__ __forceinline__ void proj_tile(const Proj16Args& a, int bx,
                                          int by, float4* smem4) {
  using G = ProjGemm16;
  const int m0 = bx * G::kBM, n0 = by * G::kBN;
  const tc::Operand16 A{a.m_b, a.C8, a.S, a.C};
  const tc::Operand16 B{a.wrm_b, a.C8, a.R, a.C};
  G::run(reinterpret_cast<bf16*>(smem4), A, B, m0, n0,
         [&](typename G::Acc& acc) {
    const int lane = threadIdx.x & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    #pragma unroll
    for (int q = 0; q < 2 * G::kMT; ++q) {     // (m16 tile, row half)
      const int s = m0 + G::warp_m0() + 16 * (q / 2) + g8 + 8 * (q % 2);
      if (s >= a.S) continue;
      #pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = n0 + G::warp_n0() + 8 * j + 2 * t4 + e;
          if (r >= a.R) continue;
          const float v = acc[q / 2][j][2 * (q % 2) + e];
          a.r_t[(size_t)s * a.R + r] = v;
          a.r_b[(size_t)s * a.R8 + r] = __float2bfloat16_rn(v);
        }
      }
    }
  });
}

}  // namespace k16
