// A tensor-core tile mainloop for Hopper (sm_90a), f32-accurate, shared
// by every f32 product of csrc/xent_affine.cu (K3, K4),
// csrc/lstmp_train.cu (K1, K2) and csrc/lstmp_stack.cu (K6); and, at the
// end of this file, its bf16 tiles (Gemm16: operands already bf16 in
// device memory), which K1, K2 and K6 in bf16 run on.
//
// C[m, n] = sum_k A(m, k) B(k, n) over float32 operands in device memory.
// Each operand is either K-major (element (row, k) at p[row * ld + k]) or
// row-major along the output dimension (element (row, k) at p[k * ld + row]),
// so one mainloop serves r W^T (both K-major), dz W (A K-major, B along n)
// and dz^T r (both along the output dimension). Rows and k past an
// operand's extent read as zero: nothing is padded in memory.
//
// Staging: a kStages-deep ring of (A, B) tiles in dynamic shared memory,
// filled with cp.async (16-byte copies with zero fill when the operand's
// leading dimension and base allow it, 4-byte copies otherwise). K-major
// tiles are stored [rows][kBK + 4] and the others [kBK][rows + 8]; both
// paddings make the fragment loads below free of bank conflicts. K-major
// fragments come in with ldmatrix (four 8 x 4 float matrices a call), the
// others with one 32-bit load per value.
//
// Products: mma.sync m16n8k8 TF32 in the 3xTF32 form. Each operand value
// x is split in registers after its shared-memory load into hi = x rounded
// to TF32 and lo = x - hi, and the warp accumulates
// a_lo b_hi + a_hi b_lo + a_hi b_hi in float32. hi and lo keep 11 + 11
// significant bits and only the a_lo b_lo term (~2^-22 relative) is
// dropped, so the result is float32-accurate where one TF32 pass keeps
// about three decimal digits. The tensor core does not add as IEEE f32
// does. Its bf16 m16n8k16 sums (the bf16 tiles below), measured by
// chip_smoke.py's phase 3e on an NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit and modelled bit for bit by ops/tc_sum.py: the 16 products
// and the accumulator form one block, aligned to its largest exponent,
// each cut toward zero to 25 bits below it, and the sum rounded toward
// zero. Its TF32 sums were not probed; over a 512-deep chain of TF32 mma
// steps the logits drifted past the float32 tolerance the kernels are
// held to. So each stage's products (32 deep) go into a fragment that
// starts at zero, and that is added to the float32 accumulator with an
// ordinary round-to-nearest add.
//
// A CTA of WARPS_M x WARPS_N warps owns a BM x BN output tile, each warp a
// (BM / WARPS_M) x (BN / WARPS_N) sub-tile of m16n8 mma tiles. `Gemm::run`
// walks `ntiles` output tiles that share their rows (columns n0, n0 + BN,
// ...) as one sequence of stages, so the copies of the next tile overlap
// the products of the current one, and hands each finished tile to an
// epilogue.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "precision.cuh"

namespace tc {

constexpr int kBK = 32;        // contraction depth of one stage
constexpr int kStages = 3;     // depth of the cp.async ring

struct Operand {
  const float* p;
  int ld;
  int rows;   // extent along the output dimension
  int kext;   // extent along the contraction
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo with hi = x rounded to TF32 (to nearest, ties away from
// zero: add half an ulp of the 10-bit mantissa to the bit pattern and
// clear the 13 low bits) and lo = x - hi, exact. The mma reads lo's top
// 11 significant bits (it ignores the low 13 bits of a .tf32 operand).
// Two integer operations and one float subtraction: cvt.rna.tf32.f32
// compiles to a longer compare-and-select sequence on sm_90a, and the
// kernels ran slower with it.
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (the accumulator input is zero)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (the accumulator input is zero)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Four 8 x 4 float matrices from shared memory, lanes 8q .. 8q + 7 giving
// the addresses of matrix q's 16-byte rows; lane l receives element
// (l / 4, l % 4) of each matrix, the m16n8k8 fragment order.
__device__ __forceinline__ void ldsm_x4(const float* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One operand's stage tile in shared memory: ROWS x kBK values.
template <int ROWS, bool KMAJOR>
struct Tile {
  static constexpr int kLd = KMAJOR ? kBK + 4 : ROWS + 8;
  static constexpr int kFloats = KMAJOR ? ROWS * kLd : kBK * kLd;

  __device__ static __forceinline__ int at(int row, int k) {
    return KMAJOR ? row * kLd + k : k * kLd + row;
  }

  // This thread's share of the copy of rows [row0, row0 + ROWS) and k in
  // [k0, k0 + kBK) of op into s. VEC: 16-byte copies (op.ld % 4 == 0 and
  // op.p 16-byte aligned); a copy that straddles an extent reads only the
  // bytes inside it and zero-fills the rest.
  template <int THREADS, bool VEC>
  __device__ static __forceinline__ void load(float* s, const Operand& op,
                                              int row0, int k0) {
    if constexpr (VEC) {
      constexpr int kChunks = ROWS * kBK / 4;
      static_assert(kChunks % THREADS == 0, "tile copy must split evenly");
      #pragma unroll
      for (int q = 0; q < kChunks / THREADS; ++q) {
        const int c = static_cast<int>(threadIdx.x) + q * THREADS;
        int row, k, bytes;
        const float* src;
        if constexpr (KMAJOR) {
          row = c / (kBK / 4);
          k = (c % (kBK / 4)) * 4;
          const int gr = row0 + row, gk = k0 + k;
          bytes = gr < op.rows ? 4 * max(0, min(4, op.kext - gk)) : 0;
          src = op.p + (size_t)gr * op.ld + gk;
        } else {
          k = c / (ROWS / 4);
          row = (c % (ROWS / 4)) * 4;
          const int gr = row0 + row, gk = k0 + k;
          bytes = gk < op.kext ? 4 * max(0, min(4, op.rows - gr)) : 0;
          src = op.p + (size_t)gk * op.ld + gr;
        }
        cp_async16(s + at(row, k), bytes > 0 ? src : op.p, bytes);
      }
    } else {
      constexpr int kElems = ROWS * kBK;
      static_assert(kElems % THREADS == 0, "tile copy must split evenly");
      #pragma unroll 4
      for (int q = 0; q < kElems / THREADS; ++q) {
        const int e = static_cast<int>(threadIdx.x) + q * THREADS;
        const int row = KMAJOR ? e / kBK : e % ROWS;
        const int k = KMAJOR ? e % kBK : e / ROWS;
        const int gr = row0 + row, gk = k0 + k;
        const bool ok = gr < op.rows && gk < op.kext;
        const float* src = KMAJOR ? op.p + (size_t)gr * op.ld + gk
                                  : op.p + (size_t)gk * op.ld + gr;
        cp_async4(s + at(row, k), ok ? src : op.p, ok ? 4 : 0);
      }
    }
  }

  // The raw A fragment of the m16 tile at row r0, k kk: a0 (g, t),
  // a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) with g = lane / 4,
  // t = lane % 4.
  __device__ static __forceinline__ void frag_a(const float* s, int r0,
                                                int kk, unsigned (&a)[4]) {
    const int lane = threadIdx.x & 31;
    if constexpr (KMAJOR) {
      const int q = lane >> 3;
      ldsm_x4(s + at(r0 + (lane & 7) + 8 * (q & 1), kk + 4 * (q >> 1)), a);
    } else {
      const int g = lane >> 2, t = lane & 3;
      a[0] = __float_as_uint(s[at(r0 + g, kk + t)]);
      a[1] = __float_as_uint(s[at(r0 + g + 8, kk + t)]);
      a[2] = __float_as_uint(s[at(r0 + g, kk + t + 4)]);
      a[3] = __float_as_uint(s[at(r0 + g + 8, kk + t + 4)]);
    }
  }

  // The raw B fragments of the n8 tiles at rows c0 (first) and c0 + 8
  // (second), k kk: b0 (k = t, n = g), b1 (k = t + 4, n = g) of each.
  __device__ static __forceinline__ void frag_b2(const float* s, int c0,
                                                 int kk,
                                                 unsigned (&first)[2],
                                                 unsigned (&second)[2]) {
    const int lane = threadIdx.x & 31;
    if constexpr (KMAJOR) {
      const int q = lane >> 3;
      unsigned r[4];
      ldsm_x4(s + at(c0 + (lane & 7) + 8 * (q >> 1), kk + 4 * (q & 1)), r);
      first[0] = r[0];
      first[1] = r[1];
      second[0] = r[2];
      second[1] = r[3];
    } else {
      const int g = lane >> 2, t = lane & 3;
      first[0] = __float_as_uint(s[at(c0 + g, kk + t)]);
      first[1] = __float_as_uint(s[at(c0 + g, kk + t + 4)]);
      second[0] = __float_as_uint(s[at(c0 + 8 + g, kk + t)]);
      second[1] = __float_as_uint(s[at(c0 + 8 + g, kk + t + 4)]);
    }
  }
};

// The product of one stage, added to the warp's accumulators (C fragment
// order: c0/c1 at (g, 2t / 2t + 1), c2/c3 at (g + 8, 2t / 2t + 1)).
template <class TA, class TB, int kMT, int kNT>
__device__ __forceinline__ void stage_mma(const float* sa, const float* sb,
                                          int wm0, int wn0,
                                          float (&acc)[kMT][kNT][4]) {
  static_assert(kNT % 2 == 0, "B fragments come in pairs of n8 tiles");
  float part[kMT][kNT][4];
  #pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned ah[kMT][4], al[kMT][4];
    #pragma unroll
    for (int i = 0; i < kMT; ++i) {
      unsigned raw[4];
      TA::frag_a(sa, wm0 + 16 * i, kk, raw);
      #pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], ah[i][e], al[i][e]);
    }
    unsigned braw[kNT][2];
    #pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      TB::frag_b2(sb, wn0 + 8 * j, kk, braw[j], braw[j + 1]);
    }
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      unsigned bh[2], bl[2];
      split_tf32(braw[j][0], bh[0], bl[0]);
      split_tf32(braw[j][1], bh[1], bl[1]);
      #pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (kk == 0) {
          mma_tf32_zero(part[i][j], al[i], bh);
        } else {
          mma_tf32(part[i][j], al[i], bh);
        }
        mma_tf32(part[i][j], ah[i], bl);
        mma_tf32(part[i][j], ah[i], bh);
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < kMT; ++i) {
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
}

template <int kMT, int kNT>
__device__ __forceinline__ void zero(float (&acc)[kMT][kNT][4]) {
  #pragma unroll
  for (int i = 0; i < kMT; ++i) {
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
}

// P is the precision tag (tc::F32, precision.cuh), which the kernels
// built on a Gemm carry into their names.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool A_KMAJOR,
          bool B_KMAJOR, class P = F32>
struct Gemm {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWarpM = BM / WARPS_M;   // warp tile rows
  static constexpr int kWarpN = BN / WARPS_N;   // warp tile columns
  static constexpr int kMT = kWarpM / 16;
  static constexpr int kNT = kWarpN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0,
                "the warps must tile the CTA tile in mma tiles");
  using Acc = float[kMT][kNT][4];
  using TA = Tile<BM, A_KMAJOR>;
  using TB = Tile<BN, B_KMAJOR>;
  static constexpr int kStageFloats = TA::kFloats + TB::kFloats;
  static constexpr int kSmemBytes =
      kStages * kStageFloats * static_cast<int>(sizeof(float));

  // First row / column of this warp's sub-tile inside the CTA tile.
  __device__ static __forceinline__ int warp_m0() {
    return (static_cast<int>(threadIdx.x) / 32 / WARPS_N) * kWarpM;
  }
  __device__ static __forceinline__ int warp_n0() {
    return (static_cast<int>(threadIdx.x) / 32 % WARPS_N) * kWarpN;
  }

  // Output tiles (m0, n0 + i BN) for i < ntiles, each summed over the
  // whole contraction (A.kext). Before each stage's product:
  // hook(A stage tile, B stage tile). After each tile's last stage:
  // epi(i, acc) with acc[i][j][e] at row warp_m0() + 16 i + lane / 4
  // + 8 (e / 2) and column warp_n0() + 8 j + 2 (lane % 4) + e % 2 of the
  // tile. Returns with every copy landed and the CTA synchronised, so the
  // caller may reuse smem.
  template <bool VEC_A, bool VEC_B, class Epi, class Hook>
  __device__ static __forceinline__ void run(float* smem, const Operand& A,
                                             const Operand& B, int m0,
                                             int n0, int ntiles, Epi&& epi,
                                             Hook&& hook) {
    const int wm0 = warp_m0(), wn0 = warp_n0();
    const int ksteps = (A.kext + kBK - 1) / kBK;
    const int total = ntiles * ksteps;
    auto load = [&](int it) {
      float* s = smem + (it % kStages) * kStageFloats;
      const int tile = it / ksteps;
      const int k0 = (it - tile * ksteps) * kBK;
      TA::template load<kThreads, VEC_A>(s, A, m0, k0);
      TB::template load<kThreads, VEC_B>(s + TA::kFloats, B, n0 + tile * BN,
                                         k0);
    };
    #pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < total) load(s);
      cp_async_commit();
    }
    Acc acc;
    zero(acc);
    int kstep = 0, tile = 0;
    for (int it = 0; it < total; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < total) load(it + kStages - 1);
      cp_async_commit();
      const float* s = smem + (it % kStages) * kStageFloats;
      hook(s, s + TA::kFloats);
      stage_mma<TA, TB, kMT, kNT>(s, s + TA::kFloats, wm0, wn0, acc);
      if (++kstep == ksteps) {
        epi(tile, acc);
        zero(acc);
        kstep = 0;
        ++tile;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// bf16 tiles: operands that are bf16 in device memory
// ---------------------------------------------------------------------------
//
// The mode of K1's, K2's and K6's bf16 products (csrc/lstmp_train.cu,
// csrc/lstmp_tc16.cuh, csrc/lstmp_stack.cu). Each
// operand is a bf16 copy made once where its value is produced: a weight
// rounded once a call, an activation or a gradient written in bf16 by the
// epilogue that computes it. So nothing is rounded in the mainloop, and a
// stage crosses L2 and shared memory in half the bytes of the f32 ring
// above. Tiles are bf16 ([rows][BK + 8] K-major, [BK][rows + 8] along the
// output dimension: rows of 80 or 144 bytes, an odd number of 16-byte
// units, so the fragment loads are free of bank conflicts); every copy is
// a 16-byte cp.async with zero fill past an extent, so leading dimensions
// are multiples of 8 elements and bases 16-byte aligned (the callers pad
// their copies). Fragments come in with ldmatrix of b16 (.trans for an
// operand stored along the output dimension), one mma.sync m16n8k16 bf16
// per 16 of depth. Each stage's products (BK deep: 32 by default, 64 in
// the bf16 K1) go into a fragment that starts at zero and is added to the
// f32 accumulator, for the reason in the header: a chained accumulator
// cuts each new product 25 bits under its own exponent, so the cut grows
// as the sum does. STAGES is the
// ring's depth: a product with a long contraction and few tiles keeps
// more stages in flight.

struct Operand16 {
  const __nv_bfloat16* p;
  int ld;     // elements, a multiple of 8
  int rows;   // extent along the output dimension
  int kext;   // extent along the contraction
};

// ldmatrix .x4 .trans: lane l receives elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of each stored 8 x 8 matrix
__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One operand's stage tile: ROWS x BK bf16 values.
template <int ROWS, bool KMAJOR, int BK = kBK>
struct Tile16 {
  static constexpr int kLd = KMAJOR ? BK + 8 : ROWS + 8;
  static constexpr int kElems = KMAJOR ? ROWS * kLd : BK * kLd;

  __device__ static __forceinline__ int at(int row, int k) {
    return KMAJOR ? row * kLd + k : k * kLd + row;
  }

  template <int THREADS>
  __device__ static __forceinline__ void load(__nv_bfloat16* s,
                                              const Operand16& op, int row0,
                                              int k0) {
    constexpr int kChunks = ROWS * BK / 8;
    static_assert(kChunks % THREADS == 0, "tile copy must split evenly");
    #pragma unroll
    for (int q = 0; q < kChunks / THREADS; ++q) {
      const int c = static_cast<int>(threadIdx.x) + q * THREADS;
      int row, k, bytes;
      const __nv_bfloat16* src;
      if constexpr (KMAJOR) {
        row = c / (BK / 8);
        k = (c % (BK / 8)) * 8;
        const int gr = row0 + row, gk = k0 + k;
        bytes = gr < op.rows ? 2 * max(0, min(8, op.kext - gk)) : 0;
        src = op.p + (size_t)gr * op.ld + gk;
      } else {
        k = c / (ROWS / 8);
        row = (c % (ROWS / 8)) * 8;
        const int gr = row0 + row, gk = k0 + k;
        bytes = gk < op.kext ? 2 * max(0, min(8, op.rows - gr)) : 0;
        src = op.p + (size_t)gk * op.ld + gr;
      }
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(s + at(row, k))),
                      "l"(bytes > 0 ? src : op.p), "r"(bytes)
                   : "memory");
    }
  }

  // The m16n8k16 A fragment of rows r0 .. r0 + 15, k kk .. kk + 15.
  __device__ static __forceinline__ void frag_a(const __nv_bfloat16* s,
                                                int r0, int kk,
                                                unsigned (&a)[4]) {
    const int lane = threadIdx.x & 31;
    const int q = lane >> 3;
    if constexpr (KMAJOR) {
      ldsm_x4(reinterpret_cast<const float*>(
                  s + at(r0 + (lane & 7) + 8 * (q & 1), kk + 8 * (q >> 1))),
              a);
    } else {
      ldsm_x4_t(s + at(r0 + 8 * (q & 1), kk + (lane & 7) + 8 * (q >> 1)), a);
    }
  }

  // The B fragments (b0: k kk .. kk + 7, b1: k kk + 8 .. kk + 15) of the
  // n8 tiles at rows c0 (first) and c0 + 8 (second).
  __device__ static __forceinline__ void frag_b2(const __nv_bfloat16* s,
                                                 int c0, int kk,
                                                 unsigned (&first)[2],
                                                 unsigned (&second)[2]) {
    const int lane = threadIdx.x & 31;
    const int q = lane >> 3;
    unsigned r[4];
    if constexpr (KMAJOR) {
      ldsm_x4(reinterpret_cast<const float*>(
                  s + at(c0 + (lane & 7) + 8 * (q >> 1), kk + 8 * (q & 1))),
              r);
    } else {
      ldsm_x4_t(s + at(c0 + 8 * (q >> 1), kk + 8 * (q & 1) + (lane & 7)), r);
    }
    first[0] = r[0];
    first[1] = r[1];
    second[0] = r[2];
    second[1] = r[3];
  }
};

template <class TA, class TB, int kMT, int kNT, int BK = kBK>
__device__ __forceinline__ void stage_mma16(const __nv_bfloat16* sa,
                                            const __nv_bfloat16* sb, int wm0,
                                            int wn0,
                                            float (&acc)[kMT][kNT][4]) {
  static_assert(kNT % 2 == 0, "B fragments come in pairs of n8 tiles");
  float part[kMT][kNT][4];
  #pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned a[kMT][4];
    #pragma unroll
    for (int i = 0; i < kMT; ++i) TA::frag_a(sa, wm0 + 16 * i, kk, a[i]);
    #pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      unsigned b0[2], b1[2];
      TB::frag_b2(sb, wn0 + 8 * j, kk, b0, b1);
      #pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (kk == 0) {
          mma_bf16_zero(part[i][j], a[i], b0);
          mma_bf16_zero(part[i][j + 1], a[i], b1);
        } else {
          mma_bf16(part[i][j], a[i], b0);
          mma_bf16(part[i][j + 1], a[i], b1);
        }
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < kMT; ++i) {
    #pragma unroll
    for (int j = 0; j < kNT; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
}

// Gemm's mainloop over bf16 operands and tiles (one output tile a call),
// in BK-deep stages.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool A_KMAJOR,
          bool B_KMAJOR, int STAGES, int BK = kBK>
struct Gemm16 {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWarpM = BM / WARPS_M;
  static constexpr int kWarpN = BN / WARPS_N;
  static constexpr int kMT = kWarpM / 16;
  static constexpr int kNT = kWarpN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0,
                "the warps must tile the CTA tile in mma tiles");
  using Acc = float[kMT][kNT][4];
  using TA = Tile16<BM, A_KMAJOR, BK>;
  using TB = Tile16<BN, B_KMAJOR, BK>;
  static constexpr int kStageElems = TA::kElems + TB::kElems;
  static constexpr int kSmemBytes =
      STAGES * kStageElems * static_cast<int>(sizeof(__nv_bfloat16));

  __device__ static __forceinline__ int warp_m0() {
    return (static_cast<int>(threadIdx.x) / 32 / WARPS_N) * kWarpM;
  }
  __device__ static __forceinline__ int warp_n0() {
    return (static_cast<int>(threadIdx.x) / 32 % WARPS_N) * kWarpN;
  }

  // The output tile (m0, n0) summed over the whole contraction (A.kext),
  // handed to epi(acc) (fragment order as Gemm::run's). Returns with every
  // copy landed and the CTA synchronised.
  template <class Epi>
  __device__ static __forceinline__ void run(__nv_bfloat16* smem,
                                             const Operand16& A,
                                             const Operand16& B, int m0,
                                             int n0, Epi&& epi) {
    const int wm0 = warp_m0(), wn0 = warp_n0();
    const int total = (A.kext + BK - 1) / BK;
    auto load = [&](int it) {
      __nv_bfloat16* s = smem + (it % STAGES) * kStageElems;
      TA::template load<kThreads>(s, A, m0, it * BK);
      TB::template load<kThreads>(s + TA::kElems, B, n0, it * BK);
    };
    #pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load(s);
      cp_async_commit();
    }
    Acc acc;
    zero(acc);
    for (int it = 0; it < total; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (it + STAGES - 1 < total) load(it + STAGES - 1);
      cp_async_commit();
      const __nv_bfloat16* s = smem + (it % STAGES) * kStageElems;
      stage_mma16<TA, TB, kMT, kNT, BK>(s, s + TA::kElems, wm0, wn0, acc);
    }
    epi(acc);
    cp_async_wait<0>();
    __syncthreads();
  }
};

}  // namespace tc
