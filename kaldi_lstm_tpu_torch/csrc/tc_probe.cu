// Probes of the H100 tensor core's bf16 -> f32 sums (sm_90a): the two
// instructions that the bf16 kernels sum with, run once on fragments the
// caller supplies, so that ops/tc_sum.py can hold its model of their
// arithmetic (tc_dot) to the card bit for bit. Replaces no TPU kernel and
// runs on no path of the package: chip_smoke.py's phase 3e and the gpu
// tests of tests/test_torch_bf16_tc.py call it.
//
//   tc_probe_mma:   one mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per
//                   warp, D = A B^T (+ C): tc_gemm.cuh's mma_bf16_zero
//                   (a zero accumulator, as K5, K7 and the first slice of
//                   every Gemm16 stage run it) or mma_bf16 (the caller's
//                   accumulator, as the later slices of a stage chain it).
//   tc_probe_wgmma: one chain of `depth` wgmma.mma_async m64n128k16 (bf16
//                   in, f32 accumulate) per CTA of one warpgroup, on
//                   wg_gemm.cuh's mma_m64n128k16 and its 128-byte
//                   swizzled K-major descriptors, the accumulator starting
//                   at zero (as K3, K4 and K1's wgmma xw start) or at C.
//
// Operands are bf16 in device memory, K-major: A [n][M][K], B [n][N][K]
// (element (row, k) at row * K + k), C and D f32 [n][M][N]. Fragments are
// read straight from device memory (mma) or staged in shared memory by
// ordinary stores (wgmma), in 64-deep stages as the ring stages them.
// Bound by nothing of interest: a probe is timed by no one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

// One m16n8k16 per warp: A fragment a[0..3] = rows (g, g + 8) x k pairs
// (2t, 2t + 8); B fragment b[0..1] = k pairs (2t, 2t + 8) of column g;
// D element e = row g + 8 (e / 2), column 2t + e % 2 (g = lane / 4,
// t = lane % 4), the PTX ISA's m16n8k16 .bf16 layouts.
__global__ void probe_mma_kernel(const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ b,
                                 const float* __restrict__ c,
                                 float* __restrict__ d, int n) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (warp >= n) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned* pa =
      reinterpret_cast<const unsigned*>(a + (size_t)warp * 16 * 16);
  const unsigned* pb =
      reinterpret_cast<const unsigned*>(b + (size_t)warp * 8 * 16);
  // 32-bit words: row r, k pair p at r * 8 + p
  unsigned af[4] = {pa[g * 8 + t], pa[(g + 8) * 8 + t], pa[g * 8 + t + 4],
                    pa[(g + 8) * 8 + t + 4]};
  unsigned bf[2] = {pb[g * 8 + t], pb[g * 8 + t + 4]};
  float acc[4];
  if (c == nullptr) {
    tc::mma_bf16_zero(acc, af, bf);
  } else {
    const float* pc = c + (size_t)warp * 16 * 8;
    acc[0] = pc[g * 8 + 2 * t];
    acc[1] = pc[g * 8 + 2 * t + 1];
    acc[2] = pc[(g + 8) * 8 + 2 * t];
    acc[3] = pc[(g + 8) * 8 + 2 * t + 1];
    tc::mma_bf16(acc, af, bf);
  }
  float* pd = d + (size_t)warp * 16 * 8;
  pd[g * 8 + 2 * t] = acc[0];
  pd[g * 8 + 2 * t + 1] = acc[1];
  pd[(g + 8) * 8 + 2 * t] = acc[2];
  pd[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// The byte offset of (row, k) in a K-major stage tile of 64 k a row with
// 128-byte swizzling: what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes for the
// ring's K-major boxes (wg_gemm.cuh's header), 1024-byte aligned base.
__device__ __forceinline__ uint32_t kmajor_offset(int row, int k) {
  return row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) + (k & 7) * 2;
}

constexpr int kProbeA = 64 * wg::kBK * 2;    // A stage tile, 8 KB
constexpr int kProbeB = 128 * wg::kBK * 2;   // B stage tile, 16 KB
constexpr int kProbeSmem = kProbeA + kProbeB + 1024;

// One warpgroup (128 threads) per chain: D [64][128] = A [64][K] B^T
// (+ C), K = 16 depth, staged 64 deep, zero past K.
__global__ void __launch_bounds__(128)
probe_wgmma_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ d,
                   int depth) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sa = smem_raw + (base - raw);
  unsigned char* sb = sa + kProbeA;
  const int K = 16 * depth;
  const __nv_bfloat16* pa = a + (size_t)blockIdx.x * 64 * K;
  const __nv_bfloat16* pb = b + (size_t)blockIdx.x * 128 * K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[64];
  // element d[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 t + e
  if (c != nullptr) {
    const float* pc = c + (size_t)blockIdx.x * 64 * 128;
    #pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      acc[i] = pc[row * 128 + col];
    }
  } else {
    #pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  int issued = 0;
  for (int k0 = 0; k0 < K; k0 += wg::kBK) {
    // 16-byte chunks of 8 k: A 64 x 8 of them, B 128 x 8
    for (int q = tid; q < (64 + 128) * 8; q += 128) {
      const bool is_a = q < 64 * 8;
      const int qq = is_a ? q : q - 64 * 8;
      const int row = qq >> 3, k = (qq & 7) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + k < K) {
        const __nv_bfloat16* src =
            (is_a ? pa : pb) + (size_t)row * K + k0 + k;
        v = *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>((is_a ? sa : sb) + kmajor_offset(row, k)) =
          v;
    }
    wg::fence_async_smem();
    __syncthreads();
    wg::fence_acc(acc);
    wg::mma_fence();
    const int steps = min(wg::kBK / 16, depth - k0 / 16);
    for (int kk = 0; kk < steps; ++kk) {
      wg::mma_m64n128k16<0, 0>(acc, wg::operand_desc<false>(
                                        wg::smem_u32(sa), kk),
                               wg::operand_desc<false>(wg::smem_u32(sb),
                                                       kk),
                               (issued > 0 || c != nullptr) ? 1 : 0);
      ++issued;
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_acc(acc);
    __syncthreads();
  }
  float* pd = d + (size_t)blockIdx.x * 64 * 128;
  #pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    pd[row * 128 + col] = acc[i];
  }
}

}  // namespace

// n instructions: a [n][16][16], b [n][8][16] bf16, c [n][16][8] f32 or
// null (a zero accumulator), d [n][16][8] f32.
extern "C" int tc_probe_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                            const float* c, float* d, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n * 32 + threads - 1) / threads;
  probe_mma_kernel<<<blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, b, c, d, n);
  return cudaGetLastError();
}

// n chains: a [n][64][16 depth], b [n][128][16 depth] bf16, c [n][64][128]
// f32 or null (the chain starts at zero), d [n][64][128] f32.
extern "C" int tc_probe_wgmma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                              const float* c, float* d, int n, int depth,
                              void* stream) {
  if (n <= 0 || depth <= 0) return 0;
  probe_wgmma_kernel<<<n, 128, kProbeSmem,
                       static_cast<cudaStream_t>(stream)>>>(a, b, c, d,
                                                            depth);
  return cudaGetLastError();
}
