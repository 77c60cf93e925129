// The persistent, weight-resident CUDA-core recurrence shared by K5
// (csrc/lstmp_infer.cu, one LSTMP layer) and K7 (csrc/lstmp_stack.cu, two
// layers on the wavefront): the staged block product, the cell math, the
// release/acquire grid barrier and the cooperative launch.
//
// A persistent kernel runs one CTA per SM (at most), launched
// cooperatively, so that every CTA is resident and a grid-wide barrier
// cannot hang. Each CTA keeps slices of the weights in shared memory for
// the whole call; per step it stages the rows every CTA needs ([x_t |
// r_{t-1}], then m) from L2 and sums its slice's columns on the CUDA
// cores (block_product below). Every sum runs in a fixed order, so
// results repeat from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "precision.cuh"

namespace pk {

constexpr int kThreads = 256;
constexpr int kBufFloats = 8192;     // one of two 32 KB staging buffers
constexpr int kStageFloats = 2 * kBufFloats;
constexpr int kMinBufFloats = 2048;  // the least a staging buffer may hold
constexpr int kMaxGroups = 8;        // stream groups of 8 per tile (64)
constexpr int kMaxKSplit = kThreads; // threads sharing one contraction

__host__ __device__ __forceinline__ size_t round4(size_t n) {
  return (n + 3) / 4 * 4;
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, through L2 only (.cg): data that other CTAs
// wrote before the grid barrier is never read from a stale L1 line.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Threads splitting one contraction: a power of two, so that a unit's
// threads are an aligned group of lanes of one warp, or whole warps.
__device__ __forceinline__ int k_split(int units) {
  int ksn = 1;
  while (2 * ksn <= kMaxKSplit && 2 * ksn * units <= kThreads) ksn *= 2;
  return ksn;
}

// sums(s, quad, g) = sum_k A(s, k) W(k, 4 quad + g), g < 4, for the S
// streams and nquad quads of output columns, k over [kb, ke) =
// krange(quad) (a sub-range of [0, K): several products that share
// their staged rows in one pass). A(s, k) = *src(s, k) in device memory
// (VEC: 16-byte aligned runs of 4 k), W(k, 4 quad + .) from
// load_w(k, quad, w[4]); epi(s, quad, sums[4]) once per (s, quad).
// Quads go in blocks of at most kThreads, streams in tiles of 8 ng (up to
// 64). A unit (8 streams x 1 quad) is summed by ksn threads over
// k = ks (mod ksn), chunk by chunk through two staging buffers of `buf`
// floats each at `stage` ([stream][k], the next chunk's cp.async in
// flight while the current one is summed); the sums of a warp's lanes
// are added by a fixed xor butterfly, those of a unit's warps (ksn > 32)
// in warp order through shared memory. Under tc::Bf16 each staged A value
// is rounded to bf16 as it is read. `buf` is a multiple of 4 and at least
// kMinBufFloats, which keeps every chunk at least one k-step deep.
// Uniform over the CTA.
template <bool VEC, class P, class Src, class KRange, class LoadW,
          class Epi>
__device__ __forceinline__ void block_product(float* stage, int buf, int S,
                                              int K, int nquad, Src src,
                                              KRange krange, LoadW load_w,
                                              Epi epi) {
  const int tid = threadIdx.x;
  for (int cb0 = 0; cb0 < nquad; cb0 += kThreads) {
    const int ncb = min(kThreads, nquad - cb0);
    const int groups_max = min(kMaxGroups, max(1, kThreads / ncb));
    for (int s0 = 0; s0 < S; s0 += 8 * groups_max) {
      const int sn = min(8 * groups_max, S - s0);
      const int ng = (sn + 7) / 8;
      const int units = ncb * ng;
      const int ksn = k_split(units);
      const int step = max(4, ksn);
      const int kc = min((K + step - 1) / step * step,
                         buf / (8 * ng) / step * step);
      const int nch = (K + kc - 1) / kc;
      const int unit = tid / ksn, ks = tid % ksn;
      const bool active = unit < units;
      const int sg = active ? unit / ncb : 0;
      const int col = active ? unit % ncb : 0;
      const int2 kr = krange(cb0 + col);

      // rows s0 .. s0 + sn, k in [k0, k0 + kn) of chunk ch -> buffer
      auto issue = [&](int ch) {
        float* bufp = stage + (ch & 1) * buf;
        const int k0 = ch * kc, kn = min(kc, K - k0);
        if (VEC) {
          const int nv = kn / 4;
          int s = tid / nv, v = tid % nv;
          while (s < sn) {
            cp_async16(bufp + s * kc + 4 * v, src(s0 + s, k0 + 4 * v));
            v += kThreads;
            while (v >= nv && s < sn) {
              v -= nv;
              ++s;
            }
          }
        } else {
          const int total = sn * kn;
          for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
            float val[8];
            #pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int e = e0 + u * kThreads;
              val[u] = e < total ? __ldcg(src(s0 + e / kn, k0 + e % kn))
                                 : 0.f;
            }
            #pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int e = e0 + u * kThreads;
              if (e < total) bufp[(e / kn) * kc + e % kn] = val[u];
            }
          }
        }
        cp_async_commit();
      };

      float acc[8][4];
      #pragma unroll
      for (int i = 0; i < 8; ++i) {
        #pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
      }
      __syncthreads();   // the previous users of the buffers are done
      issue(0);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch) {
          issue(ch + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          const int k0 = ch * kc;
          const int lo = max(0, kr.x - k0), hi = min(kc, min(K, kr.y) - k0);
          const float* arow = stage + (ch & 1) * buf + 8 * sg * kc;
          for (int k = lo + ks; k < hi; k += ksn) {
            float w[4];
            load_w(k0 + k, cb0 + col, w);
            #pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = tc::at_use<P>(arow[i * kc + k]);
              #pragma unroll
              for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(a, w[g], acc[i][g]);
            }
          }
        }
        __syncthreads();   // before the buffer is refilled
      }
      // The unit's lane sums, in a fixed order: a reduce-scatter over the
      // stream index along lane bits 0-2 (after it, entry i of a lane with
      // (i & (L - 1)) == 0, L = min(ksn, 8), holds stream i + (lane &
      // (L - 1))), then an all-reduce along lane bits 3-4. The two lanes
      // of an exchange add the same two values, so they agree.
      const int lane = tid & 31;
      #pragma unroll
      for (int o = 4; o >= 1; o >>= 1) {
        if (o < ksn) {
          const bool up = (lane & o) != 0;
          #pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i & o) continue;
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float send = up ? acc[i][g] : acc[i | o][g];
              const float keep = up ? acc[i | o][g] : acc[i][g];
              acc[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
          }
        }
      }
      #pragma unroll
      for (int o = 8; o <= 16; o <<= 1) {
        if (o < ksn) {
          #pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[0][g] += __shfl_xor_sync(0xffffffffu, acc[0][g], o);
          }
        }
      }
      const int lmask = min(ksn, 8) - 1;
      if (ksn > 32) {
        // lanes 0-7 of each of the unit's warps hold its 8 streams: in
        // buffer 0 (free: the chunk loop ended on a barrier) as
        // [unit][warp of the unit][stream], then warp 0 adds them in order
        const int wpu = ksn / 32, wu = ks / 32;
        float4* red = reinterpret_cast<float4*>(stage);
        if (active && lane < 8) {
          red[(unit * wpu + wu) * 8 + lane] =
              make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        }
        __syncthreads();
        if (active && wu == 0 && lane < 8) {
          float4 v = red[unit * wpu * 8 + lane];
          for (int w = 1; w < wpu; ++w) {
            const float4 u = red[(unit * wpu + w) * 8 + lane];
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          acc[0][0] = v.x;
          acc[0][1] = v.y;
          acc[0][2] = v.z;
          acc[0][3] = v.w;
        }
      }
      if (active && ks <= lmask) {
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int s = s0 + 8 * sg + i + ks;
          if ((i & lmask) == 0 && s < S) epi(s, cb0 + col, acc[i]);
        }
      }
    }
  }
}

// krange of a product over the whole staged row [0, K).
struct FullRange {
  int K;
  __device__ __forceinline__ int2 operator()(int) const {
    return make_int2(0, K);
  }
};

// The bf16 pair of a 32-bit word as floats: element 0 is the low half.
__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Four resident weights at ws: one 16-byte (f32) or 8-byte (bf16) load.
template <class P>
__device__ __forceinline__ void load4(const typename P::Store* ws,
                                      float (&w)[4]) {
  if constexpr (P::kBf16) {
    const uint2 v = *reinterpret_cast<const uint2*>(ws);
    w[0] = bf16_lo(v.x); w[1] = bf16_hi(v.x);
    w[2] = bf16_lo(v.y); w[3] = bf16_hi(v.y);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(ws);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

// One cell's step from its gate pre-activations (bias included): gate
// order g, i, f, o; the i/f peepholes read c_prev, the o peephole the
// clipped new c. Writes the new c to *cn and returns m = tanh(c) o.
__device__ __forceinline__ float cell_step(float g_pre, float i_pre,
                                           float f_pre, float o_pre,
                                           float c_prev, float pi, float pf,
                                           float po, float cell_clip,
                                           float* cn_out) {
  const float g = tanhf(g_pre);
  const float i = sigmoid_f(i_pre + c_prev * pi);
  const float f = sigmoid_f(f_pre + c_prev * pf);
  float cn = g * i + c_prev * f;
  if (cell_clip > 0.f) {
    // written out (not fminf/fmaxf) so that a NaN propagates like clip
    cn = cn < -cell_clip ? -cell_clip : (cn > cell_clip ? cell_clip : cn);
  }
  const float o = sigmoid_f(o_pre + cn * po);
  *cn_out = cn;
  return tanhf(cn) * o;
}

// Grid barrier: after the CTA's own barrier, thread 0 adds its arrival
// with release semantics (publishing the CTA's writes, ordered before it
// by __syncthreads) and polls the count with acquire loads until every
// CTA of this barrier has arrived (one round trip to L2 fewer than
// cooperative_groups' grid sync, which fences, adds with a returned value
// and then polls). The cooperative launch keeps every CTA resident, so
// the poll cannot wait on a CTA that never runs. The counter is zeroed on
// the stream before the launch.
struct GridBarrier {
  unsigned* bar;
  unsigned target;

  __device__ __forceinline__ void sync() {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(bar) : "memory");
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(v) : "l"(bar) : "memory");
      } while (static_cast<int>(v - target) < 0);   // wraps safely
    }
    __syncthreads();
  }
};

// The card's SM count and opt-in shared memory per block; refuses a card
// without cooperative launch.
inline cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// One cooperative launch of `kernel` (kThreads a CTA, `smem` bytes of
// dynamic shared memory) on `stream`, after zeroing the barrier counter
// there. A grid that cannot be co-resident is refused, never run.
// cudaLaunchKernelEx with the cooperative attribute is the form of a
// cooperative launch that stream capture takes (the grouped CV step
// replays K5 inside a CUDA graph); outside a capture it launches the
// same grid as cudaLaunchCooperativeKernel.
inline cudaError_t launch_cooperative(const void* kernel, int grid, int smem,
                                      int sms, unsigned* bar, void** args,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pk
