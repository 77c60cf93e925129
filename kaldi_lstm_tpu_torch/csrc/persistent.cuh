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
// in warp order through shared memory. `buf` is a multiple of 4 and at
// least kMinBufFloats, which keeps every chunk at least one k-step deep.
// Uniform over the CTA.
template <bool VEC, class Src, class KRange, class LoadW, class Epi>
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
              const float a = arow[i * kc + k];
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

// Four resident weights at ws: one 16-byte load.
__device__ __forceinline__ void load4(const float* ws, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(ws);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
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

// ---------------------------------------------------------------------------
// The bf16 tensor-core product of K5's and K7's bf16 entry points (beside
// block_product, which the f32 K5 and K7 keep)
// ---------------------------------------------------------------------------
//
// out(m, s) = sum_k W(m, k) A(s, k) for the mt m16 row tiles of a
// weight slice W (bf16 [m][k], row stride wld: in shared memory with
// WSMEM, else in device memory) and the streams [s_begin, s_end), over
// 16 nslices of depth, on mma.sync m16n8k16 (bf16 in, f32 accumulate):
// the weight rows are the A operand, the streams the n8 tiles. The rows
// of A (bf16 [s][k], row stride lds, so an odd number of 16-byte units
// keeps ldmatrix free of bank conflicts) come in tiles of up to ns
// streams through two buffers of buf_elems at `stage`: issue(buf, s0,
// sn) starts the cp.async copies of rows s0 .. s0 + sn (rows up to the
// next multiple of 8 zero-filled) and commits them, the next tile in
// flight while the current one is summed; CTA b starts at tile
// b (mod tiles). In a tile of nt n8 tiles there
// are units = mt nt output tiles; mma_ksplit(units) warps share each
// unit's contraction, warp ks of them taking the 16-deep slices
// j = ks (mod ksplit). Each slice's product goes into a fragment that
// starts at zero and is added to the warp's f32 sum (the tensor core
// cuts and rounds its sums toward zero, 25 bits below a block's largest
// exponent, as chip_smoke.py's phase 3e measured on an H100 80GB HBM3 at
// 700.00 W: tc_gemm.cuh's header, ops/tc_sum.py). The
// warps' sums land in `part` (128 floats a unit and split, the mma
// fragment order), and epi(s0, sn, sum) reads element (m, s0 + sl) as
// sum(m, sl): the splits added in warp order. Uniform over the CTA;
// synchronises before it first touches `stage` and `part`.

constexpr int kWarps = kThreads / 32;

// put(e, get(e)) for e < n over the CTA's threads, eight get()s of a
// thread issued before their put()s, so that eight loads are in flight.
template <class Get, class Put>
__device__ __forceinline__ void batched_fill(int n, Get get, Put put) {
  for (int e0 = threadIdx.x; e0 < n; e0 += 8 * kThreads) {
    float v[8];
    #pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < n ? get(e) : 0.f;
    }
    #pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) put(e, v[u]);
    }
  }
}
constexpr int kUnitFloats = 128;     // one m16n8 fragment of f32

__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, unsigned (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d = a b, m16n8k16, bf16 operands, f32 result from a zero accumulator
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Warps sharing one unit's contraction: the largest power of two that
// keeps units x splits within the CTA's warps (1 from kWarps units on).
__host__ __device__ __forceinline__ int mma_ksplit(int units) {
  int ks = 1;
  while (2 * ks * units <= kWarps) ks *= 2;
  return ks;
}

// Element (m, sl) of a finished tile from the warps' partial sums.
struct MmaSum {
  const float* part;
  int units, nt, ks;
  __device__ __forceinline__ float operator()(int m, int sl) const {
    const int u = (m >> 4) * nt + (sl >> 3);
    const int off = 4 * (((m & 7) << 2) | ((sl & 7) >> 1)) + (sl & 1) +
                    2 * ((m >> 3) & 1);
    float v = 0.f;
    for (int k = 0; k < ks; ++k) {
      v += part[(k * units + u) * kUnitFloats + off];
    }
    return v;
  }
};

// One warp's share of one output tile: the sum over the 16-deep slices
// j = kidx (mod ks) of j < nslices of weight tile mi (rows mi 16 ..,
// row stride wld, in shared memory with WSMEM, else device memory)
// against the staged rows at bp (this lane's ldmatrix row, slice 0).
template <bool WSMEM>
__device__ __forceinline__ void mma_unit(const __nv_bfloat16* w, int wld,
                                         int mi, const __nv_bfloat16* bp,
                                         int nslices, int kidx, int ks,
                                         float (&acc)[4]) {
  const int lane = threadIdx.x & 31;
  // ldmatrix rows of A (x4): weight row mi 16 + (lane & 7) + 8 (bit 3),
  // k half by lane bit 4
  const __nv_bfloat16* ap;
  if (WSMEM) {
    ap = w + (size_t)(mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * wld +
         8 * (lane >> 4);
  } else {
    ap = w + (size_t)(mi * 16 + (lane >> 2)) * wld + 2 * (lane & 3);
  }
  // a unit-stride loop over this warp's slices: its trip count is known,
  // so the compiler unrolls it and a slice's loads issue before the
  // previous slice's adds (strided by the runtime ks it stayed rolled,
  // each slice waiting on the last: 16% of K7 bf16's step at S=512 on
  // an H100 80GB HBM3 at 700 W, tools/bench_stack_parts.py's rolled16
  // probe)
  const int nj = (nslices - kidx + ks - 1) / ks;
  #pragma unroll 4
  for (int jj = 0; jj < nj; ++jj) {
    const int j = kidx + jj * ks;
    unsigned af[4], bf[2];
    if (WSMEM) {
      ldsm_x4(ap + 16 * j, af);
    } else {
      // the fragment's four 32-bit pairs (rows g, g + 8; k 2t, 2t + 8)
      const unsigned* q = reinterpret_cast<const unsigned*>(ap + 16 * j);
      const size_t row8 = (size_t)8 * wld / 2;
      af[0] = __ldcg(q);
      af[1] = __ldcg(q + row8);
      af[2] = __ldcg(q + 4);
      af[3] = __ldcg(q + row8 + 4);
    }
    ldsm_x2(bp + 16 * j, bf);
    float d[4];
    mma_bf16_zero(d, af, bf);
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
  }
}

// The stream tiles of an mma product: issue() and the double buffer as
// the header above says; tile(a, s0, sn) sums the staged tile at a into
// `part` and returns (units, nt, ks) for epi.
template <class Issue, class Tile, class Epi>
__device__ __forceinline__ void mma_tiles(__nv_bfloat16* stage,
                                          int buf_elems, float* part,
                                          int s_begin, int s_end, int ns,
                                          Issue issue, Tile tile, Epi epi) {
  const int ntiles = (s_end - s_begin + ns - 1) / ns;
  if (ntiles <= 0) return;
  // CTAs start on different tiles, so that they do not all ask L2 for
  // the same rows at once (a stream's sums are the same in any order of
  // tiles)
  const int rot = blockIdx.x % ntiles;
  auto first = [&](int i) { return s_begin + ((i + rot) % ntiles) * ns; };
  __syncthreads();   // the previous users of stage and part are done
  issue(stage, first(0), min(ns, s_end - first(0)));
  for (int i = 0; i < ntiles; ++i) {
    const int s0 = first(i), sn = min(ns, s_end - s0);
    if (i + 1 < ntiles) {
      const int s1 = first(i + 1);
      issue(stage + ((i + 1) & 1) * buf_elems, s1, min(ns, s_end - s1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int3 shape = tile(stage + (i & 1) * buf_elems, sn);
    __syncthreads();
    epi(s0, sn, MmaSum{part, shape.x, shape.y, shape.z});
  }
}

// One set of weight rows of mma_product_sets: mt m16 tiles at w (row
// stride wld; in shared memory where smem, else in device memory),
// contracting over nslices 16-deep slices of the staged rows from their
// element koff (a multiple of 16).
struct RowSet {
  const __nv_bfloat16* w;
  int wld, mt, nslices, koff, smem;
};

// The mma product of one or two row sets (nsets) over one staged tile
// (lds elements a staged row): their m16 tiles are numbered one after the
// other (set 0's first), so epi's sum(m, sl) reads row m of the
// concatenation. K7 in bf16 feeds both layers' gate rows from one staged
// row [x | r1 | r2]: layer 1's over [x | r1], layer 2's over [r1 | r2]
// (koff past x). The units (m16 x n8 tiles) split over the warps, with
// mma_ksplit warps sharing a unit's slices. WSMEM: every set's weights in
// shared memory (1) or in device memory (0), fixed at compile time, or
// each set's own smem (-1).
template <int WSMEM, class Issue, class Epi>
__device__ __forceinline__ void mma_product_sets(
    __nv_bfloat16* stage, int buf_elems, float* part, int s_begin,
    int s_end, int ns, int lds, const RowSet (&sets)[2], int nsets,
    Issue issue, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt0 = sets[0].mt;
  const int mt = mt0 + (nsets > 1 ? sets[1].mt : 0);
  mma_tiles(stage, buf_elems, part, s_begin, s_end, ns, issue,
            [&](const __nv_bfloat16* a, int sn) {
    const int nt = (sn + 7) / 8, units = mt * nt, ks = mma_ksplit(units);
    const int kidx = ks == 1 ? 0 : warp % ks;
    for (int u = ks == 1 ? warp : warp / ks; u < units;
         u += ks == 1 ? kWarps : units) {
      const int mi = u / nt, ni = u % nt;
      const bool two = nsets > 1 && mi >= mt0;
      const RowSet& rs = two ? sets[1] : sets[0];
      // ldmatrix rows of B (x2): stream ni 8 + (lane & 7), k half by lane
      // bit 3
      const __nv_bfloat16* bp = a + (size_t)(ni * 8 + (lane & 7)) * lds +
                                rs.koff + 8 * ((lane >> 3) & 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (WSMEM > 0 || (WSMEM < 0 && rs.smem)) {
        mma_unit<true>(rs.w, rs.wld, two ? mi - mt0 : mi, bp, rs.nslices,
                       kidx, ks, acc);
      } else {
        mma_unit<false>(rs.w, rs.wld, two ? mi - mt0 : mi, bp, rs.nslices,
                        kidx, ks, acc);
      }
      *reinterpret_cast<float4*>(part + (kidx * units + u) * kUnitFloats +
                                 4 * lane) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    return make_int3(units, nt, ks);
  }, epi);
}

// mma_product_sets over one row set: mt m16 tiles of weights at w (row
// stride wld) against nslices 16-deep slices of the staged rows.
template <bool WSMEM, class Issue, class Epi>
__device__ __forceinline__ void mma_product(
    __nv_bfloat16* stage, int buf_elems, float* part, int s_begin,
    int s_end, int ns, int lds, int nslices, const __nv_bfloat16* w,
    int wld, int mt, Issue issue, Epi epi) {
  const RowSet sets[2] = {RowSet{w, wld, mt, nslices, 0, WSMEM}, RowSet{}};
  mma_product_sets<WSMEM ? 1 : 0>(stage, buf_elems, part, s_begin, s_end,
                                  ns, lds, sets, 1, issue, epi);
}

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
