// LSTMP inference forward (projected LSTM with peepholes and cell clip),
// float32 throughout with float32 accumulation: one persistent,
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
// Design. The grid is one CTA per SM (at most), launched with
// cudaLaunchCooperativeKernel, so every CTA is resident and the grid-wide
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
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/lstm_infer.py through ctypes; that module's
// `k5_plan` and `lstm_infer_sliced_plain` mirror the plan and the sums.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBufFloats = 8192;     // one of two 32 KB staging buffers
constexpr int kStageFloats = 2 * kBufFloats;
constexpr int kMaxGroups = 8;        // stream groups of 8 per tile (64)
constexpr int kMaxKSplit = kThreads; // threads sharing one contraction

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
};

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
// streams and nquad quads of output columns. A(s, k) = *src(s, k) in
// device memory (VEC: 16-byte aligned runs of 4 k), W(k, 4 quad + .) from
// load_w(k, quad, w[4]); epi(s, quad, sums[4]) once per (s, quad).
// Quads go in blocks of at most kThreads, streams in tiles of 8 ng (up to
// 64). A unit (8 streams x 1 quad) is summed by ksn threads over
// k = ks (mod ksn), chunk by chunk through two staging buffers
// ([stream][k], the next chunk's cp.async in flight while the current one
// is summed); the sums of a warp's lanes are added by a fixed xor
// butterfly, those of a unit's warps (ksn > 32) in warp order through
// shared memory. Uniform over the CTA.
template <bool VEC, class Src, class LoadW, class Epi>
__device__ __forceinline__ void block_product(float* stage, int S, int K,
                                              int nquad, Src src,
                                              LoadW load_w, Epi epi) {
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
                         kBufFloats / (8 * ng) / step * step);
      const int nch = (K + kc - 1) / kc;
      const int unit = tid / ksn, ks = tid % ksn;
      const bool active = unit < units;
      const int sg = active ? unit / ncb : 0;
      const int col = active ? unit % ncb : 0;

      // rows s0 .. s0 + sn, k in [k0, k0 + kn) of chunk ch -> buffer
      auto issue = [&](int ch) {
        float* buf = stage + (ch & 1) * kBufFloats;
        const int k0 = ch * kc, kn = min(kc, K - k0);
        if (VEC) {
          const int nv = kn / 4;
          int s = tid / nv, v = tid % nv;
          while (s < sn) {
            cp_async16(buf + s * kc + 4 * v, src(s0 + s, k0 + 4 * v));
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
              if (e < total) buf[(e / kn) * kc + e % kn] = val[u];
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
          const int k0 = ch * kc, kn = min(kc, K - k0);
          const float* arow =
              stage + (ch & 1) * kBufFloats + 8 * sg * kc;
          for (int k = ks; k < kn; k += ksn) {
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
      const float4 v =
          *reinterpret_cast<const float4*>(wg + (size_t)k * p.wld + 4 * c);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const float* row = p.w_cat + (size_t)k * C4 + j0 + c;
      #pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = __ldg(row + (size_t)g * C);
    }
  };
  auto load_wq = [&](int k, int quad, float (&w)[4]) {
    if (RESIDENT) {
      const float4 v = *reinterpret_cast<const float4*>(
          wq + (size_t)k * p.qld + 4 * quad);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      #pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int q = 4 * quad + g;
        w[g] = q < nqc ? __ldg(p.wrm_t + (size_t)k * R + q0 + q) : 0.f;
      }
    }
  };

  // Grid barrier: after the CTA's own barrier, thread 0 adds its arrival
  // with release semantics (publishing the CTA's writes, ordered before
  // it by __syncthreads) and polls the count with acquire loads until
  // every CTA of this barrier has arrived. The cooperative launch keeps
  // every CTA resident, so the poll cannot wait on a CTA that never runs.
  unsigned target = 0;
  auto grid_sync = [&]() {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(p.bar) : "memory");
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(v) : "l"(p.bar) : "memory");
      } while (static_cast<int>(v - target) < 0);   // wraps safely
    }
    __syncthreads();
  };
  const size_t r_step = (size_t)S * R;
  for (int t = 0; t < p.T; ++t) {
    const float* x_t = p.x + (size_t)t * S * I;
    const float* r_prev = t == 0 ? p.r0 : p.r_out + (size_t)(t - 1) * r_step;
    float* r_t = p.r_out + (size_t)t * r_step;

    if (nc > 0) {
      block_product<VEC>(
          stage, S, K, nc,
          [&](int s, int k) {
            return k < I ? x_t + (size_t)s * I + k
                         : r_prev + (size_t)s * R + (k - I);
          },
          load_wg,
          [&](int s, int c, const float (&a)[4]) {
            float* cp = csrc + (size_t)s * cstr + c;
            const float c_prev = *cp;
            const float g = tanhf(a[0] + bsrc[c]);
            const float i = sigmoid_f(a[1] + bsrc[bstr + c] +
                                      c_prev * psrc[c]);
            const float f = sigmoid_f(a[2] + bsrc[2 * bstr + c] +
                                      c_prev * psrc[bstr + c]);
            float cn = g * i + c_prev * f;
            if (p.cell_clip > 0.f) {
              // written out (not fminf/fmaxf) so that a NaN propagates
              // like clip
              cn = cn < -p.cell_clip ? -p.cell_clip
                                     : (cn > p.cell_clip ? p.cell_clip : cn);
            }
            const float o = sigmoid_f(a[3] + bsrc[3 * bstr + c] +
                                      cn * psrc[2 * bstr + c]);
            *cp = cn;
            p.m[(size_t)s * C + j0 + c] = tanhf(cn) * o;
          });
    }
    grid_sync();
    if (nquad > 0) {
      block_product<VEC>(
          stage, S, C, nquad,
          [&](int s, int k) { return p.m + (size_t)s * C + k; },
          load_wq,
          [&](int s, int quad, const float (&a)[4]) {
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int q = 4 * quad + g;
              if (q < nqc) r_t[(size_t)s * R + q0 + q] = a[g];
            }
          });
    }
    grid_sync();
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
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  pl->sms = sms;
  pl->ncell = (C + sms - 1) / sms;
  pl->nq = (R + sms - 1) / sms;
  pl->grid = std::max((C + pl->ncell - 1) / pl->ncell,
                      (R + pl->nq - 1) / pl->nq);
  // strides (4 per cell or per quad of projection columns, an odd number
  // of quads) that keep the float4 weight reads of neighbouring k on
  // distinct banks
  const int nquad = (pl->nq + 3) / 4;
  pl->wld = 4 * pl->ncell + (pl->ncell % 2 == 0 ? 4 : 0);
  pl->qld = 4 * nquad + (nquad % 2 == 0 ? 4 : 0);
  // shared memory, each part where it still fits, in this order: the
  // staging buffers, the cells' bias and peepholes, the weight slices, the
  // cells' c state (laid out as stage | bias, peepholes | c | weights)
  const size_t room = static_cast<size_t>(optin) / sizeof(float);
  const size_t cst = round4(7 * (size_t)pl->ncell);
  const size_t weights = (size_t)(I + R) * pl->wld + (size_t)C * pl->qld;
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

}  // namespace

// The launch plan for these widths on the current device: out[0..9] =
// grid, cells per CTA, projection columns per CTA, gate-slice stride,
// projection-slice stride, dynamic shared memory bytes, weights resident
// (1) or read from device memory (0), SM count, the cells' bias and
// peepholes in shared memory (1) or not, their c state in shared memory
// (1) or not. Returns a CUDA error code.
extern "C" int lstmp_infer_plan(int S, int I, int C, int R, int* out) {
  Plan pl;
  const cudaError_t err = make_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[10] = {pl.grid, pl.ncell, pl.nq, pl.wld, pl.qld, pl.smem,
                     pl.resident, pl.sms, pl.cst_smem, pl.c_smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
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
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = make_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging copies need every row of x, r and m 16-byte aligned
  const bool vec = I % 4 == 0 && R % 4 == 0 && C % 4 == 0;
  const void* kernel =
      pl.resident
          ? (vec ? reinterpret_cast<const void*>(lstmp_infer_kernel<true, true>)
                 : reinterpret_cast<const void*>(
                       lstmp_infer_kernel<true, false>))
          : (vec ? reinterpret_cast<const void*>(
                       lstmp_infer_kernel<false, true>)
                 : reinterpret_cast<const void*>(
                       lstmp_infer_kernel<false, false>));
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * pl.sms < pl.grid) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  Params prm{x, w_cat, bias, peep, wrm_t, r0, c, m, r_out, T, S, I, C, R,
             cell_clip, pl.ncell, pl.nq, pl.wld, pl.qld, pl.cst_smem,
             pl.c_smem, bar};
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned),
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(kernel, dim3(pl.grid), dim3(kThreads),
                                    args, static_cast<size_t>(pl.smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
