// Fused senone affine + softmax + masked cross-entropy, forward (K3) and
// backward (K4), float32 with float32 accumulation. Logits never reach
// device memory.
//
// K3 replaces kaldi_lstm_tpu/ops/xent_pallas.py::_fwd_kernel. For frames
// r [N, R] and the output layer W [K, R] (Kaldi orientation), b [K]:
//   z = r W^T + b, per row: lse = logsumexp(z) (online over class tiles),
//   picked = sum_j tw[j] z[id_j], the max of z and its FIRST index (strict
//   > across tiles, lowest index within a tile: Kaldi's FindRowMaxId).
// One block owns 32 frames and walks all classes in tiles of 64; each
// logit tile is formed in registers from shared-memory chunks of r and W
// and parked in shared memory for the row reductions (one warp per row).
//
// K4 replaces kaldi_lstm_tpu/ops/xent_pallas.py::_bwd_kernel. With
// dz = scale (wtot exp(z - lse) - sum_j tw_j onehot(id_j)), where scale is
// the loss cotangent times the frame mask and wtot = sum_j tw_j, it
// produces dr = dz W, dW = dz^T r and db = sum_n dz. Neither z nor dz is
// stored; two kernels, each recomputing z tile by tile:
//   dr pass: one block per 32 frames, looping over class tiles;
//   dW pass: one block per 64 classes, looping over frame tiles (dW and db
//            rows belong to one block: no atomics, reproducible sums).
// The recomputation is the price of keeping z out of memory: K4 does
// 4 x 2NKR operations where 3 x 2NKR would do with a stored z.
// Rows with scale 0 (masked frames) give dz = 0 exactly: exp(z - lse) is
// at most 1 for the row's own lse, so no inf * 0 arises from a large bias.
// Frames past N and classes past K are masked in the kernels; nothing is
// padded.
//
// What bounds them on an H100: operations, 2NKR = 41.9 GFLOP for K3 and
// 4 x that for K4 at the flagship shape (N = 5120, R = 512, K = 8000),
// against ~18 MB of compulsory traffic. This first design uses CUDA-core
// fma from shared-memory tiles (no tensor cores); dW and dr are
// read-modify-written in device memory (L2-resident) once per tile.
// Tensor-core tiles are later work (ROADMAP.md).
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/xent_affine.py through ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kFT = 32;        // frames per tile
constexpr int kKT = 64;        // classes per tile
constexpr int kBK = 32;        // contraction chunk over R
constexpr int kQT = 64;        // R columns per dr / dW update chunk
constexpr int kThreads = 256;  // 16 x 16; a thread owns 2 rows x 4 cols
constexpr float kNeg = -1e30f;

struct ZTileSmem {
  float rs[kBK][kFT + 1];      // r chunk, transposed
  float ws[kBK][kKT + 1];      // W chunk, transposed
};

// acc[u][v] = sum_k r[n0 + ty + 16u, k] W[c0 + tx + 16v, k] (no bias).
// Rows past N and classes past K read zeros.
__device__ __forceinline__ void logits_tile(const float* __restrict__ r,
                                            const float* __restrict__ w,
                                            int N, int R, int K, int n0,
                                            int c0, ZTileSmem& sm,
                                            float acc[2][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  #pragma unroll
  for (int u = 0; u < 2; ++u) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  }
  for (int k0 = 0; k0 < R; k0 += kBK) {
    for (int e = tid; e < kFT * kBK; e += kThreads) {
      const int row = e / kBK;
      const int kk = e % kBK;
      const int n = n0 + row;
      const int k = k0 + kk;
      sm.rs[kk][row] = (n < N && k < R) ? r[(size_t)n * R + k] : 0.f;
    }
    for (int e = tid; e < kKT * kBK; e += kThreads) {
      const int col = e / kBK;
      const int kk = e % kBK;
      const int c = c0 + col;
      const int k = k0 + kk;
      sm.ws[kk][col] = (c < K && k < R) ? w[(size_t)c * R + k] : 0.f;
    }
    __syncthreads();
    #pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = sm.rs[kk][ty];
      const float a1 = sm.rs[kk][ty + 16];
      #pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float bv = sm.ws[kk][tx + 16 * v];
        acc[0][v] = fmaf(a0, bv, acc[0][v]);
        acc[1][v] = fmaf(a1, bv, acc[1][v]);
      }
    }
    __syncthreads();
  }
}

// dz of the thread's 2 x 4 logits, in place. z = acc + b. Zero outside
// [0, N) x [0, K).
__device__ __forceinline__ void dz_tile(float acc[2][4],
                                        const float* __restrict__ b,
                                        const int* __restrict__ ids,
                                        const float* __restrict__ tw,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ wtot,
                                        int N, int K, int Km, int n0,
                                        int c0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  #pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = n0 + ty + 16 * u;
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + tx + 16 * v;
      float d = 0.f;
      if (n < N && c < K) {
        const float z = acc[u][v] + b[c];
        d = expf(z - lse[n]) * wtot[n];
        for (int j = 0; j < Km; ++j) {
          if (ids[(size_t)n * Km + j] == c) d = d - tw[(size_t)n * Km + j];
        }
        d = d * scale[n];
      }
      acc[u][v] = d;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K3. grid = ceil(N / 32) blocks of 256 threads.
__global__ void xent_fwd_kernel(const float* __restrict__ r,
                                const float* __restrict__ w,
                                const float* __restrict__ b,
                                const int* __restrict__ ids,
                                const float* __restrict__ tw,
                                float* __restrict__ lse,
                                float* __restrict__ picked,
                                float* __restrict__ amax,
                                int* __restrict__ aidx,
                                int N, int R, int K, int Km) {
  __shared__ ZTileSmem sm;
  __shared__ float zs[kFT][kKT + 1];
  __shared__ float m_s[kFT], s_s[kFT], p_s[kFT], av_s[kFT];
  __shared__ int ai_s[kFT];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * kFT;
  if (tid < kFT) {
    m_s[tid] = kNeg;
    s_s[tid] = 0.f;
    p_s[tid] = 0.f;
    av_s[tid] = kNeg;
    ai_s[tid] = 0;
  }

  float acc[2][4];
  for (int c0 = 0; c0 < K; c0 += kKT) {
    logits_tile(r, w, N, R, K, n0, c0, sm, acc);
    #pragma unroll
    for (int u = 0; u < 2; ++u) {
      #pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + tx + 16 * v;
        zs[ty + 16 * u][tx + 16 * v] = c < K ? acc[u][v] + b[c] : -INFINITY;
      }
    }
    __syncthreads();
    // one warp per row: 8 warps x 4 rows; lane owns columns lane, lane+32
    for (int row = warp; row < kFT; row += kThreads / 32) {
      const int n = n0 + row;
      if (n >= N) continue;     // warp-uniform
      const float z0 = zs[row][lane];
      const float z1 = zs[row][lane + 32];
      const float tmax = warp_max(fmaxf(z0, z1));
      const int cand = z0 >= tmax ? lane : (z1 >= tmax ? lane + 32 : kKT);
      const int first = warp_min_int(cand);
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, tmax);
      const float se = warp_sum(expf(z0 - m_new) + expf(z1 - m_new));
      if (lane == 0) {
        s_s[row] = s_s[row] * expf(m_old - m_new) + se;
        m_s[row] = m_new;
        if (tmax > av_s[row]) {   // strictly greater: the first max wins
          av_s[row] = tmax;
          ai_s[row] = c0 + first;
        }
        float p = p_s[row];
        for (int j = 0; j < Km; ++j) {
          const int id = ids[(size_t)n * Km + j];
          if (id >= c0 && id < c0 + kKT && id < K) {
            p += tw[(size_t)n * Km + j] * zs[row][id - c0];
          }
        }
        p_s[row] = p;
      }
    }
    __syncthreads();
  }
  if (tid < kFT && n0 + tid < N) {
    const int n = n0 + tid;
    lse[n] = m_s[tid] + logf(s_s[tid]);
    picked[n] = p_s[tid];
    amax[n] = av_s[tid];
    aidx[n] = ai_s[tid];
  }
}

// K4, dr pass. grid = ceil(N / 32) blocks; dr [N, R] is this block's rows
// only, written at the first class tile and accumulated after.
__global__ void xent_bwd_dr_kernel(const float* __restrict__ r,
                                   const float* __restrict__ w,
                                   const float* __restrict__ b,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ tw,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ wtot,
                                   float* __restrict__ dr,
                                   int N, int R, int K, int Km) {
  __shared__ ZTileSmem sm;
  __shared__ float zs[kFT][kKT + 1];
  __shared__ float wq[kKT][kQT + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kFT;
  float acc[2][4];
  for (int c0 = 0; c0 < K; c0 += kKT) {
    logits_tile(r, w, N, R, K, n0, c0, sm, acc);
    dz_tile(acc, b, ids, tw, lse, scale, wtot, N, K, Km, n0, c0);
    #pragma unroll
    for (int u = 0; u < 2; ++u) {
      #pragma unroll
      for (int v = 0; v < 4; ++v) zs[ty + 16 * u][tx + 16 * v] = acc[u][v];
    }
    // dr[n0 + row, q] += sum_c dz[row, c] W[c0 + c, q]
    for (int q0 = 0; q0 < R; q0 += kQT) {
      for (int e = tid; e < kKT * kQT; e += kThreads) {
        const int cc = e / kQT;
        const int qq = e % kQT;
        const int c = c0 + cc;
        const int q = q0 + qq;
        wq[cc][qq] = (c < K && q < R) ? w[(size_t)c * R + q] : 0.f;
      }
      __syncthreads();
      float d[2][4];
      #pragma unroll
      for (int u = 0; u < 2; ++u) {
        #pragma unroll
        for (int v = 0; v < 4; ++v) d[u][v] = 0.f;
      }
      #pragma unroll 8
      for (int cc = 0; cc < kKT; ++cc) {
        const float a0 = zs[ty][cc];
        const float a1 = zs[ty + 16][cc];
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float bv = wq[cc][tx + 16 * v];
          d[0][v] = fmaf(a0, bv, d[0][v]);
          d[1][v] = fmaf(a1, bv, d[1][v]);
        }
      }
      #pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = n0 + ty + 16 * u;
        if (n >= N) continue;
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int q = q0 + tx + 16 * v;
          if (q >= R) continue;
          float* o = dr + (size_t)n * R + q;
          *o = (c0 == 0) ? d[u][v] : *o + d[u][v];
        }
      }
      __syncthreads();
    }
  }
}

// K4, dW / db pass. grid = ceil(K / 64) blocks; dW [K, R] and db [K] rows
// belong to this block, written at the first frame tile and accumulated
// after.
__global__ void xent_bwd_dw_kernel(const float* __restrict__ r,
                                   const float* __restrict__ w,
                                   const float* __restrict__ b,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ tw,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ wtot,
                                   float* __restrict__ dw,
                                   float* __restrict__ db,
                                   int N, int R, int K, int Km) {
  __shared__ ZTileSmem sm;
  __shared__ float zs[kFT][kKT + 1];
  __shared__ float rq[kFT][kQT + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.x * kKT;
  float db_acc = 0.f;           // thread tid < 64 owns class c0 + tid
  float acc[2][4];
  for (int n0 = 0; n0 < N; n0 += kFT) {
    logits_tile(r, w, N, R, K, n0, c0, sm, acc);
    dz_tile(acc, b, ids, tw, lse, scale, wtot, N, K, Km, n0, c0);
    #pragma unroll
    for (int u = 0; u < 2; ++u) {
      #pragma unroll
      for (int v = 0; v < 4; ++v) zs[ty + 16 * u][tx + 16 * v] = acc[u][v];
    }
    __syncthreads();
    if (tid < kKT) {
      float s = 0.f;
      #pragma unroll 8
      for (int row = 0; row < kFT; ++row) s += zs[row][tid];
      db_acc += s;
    }
    // dW[c0 + cls, q] += sum_row dz[row, cls] r[n0 + row, q]
    for (int q0 = 0; q0 < R; q0 += kQT) {
      for (int e = tid; e < kFT * kQT; e += kThreads) {
        const int row = e / kQT;
        const int qq = e % kQT;
        const int n = n0 + row;
        const int q = q0 + qq;
        rq[row][qq] = (n < N && q < R) ? r[(size_t)n * R + q] : 0.f;
      }
      __syncthreads();
      float d[4][4];
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        #pragma unroll
        for (int v = 0; v < 4; ++v) d[u][v] = 0.f;
      }
      #pragma unroll 8
      for (int row = 0; row < kFT; ++row) {
        float av[4], bv[4];
        #pragma unroll
        for (int u = 0; u < 4; ++u) av[u] = zs[row][ty + 16 * u];
        #pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = rq[row][tx + 16 * v];
        #pragma unroll
        for (int u = 0; u < 4; ++u) {
          #pragma unroll
          for (int v = 0; v < 4; ++v) d[u][v] = fmaf(av[u], bv[v], d[u][v]);
        }
      }
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + ty + 16 * u;
        if (c >= K) continue;
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int q = q0 + tx + 16 * v;
          if (q >= R) continue;
          float* o = dw + (size_t)c * R + q;
          *o = (n0 == 0) ? d[u][v] : *o + d[u][v];
        }
      }
      __syncthreads();
    }
  }
  if (tid < kKT && c0 + tid < K) db[c0 + tid] = db_acc;
}

}  // namespace

// K3: one launch. r [N, R], w [K, R], b [K], ids/tw [N, Km]. Out: lse,
// picked, amax [N] float, aidx [N] int32. Returns cudaGetLastError().
extern "C" int xent_affine_fwd_f32(const float* r, const float* w,
                                   const float* b, const int* ids,
                                   const float* tw, float* lse,
                                   float* picked, float* amax, int* aidx,
                                   int N, int R, int K, int Km,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  xent_fwd_kernel<<<(N + kFT - 1) / kFT, kThreads, 0, st>>>(
      r, w, b, ids, tw, lse, picked, amax, aidx, N, R, K, Km);
  return static_cast<int>(cudaGetLastError());
}

// K4: two launches (dr pass, dW/db pass). lse [N] from K3, scale [N] =
// loss cotangent x frame mask, wtot [N] = sum_j tw. Out: dr [N, R],
// dw [K, R], db [K]. Returns cudaGetLastError().
extern "C" int xent_affine_bwd_f32(const float* r, const float* w,
                                   const float* b, const int* ids,
                                   const float* tw, const float* lse,
                                   const float* scale, const float* wtot,
                                   float* dr, float* dw, float* db, int N,
                                   int R, int K, int Km, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  xent_bwd_dr_kernel<<<(N + kFT - 1) / kFT, kThreads, 0, st>>>(
      r, w, b, ids, tw, lse, scale, wtot, dr, N, R, K, Km);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_bwd_dw_kernel<<<(K + kKT - 1) / kKT, kThreads, 0, st>>>(
      r, w, b, ids, tw, lse, scale, wtot, dw, db, N, R, K, Km);
  return static_cast<int>(cudaGetLastError());
}
