// LSTMP training forward with residuals (K1) and its BPTT backward (K2),
// float32 throughout with float32 accumulation.
//
// K1 replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_fwd_kernel. Over T steps
// (gate order g, i, f, o; Kaldi weight orientation):
//
//   xw  = x_t Wx^T, times keep_mask_t * inv_keep when dropout is on,
//         then + bias                            (dropout before the bias)
//   pre = xw + r_{t-1} Wr^T
//   g = tanh(g_pre), i = sigmoid(i_pre + c_{t-1} p_i),
//   f = sigmoid(f_pre + c_{t-1} p_f)
//   c = clip(g i + c_{t-1} f, +-cell_clip)           (no clip if <= 0)
//   o = sigmoid(o_pre + c_t p_o)                     (clipped c_t)
//   r = (tanh(c_t) o) Wrm^T
//
// and writes the POST-activation gates g, i, f, o, the clipped c and r for
// every t (the residuals K2 reads). Two launches per step on the caller's
// stream, as in lstmp_infer.cu: gates (a thread owns one (stream, cell)
// pair, x_t and r_{t-1} rows of the block's 8 streams staged in shared
// memory), then the projection.
//
// K2 replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_bwd_kernel. A grid has
// no carry from block to block, so it is split in two:
//   (a) a serial reverse loop over t, two launches per step:
//       bwd_cell:  dr_total = g_r[t] + dr; dm = dr_total Wrm; the gate
//                  gradients (from the post-activation residuals); the dc
//                  carry through f and the i/f peepholes, straight through
//                  the clip. Writes dgifo[t] and dr_total[t].
//       proj:      dr = dgifo[t] Wr   (gradient into r_{t-1}).
//   (b) after the loop, the frame-axis contractions over N = T*S rows, the
//       hoisted GEMMs of the reference and of the Pallas kernel's v1:
//       dWx = dxw^T x, dWr = dgifo^T r_prev, dWrm = dr_total^T (h o),
//       dbias and the three peephole sums, and dx = dxw Wx when asked.
//       dxw = dgifo * keep_mask * inv_keep (dropout gates only the input
//       branch); r_prev is r0 at t = 0; h o is recomputed from c and o.
//       Each output tile belongs to one block that loops over all N rows:
//       no atomics, so the gradients are the same from run to run.
//
// What bounds them on an H100: operations. At the flagship shape (T=20,
// S=256, I=40, C=800, R=512) K1 does 22.3 GFLOP and K2 44.6 GFLOP of f32
// multiply-adds against a few hundred MB of residual traffic. This first
// design is the simple one: CUDA-core fma from shared-memory tiles, no
// tensor cores, weights served from L2; the per-step launches of the two
// serial chains are latency-bound at small S. Tensor-core (TF32/bf16
// wgmma) tiles and a persistent recurrence are later work (ROADMAP.md).
//
// Built with nvcc into a shared library with a plain C entry point per
// kernel, loaded by kaldi_lstm_tpu_torch/ops/lstm_train.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCells = 32;    // threadIdx.x: cells / output columns
constexpr int kStreams = 8;   // threadIdx.y: streams per block
constexpr int kChunk = 512;   // staged K elements per stream and pass

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// K1: one step of the forward
// ---------------------------------------------------------------------------

// x_t [S, I], r_prev [S, R], w_cat [(I + R), 4C] = [Wx^T; Wr^T], bias [4C],
// peep [3, C] (i, f, o), c_prev [S, C], mask_t [S, 4C] int8 or null.
// Out: gifo_t [S, 4C] (activations), c_t [S, C], m [S, C] = tanh(c_t) o.
__global__ void train_gates_kernel(const float* __restrict__ x_t,
                                   const float* __restrict__ r_prev,
                                   const float* __restrict__ w_cat,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ peep,
                                   const float* __restrict__ c_prev,
                                   const int8_t* __restrict__ mask_t,
                                   float inv_keep,
                                   float* __restrict__ gifo_t,
                                   float* __restrict__ c_t,
                                   float* __restrict__ m,
                                   int S, int I, int R, int C,
                                   float cell_clip) {
  __shared__ float rows[kStreams][kChunk];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (j < C) && (s < S);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  // phase 0 contracts x_t with Wx^T, phase 1 r_{t-1} with Wr^T; the
  // dropout mask and the bias land between the two, as in _fwd_kernel
  for (int phase = 0; phase < 2; ++phase) {
    const float* src = phase == 0 ? x_t : r_prev;
    const int K = phase == 0 ? I : R;
    const float* wbase = w_cat + (phase == 0 ? 0 : (size_t)I * C4);
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kn = min(kChunk, K - k0);
      for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
        const int ss = e / kn;
        const int kk = e % kn;
        const int sg = s0 + ss;
        rows[ss][kk] = (sg < S) ? src[(size_t)sg * K + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (active) {
        const float* w = wbase + (size_t)k0 * C4 + j;
        #pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float v = rows[sl][kk];
          acc[0] = fmaf(v, w[0], acc[0]);
          acc[1] = fmaf(v, w[C], acc[1]);
          acc[2] = fmaf(v, w[2 * (size_t)C], acc[2]);
          acc[3] = fmaf(v, w[3 * (size_t)C], acc[3]);
          w += C4;
        }
      }
      __syncthreads();
    }
    if (phase == 0 && active) {
      #pragma unroll
      for (int g = 0; g < 4; ++g) {
        float xw = acc[g];
        if (mask_t != nullptr) {
          xw = xw * ((float)mask_t[(size_t)s * C4 + (size_t)g * C + j] *
                     inv_keep);
        }
        acc[g] = xw + bias[(size_t)g * C + j];
      }
    }
  }
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const float cp = c_prev[idx];
  const float g = tanhf(acc[0]);
  const float i = sigmoid_f(acc[1] + cp * peep[j]);
  const float f = sigmoid_f(acc[2] + cp * peep[C + j]);
  float cn = g * i + cp * f;
  if (cell_clip > 0.f) {
    // written out (not fminf/fmaxf) so that a NaN propagates like clip
    cn = cn < -cell_clip ? -cell_clip : (cn > cell_clip ? cell_clip : cn);
  }
  const float o = sigmoid_f(acc[3] + cn * peep[2 * C + j]);
  float* gr = gifo_t + (size_t)s * C4;
  gr[j] = g;
  gr[C + j] = i;
  gr[2 * (size_t)C + j] = f;
  gr[3 * (size_t)C + j] = o;
  c_t[idx] = cn;
  m[idx] = tanhf(cn) * o;
}

// out[s, q] = sum_k a[s, k] w[k, q] for s < S, q < Q, k < K: a [S, K],
// w [K, Q] row-major. The K1 projection (a = m, w = Wrm^T) and the K2
// recurrent gradient (a = dgifo[t], w = Wr) are both this product.
__global__ void rows_times_mat_kernel(const float* __restrict__ a,
                                      const float* __restrict__ w,
                                      float* __restrict__ out,
                                      int S, int K, int Q) {
  __shared__ float rows[kStreams][kChunk];
  const int q = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (q < Q) && (s < S);
  float acc = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
      const int ss = e / kn;
      const int sg = s0 + ss;
      rows[ss][e % kn] = (sg < S) ? a[(size_t)sg * K + k0 + e % kn] : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* wp = w + (size_t)k0 * Q + q;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        acc = fmaf(rows[sl][kk], *wp, acc);
        wp += Q;
      }
    }
    __syncthreads();
  }
  if (active) out[(size_t)s * Q + q] = acc;
}

// ---------------------------------------------------------------------------
// K2 (a): one step of the reverse recurrence
// ---------------------------------------------------------------------------

// g_r_t [S, R] (cotangent of r_t from the layer above), dr [S, R] (carry:
// gradient into r_t through step t+1), wrm [R, C] (Kaldi orientation),
// gifo_t [S, 4C] activations, c_t and c_prev [S, C], peep [3, C],
// dc [S, C] in: gradient into c_t from step t+1, out: into c_{t-1}.
// Out: dgifo_t [S, 4C] pre-activation gradients, drt_t [S, R] dr_total.
__global__ void bwd_cell_kernel(const float* __restrict__ g_r_t,
                                const float* __restrict__ dr,
                                const float* __restrict__ wrm,
                                const float* __restrict__ gifo_t,
                                const float* __restrict__ c_t,
                                const float* __restrict__ c_prev,
                                const float* __restrict__ peep,
                                float* __restrict__ dc,
                                float* __restrict__ dgifo_t,
                                float* __restrict__ drt_t,
                                int S, int R, int C) {
  __shared__ float rows[kStreams][kChunk];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (j < C) && (s < S);
  float dm = 0.f;

  for (int k0 = 0; k0 < R; k0 += kChunk) {
    const int kn = min(kChunk, R - k0);
    for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
      const int ss = e / kn;
      const int kk = e % kn;
      const int sg = s0 + ss;
      float v = 0.f;
      if (sg < S) {
        const size_t o = (size_t)sg * R + k0 + kk;
        v = g_r_t[o] + dr[o];
        if (blockIdx.x == 0) drt_t[o] = v;   // one writer per row
      }
      rows[ss][kk] = v;
    }
    __syncthreads();
    if (active) {
      const float* w = wrm + (size_t)k0 * C + j;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        dm = fmaf(rows[sl][kk], *w, dm);
        w += C;
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const float* gr = gifo_t + (size_t)s * C4;
  const float g = gr[j];
  const float i = gr[C + j];
  const float f = gr[2 * (size_t)C + j];
  const float o = gr[3 * (size_t)C + j];
  const float c = c_t[idx];
  const float cp = c_prev[idx];
  const float h = tanhf(c);
  const float dh = dm * o;
  const float dc_from_h = dh * (1.0f - h * h);
  const float d_o = dm * h * o * (1.0f - o);
  // straight-through clip: dc flows through the forward clip unchanged
  const float dc_total = dc[idx] + dc_from_h + d_o * peep[2 * C + j];
  const float df = dc_total * cp * f * (1.0f - f);
  const float di = dc_total * g * i * (1.0f - i);
  const float dg = dc_total * i * (1.0f - g * g);
  float* dgr = dgifo_t + (size_t)s * C4;
  dgr[j] = dg;
  dgr[C + j] = di;
  dgr[2 * (size_t)C + j] = df;
  dgr[3 * (size_t)C + j] = d_o;
  dc[idx] = dc_total * f + di * peep[j] + df * peep[C + j];
}

// ---------------------------------------------------------------------------
// K2 (b): frame-axis contractions
// ---------------------------------------------------------------------------

constexpr int kTM = 64;       // output rows per block
constexpr int kTP = 64;       // output columns per block
constexpr int kTK = 16;       // contraction chunk
constexpr int kCThreads = 256;

enum BMode { kBPlain = 0, kBShift = 1, kBTanhTimes = 2 };

// B(k, p) for the three right-hand operands of K2 (b):
//   kBPlain:     b[k*sbk + p]                                   (x, Wx)
//   kBShift:     k < shift ? b2[k*sbk + p] : b[(k-shift)*sbk + p]
//                (r_{t-1} rows: r0 for t = 0, then r_seq shifted by S)
//   kBTanhTimes: tanh(b[k*sbk + p]) * b2[k*sb2k + p]   (h o from c and o)
template <int MODE>
__device__ __forceinline__ float load_b(const float* __restrict__ b,
                                        const float* __restrict__ b2,
                                        size_t sbk, size_t sb2k, int shift,
                                        int k, int p) {
  if (MODE == kBPlain) return b[(size_t)k * sbk + p];
  if (MODE == kBShift) {
    return k < shift ? b2[(size_t)k * sbk + p]
                     : b[(size_t)(k - shift) * sbk + p];
  }
  return tanhf(b[(size_t)k * sbk + p]) * b2[(size_t)k * sb2k + p];
}

// out[m, p] = sum_{k < K} A(m, k) B(k, p) for m < M, p < P, out [M, P]
// row-major. A(m, k) = a[m*sam + k*sak], times amask[same] * inv_keep when
// amask is given. One block owns one 64 x 64 output tile and walks all of
// K in a fixed order: no atomics, reproducible sums.
template <int MODE>
__global__ void contract_kernel(const float* __restrict__ a,
                                const int8_t* __restrict__ amask,
                                float inv_keep, size_t sam, size_t sak,
                                const float* __restrict__ b,
                                const float* __restrict__ b2,
                                size_t sbk, size_t sb2k, int shift,
                                float* __restrict__ out,
                                int M, int P, int K) {
  __shared__ float As[kTK][kTM + 1];
  __shared__ float Bs[kTK][kTP + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kTM;
  const int p0 = blockIdx.x * kTP;
  float acc[4][4];
  #pragma unroll
  for (int u = 0; u < 4; ++u) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTK * kTM; e += kCThreads) {
      int kk, mm;
      if (sak == 1) {           // neighbouring threads along k
        mm = e / kTK;
        kk = e % kTK;
      } else {                  // neighbouring threads along m
        kk = e / kTM;
        mm = e % kTM;
      }
      const int m = m0 + mm;
      const int k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        const size_t o = (size_t)m * sam + (size_t)k * sak;
        v = a[o];
        if (amask != nullptr) v = v * ((float)amask[o] * inv_keep);
      }
      As[kk][mm] = v;
    }
    for (int e = tid; e < kTK * kTP; e += kCThreads) {
      const int kk = e / kTP;
      const int pp = e % kTP;
      const int p = p0 + pp;
      const int k = k0 + kk;
      Bs[kk][pp] = (p < P && k < K)
                       ? load_b<MODE>(b, b2, sbk, sb2k, shift, k, p)
                       : 0.f;
    }
    __syncthreads();
    #pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float av[4], bv[4];
      #pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = As[kk][ty + 16 * u];
      #pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = Bs[kk][tx + 16 * v];
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        #pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    }
    __syncthreads();
  }
  #pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= M) continue;
    #pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int p = p0 + tx + 16 * v;
      if (p < P) out[(size_t)m * P + p] = acc[u][v];
    }
  }
}

constexpr int kRedCols = 32;   // columns per block
constexpr int kRedRows = 8;    // row groups per column, summed in order

// Column sums over the N = T*S frame rows of dgifo [N, 4C]:
//   col < 4C:        dbias[col] = sum_n dgifo[n, col]
//   col = 4C + w*C + j (w = 0, 1, 2):
//                    dpeep[w, j] = sum_n dgifo[n, (w+1)C + j] * cc(n, j)
//   with cc = c_{t-1} for the i and f peepholes (c0 at t = 0) and the
//   clipped c_t for the o peephole.
// Each thread sums one column over the rows n = rg (mod 8), then the 8
// partial sums are added in a fixed order: reproducible.
__global__ void col_reduce_kernel(const float* __restrict__ dgifo,
                                  const float* __restrict__ c_seq,
                                  const float* __restrict__ c0,
                                  float* __restrict__ dbias,
                                  float* __restrict__ dpeep,
                                  int N, int S, int C) {
  __shared__ float part[kRedRows][kRedCols];
  const int cl = threadIdx.x % kRedCols;
  const int rg = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + cl;
  const size_t C4 = 4 * (size_t)C;
  float acc = 0.f;
  if (col < 7 * C) {
    if (col < (int)C4) {
      for (int n = rg; n < N; n += kRedRows) acc += dgifo[(size_t)n * C4 + col];
    } else {
      const int q = col - (int)C4;
      const int w = q / C;
      const int j = q % C;
      const float* gcol = dgifo + (size_t)(w + 1) * C + j;
      for (int n = rg; n < N; n += kRedRows) {
        float cc;
        if (w == 2) {
          cc = c_seq[(size_t)n * C + j];
        } else {
          cc = n < S ? c0[(size_t)n * C + j] : c_seq[(size_t)(n - S) * C + j];
        }
        acc += gcol[(size_t)n * C4] * cc;
      }
    }
  }
  part[rg][cl] = acc;
  __syncthreads();
  if (rg != 0 || col >= 7 * C) return;
  float sum = 0.f;
  #pragma unroll
  for (int g = 0; g < kRedRows; ++g) sum += part[g][cl];
  if (col < (int)C4) {
    dbias[col] = sum;
  } else {
    dpeep[col - (int)C4] = sum;
  }
}

template <int MODE>
cudaError_t launch_contract(cudaStream_t st, const float* a,
                            const int8_t* amask, float inv_keep, size_t sam,
                            size_t sak, const float* b, const float* b2,
                            size_t sbk, size_t sb2k, int shift, float* out,
                            int M, int P, int K) {
  const dim3 grid((P + kTP - 1) / kTP, (M + kTM - 1) / kTM);
  contract_kernel<MODE><<<grid, kCThreads, 0, st>>>(
      a, amask, inv_keep, sam, sak, b, b2, sbk, sb2k, shift, out, M, P, K);
  return cudaGetLastError();
}

}  // namespace

// K1. Runs the T-step forward on `stream`: 2 launches per step, no
// synchronisation, no allocation. x [T, S, I] time-major; w_cat
// [(I + R), 4C] = [Wx^T; Wr^T]; wrm_t [C, R] = Wrm^T; mask [T, S, 4C] int8
// or null. Out: gifo [T, S, 4C] (g, i, f, o activations), c_out [T, S, C],
// r_out [T, S, R]; m is [S, C] scratch. Returns cudaGetLastError().
extern "C" int lstmp_train_fwd_f32(const float* x, const float* w_cat,
                                   const float* bias, const float* peep,
                                   const float* wrm_t, const float* c0,
                                   const float* r0, const int8_t* mask,
                                   float inv_keep, float* gifo, float* c_out,
                                   float* r_out, float* m, int T, int S,
                                   int I, int C, int R, float cell_clip,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kCells, kStreams);
  const int sblocks = (S + kStreams - 1) / kStreams;
  const dim3 grid_a((C + kCells - 1) / kCells, sblocks);
  const dim3 grid_b((R + kCells - 1) / kCells, sblocks);
  const size_t x_step = (size_t)S * I;
  const size_t g_step = (size_t)S * 4 * C;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  for (int t = 0; t < T; ++t) {
    const float* r_prev = (t == 0) ? r0 : r_out + (t - 1) * r_step;
    const float* c_prev = (t == 0) ? c0 : c_out + (t - 1) * c_step;
    const int8_t* mask_t = mask ? mask + t * g_step : nullptr;
    train_gates_kernel<<<grid_a, block, 0, st>>>(
        x + t * x_step, r_prev, w_cat, bias, peep, c_prev, mask_t, inv_keep,
        gifo + t * g_step, c_out + t * c_step, m, S, I, R, C, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_times_mat_kernel<<<grid_b, block, 0, st>>>(m, wrm_t,
                                                    r_out + t * r_step,
                                                    S, C, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2. Residuals as K1 wrote them (gifo, c_seq, r_seq [T, S, .]), the
// chunk's initial state c0 [S, C], r0 [S, R], x [T, S, I], the weights in
// Kaldi orientation (w_gifo_x [4C, I], w_gifo_r [4C, R], w_r_m [R, C]),
// peep [3, C], mask [T, S, 4C] int8 or null. g_r [T, S, R] is the
// cotangent of every r_t, the final r's already added at T-1.
// In/out: dc [S, C] holds the final c's cotangent on entry and dc0 on
// return; dr [S, R] holds zeros on entry and dr0 on return.
// Scratch: dgifo [T, S, 4C], drt [T, S, R].
// Out: dx [T, S, I] (skipped when null), dwx [4C, I], dwr [4C, R],
// dwrm [R, C], dbias [4C], dpeep [3, C].
// 2T + 4 launches (+1 with dx). Returns cudaGetLastError().
extern "C" int lstmp_train_bwd_f32(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* w_r_m, const float* peep, const float* c0, const float* r0,
    const float* gifo, const float* c_seq, const float* r_seq,
    const int8_t* mask, float inv_keep, const float* g_r, float* dc,
    float* dr, float* dgifo, float* drt, float* dx, float* dwx, float* dwr,
    float* dwrm, float* dbias, float* dpeep, int T, int S, int I, int C,
    int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kCells, kStreams);
  const int sblocks = (S + kStreams - 1) / kStreams;
  const dim3 grid_cell((C + kCells - 1) / kCells, sblocks);
  const dim3 grid_rec((R + kCells - 1) / kCells, sblocks);
  const size_t g_step = (size_t)S * 4 * C;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  cudaError_t err;
  for (int t = T - 1; t >= 0; --t) {
    const float* c_prev = (t == 0) ? c0 : c_seq + (t - 1) * c_step;
    bwd_cell_kernel<<<grid_cell, block, 0, st>>>(
        g_r + t * r_step, dr, w_r_m, gifo + t * g_step, c_seq + t * c_step,
        c_prev, peep, dc, dgifo + t * g_step, drt + t * r_step, S, R, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_times_mat_kernel<<<grid_rec, block, 0, st>>>(
        dgifo + t * g_step, w_gifo_r, dr, S, 4 * C, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int N = T * S;
  const size_t C4 = 4 * (size_t)C;
  // dWx [4C, I] = dxw^T x
  err = launch_contract<kBPlain>(st, dgifo, mask, inv_keep, 1, C4, x,
                                 nullptr, I, 0, 0, dwx, 4 * C, I, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWr [4C, R] = dgifo^T r_prev
  err = launch_contract<kBShift>(st, dgifo, nullptr, 1.f, 1, C4, r_seq, r0,
                                 R, 0, S, dwr, 4 * C, R, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWrm [R, C] = dr_total^T (tanh(c) o)
  err = launch_contract<kBTanhTimes>(st, drt, nullptr, 1.f, 1, R, c_seq,
                                     gifo + 3 * (size_t)C, C, C4, 0, dwrm,
                                     R, C, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  col_reduce_kernel<<<(7 * C + kRedCols - 1) / kRedCols,
                      kRedCols * kRedRows, 0, st>>>(dgifo, c_seq, c0, dbias,
                                                    dpeep, N, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dx != nullptr) {
    // dx [N, I] = dxw Wx
    err = launch_contract<kBPlain>(st, dgifo, mask, inv_keep, C4, 1,
                                   w_gifo_x, nullptr, I, 0, 0, dx, N, I,
                                   4 * C);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
