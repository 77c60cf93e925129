// LSTMP training forward with residuals (K1) and its BPTT backward (K2):
// float32 throughout with float32 accumulation (the _f32 entry points),
// or with bf16 products (the _bf16 entry points, below).
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
// every t (the residuals K2 reads). 2T + 2 launches on the caller's
// stream, every product on tc_gemm.cuh's 3xTF32 mma.sync mainloop:
//   interleave: wr_perm [4 Cp, R], a copy of Wr's rows dealt so that
//               each 64-column tile of the gates product holds the g, i,
//               f, o columns of 16 cells (C padded to Cp = 16k with zero
//               rows). Made on every call: the optimizer updates the
//               weights in place, so a cached copy would go stale.
//   xw:         the input projection hoisted out of the recurrence, one
//               launch over all N = T S rows: xw = x Wx^T [N, 4C] in
//               64 x 64 tiles, the epilogue applying mask * inv_keep and
//               the bias.
//   per step:   gates, pre = r_{t-1} wr_perm^T [S, 4Cp] in BM x 64 tiles
//               (BM 64, or 32 where 64 leaves SMs idle); the epilogue
//               stages the tile in shared memory, adds xw_t and does the
//               cell math for its 16 cells, writing gifo_t (unpermuted),
//               c_t and m = tanh(c_t) o. xw_t, c_{t-1} and the
//               peepholes are loaded into registers before the mainloop,
//               so their latency hides behind it. Then the projection
//               r_t = m Wrm^T [S, R] in 32 x 32 tiles, straight
//               into r_seq[t]. No product is split over its
//               contraction, so nothing needs a summing pass before r_t
//               feeds step t+1.
// The gate tile's rows come from the caller (ops/lstm_train.py::fwd_plan).
//
// What bounds K1 on an H100: operations. At the flagship shape (T=20,
// S=256, I=40, C=800, R=512) its products are 22.3 GFLOP: 0.135 ms as
// 3xTF32 on the tensor cores (3 x 22.3 GFLOP at 495 TFLOP/s), 0.3326 ms
// on the f32 CUDA cores; the compulsory bytes (x, the weights, gifo, c,
// r) take about 0.03 ms at 3.35 TB/s. Three things keep a CUDA-core
// recurrence far from that: a weight read from L2 for every FMA, the
// input projection x_t Wx^T summed inside every step's serial launch (at
// I=512 it doubles the serial contraction), and the f32 rate itself.
// Here x Wx^T leaves the serial chain for one launch, every product runs
// on the tensor cores from shared-memory tiles, and a step's L2 traffic
// is what the tiles imply: the gates re-read r_{t-1} [S, R] once per
// column tile (4Cp / 64 = 50 times at the flagship shape, 26 MB) and
// wr_perm once per row tile (S / BM = 4 times, 26 MB); the projection
// re-reads m [S, C] R / 32 = 16 times and Wrm S / 32 = 8 times (13 +
// 13 MB). A step is bound by the latency of its serial
// chain of 16 (gates) and 25 (projection) 32-deep stages.
//
// K2 replaces kaldi_lstm_tpu/ops/lstm_pallas.py::_bwd_kernel. A grid has
// no carry from block to block, so it is split in two:
//   (a) a serial reverse loop over t, two launches per step:
//       bwd_cell:  dr_total = g_r[t] + dr, with dr the sum of the previous
//                  step's split-K partials taken in a fixed order;
//                  dm = dr_total Wrm; the gate gradients (from the
//                  post-activation residuals); the dc carry through f and
//                  the i/f peepholes, straight through the clip. Writes
//                  dgifo[t], dr_total[t], h o = tanh(c) o [t] and, with a
//                  keep-mask, dxw[t] = dgifo[t] * mask * inv_keep.
//       dr:        dr = dgifo[t] Wr on the tensor cores (tc_gemm.cuh's
//                  3xTF32 mainloop, 64 x 64 tiles), split over the 4C
//                  contraction into `sp_dr` partials so that the step
//                  fills the card at S=256 (32 tiles x 9 splits).
//   (b) after the loop, the frame-axis contractions over N = T*S rows on
//       the same mainloop, each from operands materialised in (a):
//       dWx = dxw^T x, dWr = dgifo^T r_prev (r_prev = [r0; r_seq[:T-1]]
//       copied contiguous by two cudaMemcpyAsync), dWrm = dr_total^T (h o),
//       and dx = dxw Wx when asked; a product with too few 64 x 64 tiles
//       to fill the card (dWx at I=40: 50) is split over its contraction
//       too. dbias and the three peephole sums come from col_reduce. One
//       last launch adds every product's partials in split order and
//       writes dr0.
//   No atomics: every output value is one thread's sum in a fixed order,
//   so the gradients are the same from run to run. The split counts come
//   from the caller (ops/lstm_train.py::bwd_plan), which also sizes the
//   partial buffers.
//
// What bounds K2 on an H100: operations. At the flagship shape it does
// 43.3 GFLOP of f32 multiply-adds against a few hundred MB of residual
// traffic. It puts 39.1 GFLOP of products on the tensor cores (3 TF32 mma
// per product, float32-accurate); what stays on the CUDA cores is
// bwd_cell's dm product (2 N R C = 4.2 GFLOP) and the serial chain of 2T
// launches.
//
// bf16 (the _bf16 entry points; precision.cuh): the same launches, with
// every product on tc_gemm.cuh's bf16 mode, which rounds x, Wx, r_{t-1},
// Wr, m = tanh(c) o and Wrm (K1), and dgifo, Wr, dxw, x, Wx, r_prev,
// dr_total and h o (K2) to bf16 as each fragment is built, where
// kaldi_lstm_tpu/ops/lstm_pallas.py casts them before its dots; K1 writes
// the gate residual gifo in bf16 (half the bytes), which K2 reads; K2's
// dm product on the CUDA cores rounds dr_total and Wrm at use. The gate
// math, c, r, dgifo, dbias and the peephole sums stay f32. At the
// flagship shape the products' bound drops to 0.023 ms (K1, 22.3 GFLOP at
// 989 TFLOP/s) and 0.040 ms plus dm's 0.063 ms on the CUDA cores (K2).
// The tiles, the f32 staging and the launch schedule are the f32
// kernels'; bf16 operands in shared memory and wgmma are later work.
//
// K1's tiles (the interleave, the hoisted xw, the gates tile with its
// cell epilogue) and the contraction tile live in csrc/lstmp_tc.cuh,
// shared with K6's two-layer wavefront (csrc/lstmp_stack.cu).
//
// Built with nvcc into a shared library with a plain C entry point per
// kernel, loaded by kaldi_lstm_tpu_torch/ops/lstm_train.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lstmp_tc.cuh"

namespace {

using k1::contract;
using k1::GateArgs;
using k1::kGateCells;
using k1::XwArgs;

constexpr int kCells = 32;    // threadIdx.x: cells / output columns
constexpr int kStreams = 8;   // threadIdx.y: streams per block
constexpr int kChunk = 512;   // staged K elements per stream and pass

// ---------------------------------------------------------------------------
// K2 (a): one step of the reverse recurrence
// ---------------------------------------------------------------------------

// g_r_t [S, R] (cotangent of r_t from the layer above); drp [ndrp, S, R]
// the split-K partials of dr (gradient into r_t through step t+1), added
// in order (no partials: dr = 0); wrm [R, C] (Kaldi orientation), gifo_t
// [S, 4C] activations, c_t and c_prev [S, C], peep [3, C], mask_t [S, 4C]
// int8 or null; dc [S, C] in: gradient into c_t from step t+1, out: into
// c_{t-1}. Out: dgifo_t [S, 4C] pre-activation gradients, drt_t [S, R]
// dr_total, ho_t [S, C] = tanh(c_t) o, and with a mask dxw_t [S, 4C] =
// dgifo_t * mask_t * inv_keep. gifo_t is in P's Store type; under
// tc::Bf16 the dm product reads dr_total and wrm rounded to bf16.
template <class P>
__global__ void bwd_cell_kernel(const float* __restrict__ g_r_t,
                                const float* __restrict__ drp, int ndrp,
                                const float* __restrict__ wrm,
                                const typename P::Store* __restrict__ gifo_t,
                                const float* __restrict__ c_t,
                                const float* __restrict__ c_prev,
                                const float* __restrict__ peep,
                                const int8_t* __restrict__ mask_t,
                                float inv_keep,
                                float* __restrict__ dc,
                                float* __restrict__ dgifo_t,
                                float* __restrict__ drt_t,
                                float* __restrict__ ho_t,
                                float* __restrict__ dxw_t,
                                int S, int R, int C) {
  __shared__ float rows[kStreams][kChunk];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const size_t SR = (size_t)S * R;
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
        float dr = 0.f;
        for (int p = 0; p < ndrp; ++p) dr += drp[p * SR + o];
        v = g_r_t[o] + dr;
        if (blockIdx.x == 0) drt_t[o] = v;   // one writer per row
      }
      rows[ss][kk] = tc::at_use<P>(v);
    }
    __syncthreads();
    if (active) {
      const float* w = wrm + (size_t)k0 * C + j;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        dm = fmaf(rows[sl][kk], tc::at_use<P>(*w), dm);
        w += C;
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const typename P::Store* gr = gifo_t + (size_t)s * C4;
  const float g = tc::to_f32(gr[j]);
  const float i = tc::to_f32(gr[C + j]);
  const float f = tc::to_f32(gr[2 * (size_t)C + j]);
  const float o = tc::to_f32(gr[3 * (size_t)C + j]);
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
  const float dgate[4] = {dg, di, df, d_o};
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t at = (size_t)s * C4 + (size_t)q * C + j;
    dgifo_t[at] = dgate[q];
    if (dxw_t != nullptr) {
      dxw_t[at] = dgate[q] * ((float)mask_t[at] * inv_keep);
    }
  }
  ho_t[idx] = h * o;
  dc[idx] = dc_total * f + di * peep[j] + df * peep[C + j];
}

// out[i] = sum_p part[p][i] for p = 0, 1, ... in order, one segment per
// blockIdx.y; a segment with count 0 is skipped.
struct Seg {
  const float* part;
  float* out;
  int parts;
  int count;
};
constexpr int kSegs = 5;
struct Segs {
  Seg s[kSegs];
};

__global__ void reduce_parts_kernel(Segs segs) {
  const Seg sg = segs.s[blockIdx.y];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < sg.count;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int p = 0; p < sg.parts; ++p) v += sg.part[(size_t)p * sg.count + i];
    sg.out[i] = v;
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

// K1 (see lstmp_train_fwd_f32 below) under precision P.
template <class P>
int train_fwd(const float* x, const float* w_gifo_x, const float* w_gifo_r,
              const float* bias, const float* peep, const float* w_r_m,
              const float* c0, const float* r0, const int8_t* mask,
              float inv_keep, typename P::Store* gifo, float* c_out,
              float* r_out, float* xw, float* wr_perm, float* m, int T,
              int S, int I, int C, int R, float cell_clip, int gate_bm,
              void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 ||
      (gate_bm != 32 && gate_bm != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto gates =
      gate_bm == 64 ? k1::launch_gates<64, P> : k1::launch_gates<32, P>;
  // r_t [S, R] = m [S, C] w_r_m^T: both operands K-major, 32 x 32 tiles
  // (128 CTAs at S=256, R=512; 64 x 64 measured slower wherever tried)
  auto proj = contract<P, true, true, 32, 32>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Cp = (C + kGateCells - 1) / kGateCells * kGateCells;
  const int C4 = 4 * C;
  const size_t perm = (size_t)4 * Cp * R;
  const int blocks = static_cast<int>(
      std::min<size_t>((perm + 255) / 256, 1024));
  k1::interleave_gate_rows_kernel<<<blocks, 256, 0, st>>>(w_gifo_r, wr_perm,
                                                          C, Cp, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const XwArgs xa{x, w_gifo_x, bias, mask, inv_keep, xw, T * S, I, C4};
  err = k1::launch_xw<P>(st, xa);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t g_step = (size_t)S * C4;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  for (int t = 0; t < T; ++t) {
    const GateArgs<P> ga{t == 0 ? r0 : r_out + (t - 1) * r_step, wr_perm,
                         xw + t * g_step,
                         t == 0 ? c0 : c_out + (t - 1) * c_step, peep,
                         gifo + t * g_step, c_out + t * c_step, m, S, R, C,
                         Cp, cell_clip};
    err = gates(st, ga);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = proj(st, m, C, w_r_m, C, r_out + t * r_step, S, R, C, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 (see lstmp_train_bwd_f32 below) under precision P.
template <class P>
int train_bwd(const float* x, const float* w_gifo_x, const float* w_gifo_r,
              const float* w_r_m, const float* peep, const float* c0,
              const float* r0, const typename P::Store* gifo,
              const float* c_seq, const float* r_seq, const int8_t* mask,
              float inv_keep, const float* g_r, float* dc, float* dr,
              float* dgifo, float* drt, float* ho, float* dxw,
              float* r_prev, float* drp, float* part_wx, float* part_wr,
              float* part_wrm, float* part_dx, float* dx, float* dwx,
              float* dwr, float* dwrm, float* dbias, float* dpeep, int T,
              int S, int I, int C, int R, int sp_dr, int sp_wx, int sp_wr,
              int sp_wrm, int sp_dx, void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 || sp_dr < 1 ||
      sp_wx < 1 || sp_wr < 1 || sp_wrm < 1 || sp_dx < 1 ||
      (mask != nullptr) != (dxw != nullptr) ||
      (sp_wx > 1 && part_wx == nullptr) ||
      (sp_wr > 1 && part_wr == nullptr) ||
      (sp_wrm > 1 && part_wrm == nullptr) ||
      (dx != nullptr && sp_dx > 1 && part_dx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kCells, kStreams);
  const int sblocks = (S + kStreams - 1) / kStreams;
  const dim3 grid_cell((C + kCells - 1) / kCells, sblocks);
  const size_t C4 = 4 * (size_t)C;
  const size_t g_step = (size_t)S * C4;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  cudaError_t err;
  for (int t = T - 1; t >= 0; --t) {
    const float* c_prev = (t == 0) ? c0 : c_seq + (t - 1) * c_step;
    bwd_cell_kernel<P><<<grid_cell, block, 0, st>>>(
        g_r + t * r_step, drp, t == T - 1 ? 0 : sp_dr, w_r_m,
        gifo + t * g_step, c_seq + t * c_step, c_prev, peep,
        mask ? mask + t * g_step : nullptr, inv_keep, dc, dgifo + t * g_step,
        drt + t * r_step, ho + t * c_step, dxw ? dxw + t * g_step : nullptr,
        S, R, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dr [S, R] = dgifo[t] [S, 4C] Wr [4C, R], split over 4C
    err = contract<P, true, false>(st, dgifo + t * g_step, 4 * C, w_gifo_r,
                                   R, drp, S, R, 4 * C, sp_dr);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int N = T * S;
  const float* dxw_or_dgifo = dxw ? dxw : dgifo;   // dropout: dx, dWx only
  err = cudaMemcpyAsync(r_prev, r0, r_step * sizeof(float),
                        cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess && T > 1) {
    err = cudaMemcpyAsync(r_prev + r_step, r_seq,
                          (T - 1) * r_step * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWx [4C, I] = dxw^T x
  err = contract<P, false, false>(st, dxw_or_dgifo, 4 * C, x, I,
                                  sp_wx > 1 ? part_wx : dwx, 4 * C, I, N,
                                  sp_wx);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWr [4C, R] = dgifo^T r_prev
  err = contract<P, false, false>(st, dgifo, 4 * C, r_prev, R,
                                  sp_wr > 1 ? part_wr : dwr, 4 * C, R, N,
                                  sp_wr);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWrm [R, C] = dr_total^T (h o)
  err = contract<P, false, false>(st, drt, R, ho, C,
                                  sp_wrm > 1 ? part_wrm : dwrm, R, C, N,
                                  sp_wrm);
  if (err != cudaSuccess) return static_cast<int>(err);
  col_reduce_kernel<<<(7 * C + kRedCols - 1) / kRedCols,
                      kRedCols * kRedRows, 0, st>>>(dgifo, c_seq, c0, dbias,
                                                    dpeep, N, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dx != nullptr) {
    // dx [N, I] = dxw Wx
    err = contract<P, true, false>(st, dxw_or_dgifo, 4 * C, w_gifo_x, I,
                                   sp_dx > 1 ? part_dx : dx, N, I, 4 * C,
                                   sp_dx);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the partials of every split product, and dr0 from the last step's
  auto seg = [](const float* part, float* out, int parts, size_t count) {
    return Seg{part, out, parts, parts > 1 ? static_cast<int>(count) : 0};
  };
  Segs segs{{seg(drp, dr, sp_dr, r_step), seg(part_wx, dwx, sp_wx, C4 * I),
             seg(part_wr, dwr, sp_wr, C4 * R),
             seg(part_wrm, dwrm, sp_wrm, (size_t)R * C),
             seg(part_dx, dx, dx ? sp_dx : 1, (size_t)N * I)}};
  segs.s[0].count = static_cast<int>(r_step);
  int most = 0;
  for (const Seg& sg : segs.s) most = std::max(most, sg.count);
  const int blocks = std::min((most + 255) / 256, 1024);
  reduce_parts_kernel<<<dim3(blocks, kSegs), 256, 0, st>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. Runs the T-step forward on `stream`, 2T + 2 launches, no
// synchronisation, no allocation: the gate interleave, the hoisted input
// projection, then per step the gates and the projection. x [T, S, I]
// time-major; the weights in Kaldi orientation (w_gifo_x [4C, I],
// w_gifo_r [4C, R], w_r_m [R, C]); bias [4C]; peep [3, C] (i, f, o);
// mask [T, S, 4C] int8 or null. Out: gifo [T, S, 4C] (g, i, f, o
// activations), c_out [T, S, C], r_out [T, S, R]. Scratch: xw [T, S, 4C],
// wr_perm [4 Cp, R] with Cp = C rounded up to a multiple of 16, m [S, C].
// gate_bm (32 or 64) is the gate tile's rows (ops/lstm_train.py::
// fwd_plan); the projection takes 32 x 32 tiles. Returns a CUDA error
// code (0 on success).
extern "C" int lstmp_train_fwd_f32(const float* x, const float* w_gifo_x,
                                   const float* w_gifo_r, const float* bias,
                                   const float* peep, const float* w_r_m,
                                   const float* c0, const float* r0,
                                   const int8_t* mask, float inv_keep,
                                   float* gifo, float* c_out, float* r_out,
                                   float* xw, float* wr_perm, float* m,
                                   int T, int S, int I, int C, int R,
                                   float cell_clip, int gate_bm,
                                   void* stream) {
  return train_fwd<tc::F32>(x, w_gifo_x, w_gifo_r, bias, peep, w_r_m, c0,
                            r0, mask, inv_keep, gifo, c_out, r_out, xw,
                            wr_perm, m, T, S, I, C, R, cell_clip, gate_bm,
                            stream);
}

// K1 in bf16 (the --bf16 path): the arguments of lstmp_train_fwd_f32, with
// gifo [T, S, 4C] in bfloat16; every product rounds its operands to bf16
// (tc_gemm.cuh's bf16 mode), c_out and r_out stay f32.
extern "C" int lstmp_train_fwd_bf16(const float* x, const float* w_gifo_x,
                                    const float* w_gifo_r, const float* bias,
                                    const float* peep, const float* w_r_m,
                                    const float* c0, const float* r0,
                                    const int8_t* mask, float inv_keep,
                                    __nv_bfloat16* gifo, float* c_out,
                                    float* r_out, float* xw, float* wr_perm,
                                    float* m, int T, int S, int I, int C,
                                    int R, float cell_clip, int gate_bm,
                                    void* stream) {
  return train_fwd<tc::Bf16>(x, w_gifo_x, w_gifo_r, bias, peep, w_r_m, c0,
                             r0, mask, inv_keep, gifo, c_out, r_out, xw,
                             wr_perm, m, T, S, I, C, R, cell_clip, gate_bm,
                             stream);
}


// K2. Residuals as K1 wrote them (gifo, c_seq, r_seq [T, S, .]), the
// chunk's initial state c0 [S, C], r0 [S, R], x [T, S, I], the weights in
// Kaldi orientation (w_gifo_x [4C, I], w_gifo_r [4C, R], w_r_m [R, C]),
// peep [3, C], mask [T, S, 4C] int8 or null. g_r [T, S, R] is the
// cotangent of every r_t, the final r's already added at T-1.
// In/out: dc [S, C] holds the final c's cotangent on entry and dc0 on
// return. Out: dr [S, R] = dr0.
// Scratch: dgifo [T, S, 4C], drt [T, S, R], ho [T, S, C], dxw [T, S, 4C]
// (with a mask, else null), r_prev [T, S, R], drp [sp_dr, S, R], and the
// partials of each frame-axis product split in more than one (part_wx
// [sp_wx, 4C, I], part_wr [sp_wr, 4C, R], part_wrm [sp_wrm, R, C],
// part_dx [sp_dx, T S, I]; null where the split count is 1).
// Out: dx [T, S, I] (skipped when null), dwx [4C, I], dwr [4C, R],
// dwrm [R, C], dbias [4C], dpeep [3, C].
// 2T + 5 launches (+1 with dx). Returns a CUDA error code (0 on success).
extern "C" int lstmp_train_bwd_f32(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* w_r_m, const float* peep, const float* c0, const float* r0,
    const float* gifo, const float* c_seq, const float* r_seq,
    const int8_t* mask, float inv_keep, const float* g_r, float* dc,
    float* dr, float* dgifo, float* drt, float* ho, float* dxw,
    float* r_prev, float* drp, float* part_wx, float* part_wr,
    float* part_wrm, float* part_dx, float* dx, float* dwx, float* dwr,
    float* dwrm, float* dbias, float* dpeep, int T, int S, int I, int C,
    int R, int sp_dr, int sp_wx, int sp_wr, int sp_wrm, int sp_dx,
    void* stream) {
  return train_bwd<tc::F32>(
      x, w_gifo_x, w_gifo_r, w_r_m, peep, c0, r0, gifo, c_seq, r_seq, mask,
      inv_keep, g_r, dc, dr, dgifo, drt, ho, dxw, r_prev, drp, part_wx,
      part_wr, part_wrm, part_dx, dx, dwx, dwr, dwrm, dbias, dpeep, T, S, I,
      C, R, sp_dr, sp_wx, sp_wr, sp_wrm, sp_dx, stream);
}

// K2 in bf16 (the --bf16 path): the arguments of lstmp_train_bwd_f32, with
// gifo in bfloat16 as lstmp_train_fwd_bf16 wrote it; every product rounds
// its operands to bf16, the gradients come out f32.
extern "C" int lstmp_train_bwd_bf16(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* w_r_m, const float* peep, const float* c0, const float* r0,
    const __nv_bfloat16* gifo, const float* c_seq, const float* r_seq,
    const int8_t* mask, float inv_keep, const float* g_r, float* dc,
    float* dr, float* dgifo, float* drt, float* ho, float* dxw,
    float* r_prev, float* drp, float* part_wx, float* part_wr,
    float* part_wrm, float* part_dx, float* dx, float* dwx, float* dwr,
    float* dwrm, float* dbias, float* dpeep, int T, int S, int I, int C,
    int R, int sp_dr, int sp_wx, int sp_wr, int sp_wrm, int sp_dx,
    void* stream) {
  return train_bwd<tc::Bf16>(
      x, w_gifo_x, w_gifo_r, w_r_m, peep, c0, r0, gifo, c_seq, r_seq, mask,
      inv_keep, g_r, dc, dr, dgifo, drt, ho, dxw, r_prev, drp, part_wx,
      part_wr, part_wrm, part_dx, dx, dwx, dwr, dwrm, dbias, dpeep, T, S, I,
      C, R, sp_dr, sp_wx, sp_wr, sp_wrm, sp_dx, stream);
}
