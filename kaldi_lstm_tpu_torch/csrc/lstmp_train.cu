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
// bf16 (the _bf16 entry points; precision.cuh). K1 in bf16 is its own
// design, on tc_gemm.cuh's bf16 tiles (Gemm16: operands bf16 in device
// memory, staged and multiplied as bf16 in 64-deep stages, nothing
// rounded in a mainloop). It rounds x, Wx, r_{t-1}, Wr, m = tanh(c) o and
// Wrm where kaldi_lstm_tpu/ops/lstm_pallas.py casts them before its dots,
// each once, where it is made:
//   prologue:  one launch rounds the gate-interleaved Wr (the interleave
//              at the gate tile's width folded in), Wrm, Wx (every call:
//              the optimizer updates them in place), x and r0 into bf16
//              scratch, rows padded to a multiple of 8 elements;
//   xw:        the hoisted x Wx^T over N = T S rows, its epilogue applying
//              mask * inv_keep and the bias, written in f32 (the
//              reference adds an f32 xw): Gemm16 64 x 64 tiles staged
//              through shared memory for 16-byte stores (I=40), or
//              wg_gemm.cuh's wgmma ring (128 x 128 tiles fed by TMA, a
//              persistent grid; I=512), as the caller's plan picks;
//   per step:  gates: pre = r_{t-1} Wr_perm^T from r_b, on Gemm16 tiles
//              of 64 rows x 128 columns (32 cells, their four gates), the
//              cell math in the epilogue on the tile staged in shared
//              memory: gifo_t in bf16, c_t in f32 and m in bf16 only (the
//              projection is its only reader);
//              projection: r_t = m Wrm^T on 32 x 32 tiles over the whole
//              C (13 stages at C=800, an 8-deep ring), its epilogue
//              writing r_t in f32 (the residual and the output) and its
//              bf16 copy r_b, the next step's A operand.
// 2T + 2 launches, as in f32. A stage is 64 deep where the f32 ring's is
// 32, crosses L2 and shared memory in bf16 (half the bytes), and every
// operand is rounded once rather than at each of its loads (Wr_perm once
// a call, not once per row tile each step; r_{t-1} once a step, not once
// per column tile). Each stage's products start from a zero fragment and
// are added in f32 (tc_gemm.cuh's note on the tensor core's sums); the
// wgmma xw keeps its whole sum in the wgmma accumulators, as K3/K4 bf16
// do, and so takes the tensor core's cut against the running sum's
// exponent at every 16 of depth (phase 3e on an H100 80GB HBM3 at 700.00
// W: wgmma m64n128k16 sums as mma.sync does, block 16, 25 bits, toward
// zero). ops/tc_sum.py's tc_matmul models both routes. At the
// flagship shape its products' bound is 0.023 ms (22.3 GFLOP at 989
// TFLOP/s); a step is a serial chain of two launches whose copies,
// epilogues and launch latency, not their products, take its time
// (tools/bench_k1_parts.py times each kernel).
// K2 in bf16 is its own design, on tc_gemm.cuh's bf16 tiles (Gemm16:
// operands bf16 in device memory, staged and multiplied as bf16, nothing
// rounded in a mainloop). Each operand is rounded once, where it is made:
//   prologue:  one launch rounds Wr, Wrm, Wx (once a call: the optimizer
//              updates them in place), x, r_prev = [r0; r_seq[:T-1]] and
//              dr_total at the last step (g_r[T-1]) into bf16 scratch;
//   per step:  dm: dm = dr_total_t Wrm on the tensor cores (32 x 32
//              tiles), with bwd_cell's gate math as its epilogue, which
//              writes dgifo (f32, for dbias and the peephole sums), its
//              bf16 copy, dxw in bf16 (with a mask), h o in bf16 and dc;
//              dr: dr = dgifo_t Wr unsplit (32 x 32 tiles, an 8-deep
//              ring: 100 stages at the flagship shape), its epilogue
//              writing dr_total_{t-1} = g_r[t-1] + dr in bf16 (dr0 in f32
//              at t = 0). So dr is summed once a step, in one tile, and
//              the next step reads it as the dm product's bf16 A tile;
//   after:     dWx, dWr, dWrm and dx on bf16 tiles from those copies,
//              split as bwd_plan says; the column sums; the partials' sum.
// 2T + 6 launches (+1 with dx). The gate math, c, dc, dgifo, dbias and
// the peephole sums stay f32. What bounds it on an H100: at the flagship
// shape its products are 43.3 GFLOP, 0.044 ms at 989 TFLOP/s; a step's
// serial chain of two launches (the dr tile walks 3200 deep through L2:
// 410 KB a CTA) and the frame-axis products' mma.sync rate bound it.
// There is no float atomic: every sum runs in a fixed order.
//
// K1's f32 tiles (the interleave, the hoisted xw, the gates tile with its
// cell epilogue) and the contraction tile live in csrc/lstmp_tc.cuh,
// shared with K6's two-layer wavefront (csrc/lstmp_stack.cu); K1's bf16
// kernels (fwd16_*) are below, after K2's, on csrc/lstmp_tc16.cuh's bf16
// tiles, which K6 in bf16 shares.
//
// Built with nvcc into a shared library with a plain C entry point per
// kernel, loaded by kaldi_lstm_tpu_torch/ops/lstm_train.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lstmp_tc.cuh"
#include "lstmp_tc16.cuh"
#include "wg_gemm.cuh"

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
// dgifo_t * mask_t * inv_keep. (The f32 entry point's; the bf16 one runs
// dm on the tensor cores, bwd16_dm_kernel below.)
__global__ void bwd_cell_kernel(const float* __restrict__ g_r_t,
                                const float* __restrict__ drp, int ndrp,
                                const float* __restrict__ wrm,
                                const float* __restrict__ gifo_t,
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
constexpr int kSegs = 7;
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
// partial sums are added in a fixed order: reproducible. Grid row y sums
// the rows [y rows, (y+1) rows) into dbias [y][4C] and dpeep [y][3C]: one
// range (rows = N) gives the sums themselves; the bf16 K2 splits the rows
// so that enough are in flight to stream dgifo at the memory's rate, and
// the partials' sum adds the ranges in order.
__global__ void col_reduce_kernel(const float* __restrict__ dgifo,
                                  const float* __restrict__ c_seq,
                                  const float* __restrict__ c0,
                                  float* __restrict__ dbias,
                                  float* __restrict__ dpeep,
                                  int N, int S, int C, int rows) {
  __shared__ float part[kRedRows][kRedCols];
  const int cl = threadIdx.x % kRedCols;
  const int rg = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + cl;
  const size_t C4 = 4 * (size_t)C;
  const int n0 = blockIdx.y * rows, n1 = min(N, n0 + rows);
  float acc = 0.f;
  if (col < 7 * C) {
    if (col < (int)C4) {
      for (int n = n0 + rg; n < n1; n += kRedRows) {
        acc += dgifo[(size_t)n * C4 + col];
      }
    } else {
      const int q = col - (int)C4;
      const int w = q / C;
      const int j = q % C;
      const float* gcol = dgifo + (size_t)(w + 1) * C + j;
      for (int n = n0 + rg; n < n1; n += kRedRows) {
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
    dbias[(size_t)blockIdx.y * C4 + col] = sum;
  } else {
    dpeep[(size_t)blockIdx.y * 3 * C + col - (int)C4] = sum;
  }
}

// K1 (see lstmp_train_fwd_f32 below) under precision P.
template <class P>
int train_fwd(const float* x, const float* w_gifo_x, const float* w_gifo_r,
              const float* bias, const float* peep, const float* w_r_m,
              const float* c0, const float* r0, const int8_t* mask,
              float inv_keep, float* gifo, float* c_out,
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

// K2 in f32 (see lstmp_train_bwd_f32 below).
int train_bwd_f32(const float* x, const float* w_gifo_x, const float* w_gifo_r,
                  const float* w_r_m, const float* peep, const float* c0,
                  const float* r0, const float* gifo,
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
    bwd_cell_kernel<<<grid_cell, block, 0, st>>>(
        g_r + t * r_step, drp, t == T - 1 ? 0 : sp_dr, w_r_m,
        gifo + t * g_step, c_seq + t * c_step, c_prev, peep,
        mask ? mask + t * g_step : nullptr, inv_keep, dc, dgifo + t * g_step,
        drt + t * r_step, ho + t * c_step, dxw ? dxw + t * g_step : nullptr,
        S, R, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dr [S, R] = dgifo[t] [S, 4C] Wr [4C, R], split over 4C
    err = contract<tc::F32, true, false>(st, dgifo + t * g_step, 4 * C,
                                         w_gifo_r, R, drp, S, R, 4 * C,
                                         sp_dr);
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
  err = contract<tc::F32, false, false>(st, dxw_or_dgifo, 4 * C, x, I,
                                        sp_wx > 1 ? part_wx : dwx, 4 * C, I,
                                        N, sp_wx);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWr [4C, R] = dgifo^T r_prev
  err = contract<tc::F32, false, false>(st, dgifo, 4 * C, r_prev, R,
                                        sp_wr > 1 ? part_wr : dwr, 4 * C, R,
                                        N, sp_wr);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWrm [R, C] = dr_total^T (h o)
  err = contract<tc::F32, false, false>(st, drt, R, ho, C,
                                        sp_wrm > 1 ? part_wrm : dwrm, R, C, N,
                                        sp_wrm);
  if (err != cudaSuccess) return static_cast<int>(err);
  col_reduce_kernel<<<(7 * C + kRedCols - 1) / kRedCols,
                      kRedCols * kRedRows, 0, st>>>(dgifo, c_seq, c0, dbias,
                                                    dpeep, N, S, C, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dx != nullptr) {
    // dx [N, I] = dxw Wx
    err = contract<tc::F32, true, false>(st, dxw_or_dgifo, 4 * C, w_gifo_x,
                                         I, sp_dx > 1 ? part_dx : dx, N, I,
                                         4 * C, sp_dx);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the partials of every split product, and dr0 from the last step's
  auto seg = [](const float* part, float* out, int parts, size_t count) {
    return Seg{part, out, parts, parts > 1 ? static_cast<int>(count) : 0};
  };
  Segs segs{{seg(drp, dr, sp_dr, r_step), seg(part_wx, dwx, sp_wx, C4 * I),
             seg(part_wr, dwr, sp_wr, C4 * R),
             seg(part_wrm, dwrm, sp_wrm, (size_t)R * C),
             seg(part_dx, dx, dx ? sp_dx : 1, (size_t)N * I),
             seg(nullptr, nullptr, 1, 0), seg(nullptr, nullptr, 1, 0)}};
  segs.s[0].count = static_cast<int>(r_step);
  int most = 0;
  for (const Seg& sg : segs.s) most = std::max(most, sg.count);
  const int blocks = std::min((most + 255) / 256, 1024);
  reduce_parts_kernel<<<dim3(blocks, kSegs), 256, 0, st>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2 in bf16: every product on tc_gemm.cuh's bf16 tiles (Gemm16)
// ---------------------------------------------------------------------------

using k16::bf16;
using k16::ld8;

// One conversion of the call's prologue: rows x cols f32 (row stride sld)
// rounded to bf16 (row stride dld); rows 0 skips it.
struct Cvt {
  const float* src;
  bf16* dst;
  int rows, cols, sld, dld;
};
constexpr int kCvts = 7;
struct Cvts {
  Cvt c[kCvts];
};

// The bf16 copies that nothing in the call produces: the weights (once a
// call: the optimizer updates them in place between calls), x and r_prev
// for the frame-axis products, and dr_total at the last step (g_r[T-1]:
// nothing flows in from a later step). One conversion per blockIdx.y.
__global__ void bwd16_prep_kernel(Cvts cv) {
  const Cvt c = cv.c[blockIdx.y];
  const size_t n = (size_t)c.rows * c.cols;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t r = e / c.cols;
    const int k = static_cast<int>(e % c.cols);
    c.dst[r * c.dld + k] = __float2bfloat16_rn(c.src[r * c.sld + k]);
  }
}

// dm = dr_total_t Wrm, [S, C] over R: A = drt_b[t] [S, R8] K-major, B =
// wrm_b [R][C8] along n. 32 x 32 tiles of four 16 x 16 warp tiles. A
// CTA's copies wait on L2's latency, so the ring keeps 7 stages (28 KB)
// in flight.
using DmGemm = tc::Gemm16<32, 32, 2, 2, true, false, 8>;
// dr = dgifo_t Wr, [S, R] over 4C, unsplit: A = dgifo_b[t] [S, G8]
// K-major, B = wr_b [4C][R8] along n; 100 stages at the flagship shape
// (410 KB a CTA). Timed against this on an H100 and not faster: 64 x 64
// tiles (32 CTAs, half the L2 bytes; slower), a 16-deep ring, 64-deep
// stages of independent 16-deep slices.
using DrGemm = tc::Gemm16<32, 32, 2, 2, true, false, 8>;
// the frame-axis products, split over T S as bwd_plan says
template <bool AK>
using FrameGemm = tc::Gemm16<64, 64, 2, 2, AK, false, 4>;

struct DmArgs {
  const bf16* drt_t;    // [S, R8] dr_total rounded
  const bf16* wrm;      // [R, C8]
  const bf16* gifo_t;   // [S, 4C] gate activations (K1 wrote them in bf16)
  const float* c_t;     // [S, C]
  const float* c_prev;  // [S, C]
  const float* peep;    // [3, C]
  const int8_t* mask_t; // [S, 4C] or null
  float inv_keep;
  float* dc;            // [S, C] in: into c_t, out: into c_{t-1}
  float* dgifo_t;       // [S, 4C] f32 (dbias, the peephole sums)
  bf16* dgifo_b_t;      // [S, G8] (dr, dWr; dWx and dx without a mask)
  bf16* dxw_b_t;        // [S, G8] dgifo * mask * inv_keep, or null
  bf16* ho_b_t;         // [S, C8] h o = tanh(c_t) o (dWrm)
  int S, R, C, G8, C8, R8;
};

// One step's dm tile with the gate gradients as its epilogue (bwd_cell's
// math, element by element of the dm tile: each thread's 8 elements are
// (stream, cell) pairs). Their residuals are loaded before the mainloop,
// so that their latency hides behind it.
__global__ void __launch_bounds__(DmGemm::kThreads)
bwd16_dm_kernel(DmArgs a) {
  using G = DmGemm;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm0 = G::warp_m0(), wn0 = G::warp_n0();
  const size_t C4 = 4 * (size_t)a.C;
  static_assert(G::kMT == 1, "one m16 tile a warp");
  constexpr int kE = 2 * G::kNT * 2;   // elements a thread: h, j, e
  float gv[kE][4], cv[kE], cpv[kE], dcv[kE];
  #pragma unroll
  for (int q = 0; q < kE; ++q) {
    const int h = q / (2 * G::kNT), j = (q / 2) % G::kNT, e = q % 2;
    const int s = m0 + wm0 + g8 + 8 * h;
    const int c = n0 + wn0 + 8 * j + 2 * t4 + e;
    const bool ok = s < a.S && c < a.C;
    const size_t idx = (size_t)s * a.C + c;
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
      gv[q][k] = ok ? __bfloat162float(a.gifo_t[(size_t)s * C4 +
                                                (size_t)k * a.C + c])
                    : 0.f;
    }
    cv[q] = ok ? a.c_t[idx] : 0.f;
    cpv[q] = ok ? a.c_prev[idx] : 0.f;
    dcv[q] = ok ? a.dc[idx] : 0.f;
  }
  const tc::Operand16 A{a.drt_t, a.R8, a.S, a.R};
  const tc::Operand16 B{a.wrm, a.C8, a.C, a.R};
  // the thread's two neighbouring cells (e = 0, 1) go out as one 8-byte
  // (f32) or 4-byte (bf16) store where C is even, so both are aligned
  const bool pairs = a.C % 2 == 0;
  G::run(smem, A, B, m0, n0, [&](typename G::Acc& acc) {
    #pragma unroll
    for (int q0 = 0; q0 < kE; q0 += 2) {
      const int h = q0 / (2 * G::kNT), j = (q0 / 2) % G::kNT;
      const int s = m0 + wm0 + g8 + 8 * h;
      const int c0 = n0 + wn0 + 8 * j + 2 * t4;
      if (s >= a.S || c0 >= a.C) continue;
      float dg4[2][4], ho[2], dcn[2];
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + e, c = min(c0 + e, a.C - 1);
        const float dm = acc[0][j][2 * h + e];
        const float g = gv[q][0], i = gv[q][1], f = gv[q][2], o = gv[q][3];
        const float h_ = tanhf(cv[q]);
        const float dh = dm * o;
        const float dc_from_h = dh * (1.0f - h_ * h_);
        const float d_o = dm * h_ * o * (1.0f - o);
        // straight-through clip: dc flows through the forward clip
        const float dc_total = dcv[q] + dc_from_h + d_o * a.peep[2 * a.C + c];
        const float df = dc_total * cpv[q] * f * (1.0f - f);
        const float di = dc_total * g * i * (1.0f - i);
        dg4[e][0] = dc_total * i * (1.0f - g * g);
        dg4[e][1] = di;
        dg4[e][2] = df;
        dg4[e][3] = d_o;
        ho[e] = h_ * o;
        dcn[e] = dc_total * f + di * a.peep[c] + df * a.peep[a.C + c];
      }
      const size_t cs = (size_t)s * a.C + c0;
      if (pairs) {
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t col = (size_t)k * a.C + c0;
          *reinterpret_cast<float2*>(a.dgifo_t + (size_t)s * C4 + col) =
              make_float2(dg4[0][k], dg4[1][k]);
          *reinterpret_cast<__nv_bfloat162*>(a.dgifo_b_t +
                                             (size_t)s * a.G8 + col) =
              __floats2bfloat162_rn(dg4[0][k], dg4[1][k]);
          if (a.dxw_b_t != nullptr) {
            const int8_t* mk = a.mask_t + (size_t)s * C4 + col;
            *reinterpret_cast<__nv_bfloat162*>(a.dxw_b_t +
                                               (size_t)s * a.G8 + col) =
                __floats2bfloat162_rn(
                    dg4[0][k] * ((float)mk[0] * a.inv_keep),
                    dg4[1][k] * ((float)mk[1] * a.inv_keep));
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(a.ho_b_t + (size_t)s * a.C8 +
                                           c0) =
            __floats2bfloat162_rn(ho[0], ho[1]);
        *reinterpret_cast<float2*>(a.dc + cs) = make_float2(dcn[0], dcn[1]);
        continue;
      }
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c0 + e >= a.C) continue;
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t col = (size_t)k * a.C + c0 + e;
          a.dgifo_t[(size_t)s * C4 + col] = dg4[e][k];
          a.dgifo_b_t[(size_t)s * a.G8 + col] = __float2bfloat16_rn(dg4[e][k]);
          if (a.dxw_b_t != nullptr) {
            a.dxw_b_t[(size_t)s * a.G8 + col] = __float2bfloat16_rn(
                dg4[e][k] * ((float)a.mask_t[(size_t)s * C4 + col] *
                             a.inv_keep));
          }
        }
        a.ho_b_t[(size_t)s * a.C8 + c0 + e] = __float2bfloat16_rn(ho[e]);
        a.dc[cs + e] = dcn[e];
      }
    }
  });
}

struct DrArgs {
  const bf16* dgifo_b_t;  // [S, G8]
  const bf16* wr;         // [4C, R8]
  const float* g_r;       // [S, R] g_r[t-1], or null at t = 0
  bf16* drt_b;            // [S, R8] dr_total_{t-1} rounded, or null
  float* dr0;             // [S, R] at t = 0 (the chunk's dr0), else null
  int S, R, C4, G8, R8;
};

// One step's dr, unsplit, with dr_total_{t-1} = g_r[t-1] + dr as its
// epilogue (rounded: the next step's dm reads it, and dWrm), so dr is
// summed once a step and read by nothing else; at t = 0 it is dr0.
__global__ void __launch_bounds__(DrGemm::kThreads)
bwd16_dr_kernel(DrArgs a) {
  using G = DrGemm;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const tc::Operand16 A{a.dgifo_b_t, a.G8, a.S, a.C4};
  const tc::Operand16 B{a.wr, a.R8, a.R, a.C4};
  G::run(smem, A, B, m0, n0, [&](typename G::Acc& acc) {
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
          if (a.dr0 != nullptr) {
            a.dr0[(size_t)s * a.R + r] = v;
          } else {
            a.drt_b[(size_t)s * a.R8 + r] =
                __float2bfloat16_rn(a.g_r[(size_t)s * a.R + r] + v);
          }
        }
      }
    }
  });
}

// out[p][m][n] = sum over k in split p of A(m, k) B(n, k) on bf16 tiles
// (Contract's meaning; `a` and `b` are bf16, B along n).
struct Contract16 {
  const bf16* a;
  int lda;
  const bf16* b;
  int ldb;
  float* out;
  int M, N, K, kchunk;
};

template <bool AK>
__global__ void __launch_bounds__(FrameGemm<AK>::kThreads)
contract16_kernel(Contract16 c) {
  using G = FrameGemm<AK>;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const int k0 = blockIdx.z * c.kchunk;
  const int kext = min(c.kchunk, c.K - k0);
  float* out = c.out + (size_t)blockIdx.z * c.M * c.N;
  if (kext <= 0) {
    typename G::Acc acc;
    tc::zero(acc);
    k1::store_tile<G>(out, c.M, c.N, m0, n0, acc);
    return;
  }
  const tc::Operand16 A{AK ? c.a + k0 : c.a + (size_t)k0 * c.lda, c.lda, c.M,
                        kext};
  const tc::Operand16 B{c.b + (size_t)k0 * c.ldb, c.ldb, c.N, kext};
  G::run(smem, A, B, m0, n0, [&](typename G::Acc& acc) {
    k1::store_tile<G>(out, c.M, c.N, m0, n0, acc);
  });
}

template <bool AK>
cudaError_t contract16(cudaStream_t st, const bf16* a, int lda,
                       const bf16* b, int ldb, float* out, int M, int N,
                       int K, int splits) {
  using G = FrameGemm<AK>;
  splits = std::max(1, splits);
  const int ksteps = (K + tc::kBK - 1) / tc::kBK;
  const int per = (ksteps + splits - 1) / splits;
  const Contract16 c{a, lda, b, ldb, out, M, N, K, per * tc::kBK};
  auto kernel = contract16_kernel<AK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + G::kBM - 1) / G::kBM, (N + G::kBN - 1) / G::kBN,
                  splits);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(c);
  return cudaGetLastError();
}

using k16::launch_tile;

// K2 in bf16 (see lstmp_train_bwd_bf16 below).
int train_bwd_bf16(const float* x, const float* w_gifo_x,
                   const float* w_gifo_r, const float* w_r_m,
                   const float* peep, const float* c0, const float* r0,
                   const bf16* gifo, const float* c_seq, const float* r_seq,
                   const int8_t* mask, float inv_keep, const float* g_r,
                   float* dc, float* dr, float* dgifo, bf16* dgifo_b,
                   bf16* dxw_b, bf16* drt_b, bf16* ho_b, bf16* x_b,
                   bf16* rprev_b, bf16* wr_b, bf16* wrm_b, bf16* wx_b,
                   float* part_wx, float* part_wr, float* part_wrm,
                   float* part_dx, float* part_cols, float* dx, float* dwx,
                   float* dwr, float* dwrm, float* dbias, float* dpeep,
                   int T, int S, int I, int C, int R, int sp_wx, int sp_wr,
                   int sp_wrm, int sp_dx, int sp_cols, void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 || sp_wx < 1 ||
      sp_wr < 1 || sp_wrm < 1 || sp_dx < 1 || sp_cols < 1 ||
      (sp_cols > 1 && part_cols == nullptr) ||
      (mask != nullptr) != (dxw_b != nullptr) ||
      (sp_wx > 1 && part_wx == nullptr) ||
      (sp_wr > 1 && part_wr == nullptr) ||
      (sp_wrm > 1 && part_wrm == nullptr) ||
      (dx != nullptr && sp_dx > 1 && part_dx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C4 = 4 * C, G8 = ld8(C4), C8 = ld8(C), R8 = ld8(R), I8 = ld8(I);
  const int N = T * S;
  const size_t g_step = (size_t)S * C4, c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  const Cvts cv{{{w_gifo_r, wr_b, C4, R, R, R8},
                 {w_r_m, wrm_b, R, C, C, C8},
                 {w_gifo_x, wx_b, C4, I, I, I8},
                 {x, x_b, N, I, I, I8},
                 {r0, rprev_b, S, R, R, R8},
                 {r_seq, rprev_b + (size_t)S * R8, (T - 1) * S, R, R, R8},
                 {g_r + (T - 1) * r_step, drt_b + (size_t)(T - 1) * S * R8,
                  S, R, R, R8}}};
  size_t most = 0;
  for (const Cvt& c : cv.c) most = std::max(most, (size_t)c.rows * c.cols);
  const int pblocks = static_cast<int>(
      std::min<size_t>((most + 255) / 256, 1024));
  bwd16_prep_kernel<<<dim3(pblocks, kCvts), 256, 0, st>>>(cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 dm_grid((S + DmGemm::kBM - 1) / DmGemm::kBM,
                     (C + DmGemm::kBN - 1) / DmGemm::kBN);
  const dim3 dr_grid((S + DrGemm::kBM - 1) / DrGemm::kBM,
                     (R + DrGemm::kBN - 1) / DrGemm::kBN);
  for (int t = T - 1; t >= 0; --t) {
    const size_t gb = (size_t)t * S * G8;
    const DmArgs da{drt_b + (size_t)t * S * R8, wrm_b, gifo + t * g_step,
                    c_seq + t * c_step,
                    t == 0 ? c0 : c_seq + (t - 1) * c_step, peep,
                    mask ? mask + t * g_step : nullptr, inv_keep, dc,
                    dgifo + t * g_step, dgifo_b + gb,
                    dxw_b ? dxw_b + gb : nullptr,
                    ho_b + (size_t)t * S * C8, S, R, C, G8, C8, R8};
    err = launch_tile<DmGemm>(st, bwd16_dm_kernel, dm_grid, da);
    if (err != cudaSuccess) return static_cast<int>(err);
    const DrArgs ra{dgifo_b + gb, wr_b,
                    t == 0 ? nullptr : g_r + (t - 1) * r_step,
                    t == 0 ? nullptr : drt_b + (size_t)(t - 1) * S * R8,
                    t == 0 ? dr : nullptr, S, R, C4, G8, R8};
    err = launch_tile<DrGemm>(st, bwd16_dr_kernel, dr_grid, ra);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const bf16* dxw_or_dgifo = dxw_b ? dxw_b : dgifo_b;
  // dWx [4C, I] = dxw^T x
  err = contract16<false>(st, dxw_or_dgifo, G8, x_b, I8,
                          sp_wx > 1 ? part_wx : dwx, C4, I, N, sp_wx);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWr [4C, R] = dgifo^T r_prev
  err = contract16<false>(st, dgifo_b, G8, rprev_b, R8,
                          sp_wr > 1 ? part_wr : dwr, C4, R, N, sp_wr);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWrm [R, C] = dr_total^T (h o)
  err = contract16<false>(st, drt_b, R8, ho_b, C8,
                          sp_wrm > 1 ? part_wrm : dwrm, R, C, N, sp_wrm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the column sums over sp_cols row ranges (into dbias, dpeep directly
  // when there is one)
  const int rows = (N + sp_cols - 1) / sp_cols;
  float* pb = sp_cols > 1 ? part_cols : dbias;
  float* pp = sp_cols > 1 ? part_cols + (size_t)sp_cols * C4 : dpeep;
  col_reduce_kernel<<<dim3((7 * C + kRedCols - 1) / kRedCols, sp_cols),
                      kRedCols * kRedRows, 0, st>>>(
      dgifo, c_seq, c0, pb, pp, N, S, C, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dx != nullptr) {
    // dx [N, I] = dxw Wx
    err = contract16<true>(st, dxw_or_dgifo, G8, wx_b, I8,
                           sp_dx > 1 ? part_dx : dx, N, I, C4, sp_dx);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto seg = [](const float* part, float* out, int parts, size_t count) {
    return Seg{part, out, parts, parts > 1 ? static_cast<int>(count) : 0};
  };
  Segs segs{{seg(nullptr, dr, 1, 0), seg(part_wx, dwx, sp_wx, (size_t)C4 * I),
             seg(part_wr, dwr, sp_wr, (size_t)C4 * R),
             seg(part_wrm, dwrm, sp_wrm, (size_t)R * C),
             seg(part_dx, dx, dx ? sp_dx : 1, (size_t)N * I),
             seg(pb, dbias, sp_cols, (size_t)C4),
             seg(pp, dpeep, sp_cols, (size_t)3 * C)}};
  int most_seg = 0;
  for (const Seg& sg : segs.s) most_seg = std::max(most_seg, sg.count);
  const int blocks = std::max(1, std::min((most_seg + 255) / 256, 1024));
  reduce_parts_kernel<<<dim3(blocks, kSegs), 256, 0, st>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1 in bf16: its own design on tc_gemm.cuh's bf16 tiles (Gemm16, 64-deep
// stages) and, for the hoisted xw, optionally wg_gemm.cuh's wgmma ring; the
// tiles are csrc/lstmp_tc16.cuh's, shared with K6 in bf16
// ---------------------------------------------------------------------------

constexpr int kFwdCvts = 5;
using FwdCvts = k16::FwdCvts<kFwdCvts>;
using k16::GateGemm16;
using k16::ProjGemm16;
using k16::XwGemm16;

// K1 bf16, launch 1: the copies that nothing in the call produces, each
// rounded once (the weights on every call: the optimizer updates them in
// place), one conversion per blockIdx.y.
__global__ void fwd16_prep_kernel(FwdCvts cv) {
  k16::round_rows(cv.c[blockIdx.y]);
}

// K1 bf16, launch 2 (mma route): 64 x 64 tiles of Gemm16.
__global__ void __launch_bounds__(XwGemm16::kThreads)
fwd16_xw_kernel(k16::Xw16Args a) {
  extern __shared__ float4 smem4[];
  k16::xw_tile(a, blockIdx.x, blockIdx.y, smem4);
}

// K1 bf16, launch 2 (wgmma route): 128 x 128 tiles fed by TMA, a
// persistent grid.
__global__ void __launch_bounds__(wg::kThreads, 1)
fwd16_xw_wg_kernel(const __grid_constant__ CUtensorMap mx,
                   const __grid_constant__ CUtensorMap mw, k16::Xw16Args a) {
  extern __shared__ float4 smem4[];
  k16::xw_wg(&mx, &mw, a, smem4);
}

// One step's gates: 64 x 128 tiles (32 cells), gifo_t in bf16, c_t in f32,
// m in bf16.
__global__ void __launch_bounds__(GateGemm16::kThreads)
fwd16_gates_kernel(k16::Gate16Args a) {
  extern __shared__ float4 smem4[];
  k16::gates_tile(a, blockIdx.x, blockIdx.y, smem4);
}

// One step's projection: 32 x 32 tiles, r_t in f32 and its bf16 copy.
__global__ void __launch_bounds__(ProjGemm16::kThreads)
fwd16_proj_kernel(k16::Proj16Args a) {
  extern __shared__ float4 smem4[];
  k16::proj_tile(a, blockIdx.x, blockIdx.y, smem4);
}

// K1 in bf16 (see lstmp_train_fwd_bf16 below).
int train_fwd_bf16(const float* x, const float* w_gifo_x,
                   const float* w_gifo_r, const float* bias,
                   const float* peep, const float* w_r_m, const float* c0,
                   const float* r0, const int8_t* mask, float inv_keep,
                   bf16* gifo, float* c_out, float* r_out, float* xw,
                   bf16* wr_b, bf16* wrm_b, bf16* wx_b, bf16* x_b, bf16* r_b,
                   bf16* m_b, int T, int S, int I, int C, int R,
                   float cell_clip, int xw_wg, int sms, void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 ||
      (xw_wg != 0 && xw_wg != 1) || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* copies[] = {wr_b, wrm_b, wx_b, x_b, r_b, m_b};
  for (const void* p : copies) {
    if (!k1::aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using GG = GateGemm16;
  const int cells = GG::kBN / 4;
  const int Cp = (C + cells - 1) / cells * cells;
  const int C4 = 4 * C, R8 = ld8(R), C8 = ld8(C), I8 = ld8(I);
  const int N = T * S;
  const FwdCvts cv{{{w_gifo_r, wr_b, 4 * Cp, R, R8, cells, C},
                    {w_r_m, wrm_b, R, C, C8, 0, C},
                    {w_gifo_x, wx_b, C4, I, I8, 0, C},
                    {x, x_b, N, I, I8, 0, C},
                    {r0, r_b, S, R, R8, 0, C}}};
  fwd16_prep_kernel<<<k16::prep_grid(cv), 256, 0, st>>>(cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const k16::Xw16Args xa{x_b, wx_b, bias, mask, inv_keep, xw, N, I, C4, I8};
  err = k16::launch_xw(st, fwd16_xw_kernel, fwd16_xw_wg_kernel, xa,
                       xw_wg != 0, sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the step's two kernels: their shared-memory limits set once a call,
  // so that a step costs the host two launches and nothing else
  err = cudaFuncSetAttribute(fwd16_gates_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GG::kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fwd16_proj_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ProjGemm16::kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gate_grid((S + GG::kBM - 1) / GG::kBM, 4 * Cp / GG::kBN);
  const dim3 proj_grid((S + ProjGemm16::kBM - 1) / ProjGemm16::kBM,
                       (R + ProjGemm16::kBN - 1) / ProjGemm16::kBN);
  const size_t g_step = (size_t)S * C4, c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  for (int t = 0; t < T; ++t) {
    const k16::Gate16Args ga{r_b, wr_b, xw + t * g_step,
                             t == 0 ? c0 : c_out + (t - 1) * c_step, peep,
                             gifo + t * g_step, c_out + t * c_step, m_b, S,
                             R, C, Cp, R8, C8, cell_clip};
    fwd16_gates_kernel<<<gate_grid, GG::kThreads, GG::kSmemBytes, st>>>(ga);
    const k16::Proj16Args pa{m_b, wrm_b, r_out + t * r_step, r_b, S, R, C,
                             C8, R8};
    fwd16_proj_kernel<<<proj_grid, ProjGemm16::kThreads,
                        ProjGemm16::kSmemBytes, st>>>(pa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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

// K1 in bf16 (the --bf16 path; its design in the header): the arguments
// of lstmp_train_fwd_f32 with gifo [T, S, 4C] in bfloat16 and, in place of
// wr_perm and m, bf16 scratch whose rows are padded to a multiple of 8
// elements (ld8), each 16-byte aligned: wr_b [4 Cp, ld8(R)] (Cp = C
// rounded up to whole gate tiles), wrm_b [R, ld8(C)], wx_b [4C, ld8(I)],
// x_b [T S, ld8(I)], r_b [S, ld8(R)], m_b [S, ld8(C)]. xw_wg picks the
// hoisted xw's route (1: wgmma fed by TMA on a persistent grid of at most
// sms CTAs; 0: Gemm16 tiles). 2T + 2 launches. c_out and r_out stay f32.
// Returns a CUDA error code (0 on success).
extern "C" int lstmp_train_fwd_bf16(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* bias, const float* peep, const float* w_r_m, const float* c0,
    const float* r0, const int8_t* mask, float inv_keep, __nv_bfloat16* gifo,
    float* c_out, float* r_out, float* xw, __nv_bfloat16* wr_b,
    __nv_bfloat16* wrm_b, __nv_bfloat16* wx_b, __nv_bfloat16* x_b,
    __nv_bfloat16* r_b, __nv_bfloat16* m_b, int T, int S, int I, int C, int R,
    float cell_clip, int xw_wg, int sms, void* stream) {
  return train_fwd_bf16(x, w_gifo_x, w_gifo_r, bias, peep, w_r_m, c0, r0,
                        mask, inv_keep, gifo, c_out, r_out, xw, wr_b, wrm_b,
                        wx_b, x_b, r_b, m_b, T, S, I, C, R, cell_clip,
                        xw_wg, sms, stream);
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
  return train_bwd_f32(
      x, w_gifo_x, w_gifo_r, w_r_m, peep, c0, r0, gifo, c_seq, r_seq, mask,
      inv_keep, g_r, dc, dr, dgifo, drt, ho, dxw, r_prev, drp, part_wx,
      part_wr, part_wrm, part_dx, dx, dwx, dwr, dwrm, dbias, dpeep, T, S, I,
      C, R, sp_dr, sp_wx, sp_wr, sp_wrm, sp_dx, stream);
}

// K2 in bf16 (the --bf16 path): gifo in bfloat16 as lstmp_train_fwd_bf16
// wrote it, and the arguments of lstmp_train_bwd_f32 less its f32 scratch
// (drt, ho, dxw, r_prev, drp: here bf16 copies) and sp_dr (dr is
// unsplit). Scratch, bf16, each row padded to a multiple of 8 elements
// (ld8): dgifo_b and (with a mask, else null) dxw_b [T, S, ld8(4C)],
// drt_b [T, S, ld8(R)], ho_b [T, S, ld8(C)], x_b [T S, ld8(I)], rprev_b
// [T S, ld8(R)], wr_b [4C, ld8(R)], wrm_b [R, ld8(C)], wx_b [4C, ld8(I)];
// dgifo [T, S, 4C] stays f32 (dbias and the peephole sums, summed over
// sp_cols row ranges into part_cols [sp_cols, 7C], null when sp_cols is
// 1). The gradients come out f32. 2T + 6 launches (+1 with dx): the prologue's
// conversions, dm (with the gate gradients) and dr per step, dWx, dWr,
// dWrm, the column sums, the partials' sum, dx. Returns a CUDA error code.
extern "C" int lstmp_train_bwd_bf16(
    const float* x, const float* w_gifo_x, const float* w_gifo_r,
    const float* w_r_m, const float* peep, const float* c0, const float* r0,
    const __nv_bfloat16* gifo, const float* c_seq, const float* r_seq,
    const int8_t* mask, float inv_keep, const float* g_r, float* dc,
    float* dr, float* dgifo, __nv_bfloat16* dgifo_b, __nv_bfloat16* dxw_b,
    __nv_bfloat16* drt_b, __nv_bfloat16* ho_b, __nv_bfloat16* x_b,
    __nv_bfloat16* rprev_b, __nv_bfloat16* wr_b, __nv_bfloat16* wrm_b,
    __nv_bfloat16* wx_b, float* part_wx, float* part_wr, float* part_wrm,
    float* part_dx, float* part_cols, float* dx, float* dwx, float* dwr,
    float* dwrm, float* dbias, float* dpeep, int T, int S, int I, int C,
    int R, int sp_wx, int sp_wr, int sp_wrm, int sp_dx, int sp_cols,
    void* stream) {
  return train_bwd_bf16(
      x, w_gifo_x, w_gifo_r, w_r_m, peep, c0, r0, gifo, c_seq, r_seq, mask,
      inv_keep, g_r, dc, dr, dgifo, dgifo_b, dxw_b, drt_b, ho_b, x_b,
      rprev_b, wr_b, wrm_b, wx_b, part_wx, part_wr, part_wrm, part_dx,
      part_cols, dx, dwx, dwr, dwrm, dbias, dpeep, T, S, I, C, R, sp_wx,
      sp_wr, sp_wrm, sp_dx, sp_cols, stream);
}
