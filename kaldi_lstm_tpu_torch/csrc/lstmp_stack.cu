// Wavefront ("staircase") schedules for a stack of two LSTMP layers of equal
// cell and projection widths (layer 2's input is layer 1's r), in float32
// (the _f32 entry points) or with bf16 products (_bf16, the JAX package's
// set_matmul_dtype(bfloat16) contract: every operand of a product rounded
// to bf16 where the reference casts it before its dot, f32 sums, f32 gate
// math and state).
//
// Cell math per layer and step (gate order g, i, f, o; Kaldi orientation):
//   pre = x_t Wx^T + bias + r_{t-1} Wr^T
//   g = tanh(g_pre), i = sigmoid(i_pre + c_{t-1} p_i),
//   f = sigmoid(f_pre + c_{t-1} p_f)
//   c = clip(g i + c_{t-1} f, +-cell_clip)          (no clip if <= 0)
//   o = sigmoid(o_pre + c_t p_o)                    (clipped c_t)
//   r = (tanh(c_t) o) Wrm^T
// Layer 2 at step t needs layer 1's r_t, so the layers run a wavefront:
// while layer 1 computes step t, layer 2 computes an earlier one, and the
// two halves of a wavefront step are independent.
//
// K6 (lstmp_stack_fwd2_f32 / _bf16) replaces
// kaldi_lstm_tpu/ops/lstm_stack_pallas.py::_fwd2_kernel: the training
// forward of both layers, writing K1's residuals for each (the
// post-activation gates g, i, f, o, in bf16 under bf16; the clipped c and
// r, every t), so that K2 (lstmp_train.cu) takes them layer by layer as it
// takes K1's.
//   What bounds it on an H100: operations. At S=512, T=20, I=40, C=800,
//   R=512 its products are 2 N [(4C (I+R) + CR) + (4C 2R + CR)] = 120.06
//   GFLOP: 0.7276 ms as 3xTF32 (three TF32 passes at 495 TFLOP/s), 0.1214
//   ms in bf16 (989 TFLOP/s), 1.792 ms on the f32 CUDA cores. At small S
//   the bound is the serial chain: 2 (T + tb) dependent launches, each too
//   small to fill the card.
//   Design: K1's tensor-core tiles (csrc/lstmp_tc.cuh on tc_gemm.cuh's
//   3xTF32 / bf16 mma.sync mainloop), driven over both layers:
//     * one launch makes both layers' gate-interleaved copies of Wr;
//     * layer 1's input projection xw1 = x Wx1^T + b1 is hoisted over all
//       T S rows in one launch;
//     * T = K tb steps in K time blocks; wavefront block kb = 0..K runs
//       layer 1 over block kb (kb < K) and layer 2 over block kb - 1
//       (kb > 0); before layer 2's steps of a block, one launch of the same
//       mainloop computes its hoisted input projection xw2 = r1 Wx2^T + b2
//       over the block's tb S rows (r1 of that block is complete: it was
//       written by the previous wavefront block's launches);
//     * per wavefront step ONE gates launch over both layers' tiles
//       (blockIdx.z picks the layer; K1's gates tile, the cell math in its
//       epilogue) and ONE projection launch over both (32 x 32 tiles).
//   That is 2 + K + 2 (T + tb) launches a call where K1 x 2 makes 2 (2T +
//   2), and each step launch holds twice a layer's tiles: the wavefront
//   pays where one layer's step does not fill the 132 SMs (S <= 256), and
//   costs the extra tb steps and K launches where it does.
//   bf16 (lstmp_stack_fwd2_bf16) is its own design, on K1 bf16's tiles
//   (csrc/lstmp_tc16.cuh: Gemm16 in 64-deep bf16 stages, and wg_gemm.cuh's
//   wgmma ring), the same schedule and launch count, every operand
//   rounded once where it is made:
//     * one prologue launch rounds both layers' Wr (gate-interleaved at
//       the bf16 gate tile's 32 cells), Wrm and Wx, x, r01 and r02 into
//       bf16 scratch (on every call: the optimizer updates the weights in
//       place);
//     * xw1 over T S rows and, per time block, xw2 over tb S rows of r1's
//       bf16 copy take K1 bf16's routes (Gemm16 tiles where the
//       contraction fits one stage, I=40; wgmma fed by TMA past it,
//       R=512), their epilogues adding the bias in f32;
//     * per wavefront step one gates launch over both layers (K1 bf16's
//       64 x 128 tile: gifo in bf16, c in f32, m in bf16 only) and one
//       projection launch (32 x 32 tiles: r in f32 and its bf16 copy;
//       layer 1's copy into a [T, S, R8] buffer that the next step's
//       gates and the next block's xw2 read, layer 2's into its one-row
//       copy).
//
// K7 (lstmp_stack_infer2_f32 / _bf16) replaces ::_infer2_kernel: the
// inference forward, writing layer 2's r for every t and the final (c, r)
// of both layers.
//   What bounds it on an H100: at the serving shape (S=8, T=1000) neither
//   operations (93.80 GFLOP: 1.400 ms on the f32 CUDA cores, 0.5685 ms as
//   3xTF32, 0.0948 ms in bf16) nor bytes, but latency: T + 1 dependent
//   wavefront steps, each two grid barriers and the round trips to L2
//   that stage r and m.
//   Design: K5's persistent, weight-resident cooperative launch
//   (csrc/persistent.cuh, shared with lstmp_infer.cu), one a call, over
//   both layers. CTA b owns cells [b ncell, (b + 1) ncell) and projection
//   columns [b nq, (b + 1) nq) of BOTH layers, and keeps in shared memory
//   both layers' gate slices ([Wx1^T; Wr1^T] and [Wx2^T; Wr2^T], as
//   [k][cell][4]) and both Wrm^T slices ([C][column]), with the cells'
//   bias, peepholes and c state. Grid step k = 0..T:
//     gates of layer 1 at t = k from [x_k | r1_{k-1}] (k < T) and of
//     layer 2 at t = k - 1 from [r1_{k-1} | r2_{k-2}] (k > 0), in ONE
//     block product over the staged row [x_k | r1_{k-1} | r2_{k-2}]:
//     r1_{k-1} is staged once for both layers, and each cell's sum runs
//     over its layer's range of the row (pk::block_product's krange);
//     grid barrier;
//     projections of both layers in one block product over [m1 | m2]
//     (r1_k into a one-row buffer that every CTA reads at step k + 1;
//     r2_{k-1} into the output);
//     grid barrier.
//   2 (T + 1) barriers and 2 (T + 1) staged products a call, where K5 x 2
//   makes 4T of each. A CTA does about 2.9 times a K5 step's FMAs per grid
//   step, on the CUDA cores (f32 FMAs; at S=8 a tensor-core tile would be
//   7/8 padding).
//   Shared memory at C=800, R=512, I=40 on 132 SMs (7 cells and 4
//   projection columns a CTA): layer 1's gate slice 61.8 KB, layer 2's
//   114.7 KB, the two Wrm slices 12.8 KB each: 202 KB of f32 weights.
//   The plan holds, in this order, two staging buffers of
//   at least 8 KB each, the cells' bias and peepholes, layer 1's gate
//   slice, both Wrm slices, layer 2's gate slice, the c state, and gives
//   the staging buffers what is left (up to 64 KB each). So at these
//   widths every f32 weight stays resident and the staging buffers take
//   the 14.4 KB each that is left. Where a slice does not
//   fit (a wider input, wider cells), the same kernel reads that slice
//   from device memory instead, K5's rule: layer 2's gate slice is the
//   first to go, then the Wrm slices, then layer 1's.
//   The time block tb does not shape K7: the entry point only checks that
//   it divides T. Results differ from a serial K5 x 2 only by summation
//   order; every sum runs in a fixed order, so they repeat from run to
//   run.
//   bf16 (lstmp_stack_infer2_bf16) is its own design, on K5 bf16's
//   persistent tensor-core recurrence (stack_infer2_tc_kernel on
//   pk::mma_product_sets: mma.sync m16n8k16, bf16 operands, f32 sums):
//     * one cooperative launch a call, one grid barrier after the
//       prologue and two a wavefront step;
//     * a gate CTA holds the gate rows 4 c + g of its cells of BOTH layers
//       as bf16 in shared memory, laid out as ldmatrix's A operand; the
//       staged row is [x_k | r1_{k-1} | r2_{k-2}] in bf16 (x and r padded
//       to 16), staged once for both layers: layer 1's rows contract over
//       [x | r1], layer 2's over [r1 | r2] (pk::RowSet's koff), as two
//       row sets of one product; the streams are the n8 tiles;
//     * a projection CTA holds ONE layer's 16 columns of Wrm (both
//       layers' columns on one CTA would stage both m rows: at S=8 twice
//       the bytes and half the CTAs);
//     * the prologue rounds each CTA's slices (once a call: the optimizer
//       updates the weights in place), x into a bf16 copy, r01 and r02;
//       the gates epilogue writes c in f32 and m1, m2 in bf16 only; the
//       projection epilogue writes r1_k in f32 (the final state) and its
//       bf16 copy, or r2_{k-1} in f32 into the output and its bf16 copy.
//       No loop rounds anything.
//   Its plan (make_tc2_plan) deals the cells and columns as K5 bf16's
//   does, with both layers' gate rows on each gate CTA: 8 cells a CTA
//   (100 CTAs) at C=800, 32 + 32 projection CTAs of 16 columns (twice
//   that from S=16: two stream groups), 128 KB of bf16 slices a CTA
//   (layer 1's 36.4 KB, layer 2's 66.0 KB, the projection's 25.9 KB).
//   What does not fit goes to device memory in this order: layer 2's
//   gate slice first, then the projection slice, then layer 1's (each
//   rounded by the prologue into scratch and read through L2). The staging tiles take what is left, up to 64 streams;
//   the c state stays in shared memory only where it does not cut them
//   (at S=512 it would halve them). Two gate stream groups (K5 bf16's
//   rule from S=128) would double the gate rows: at C=800, R=512 they do
//   not fit, so one group.
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/lstm_stack.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lstmp_tc.cuh"
#include "lstmp_tc16.cuh"
#include "persistent.cuh"
#include "precision.cuh"

namespace {

// ---------------------------------------------------------------------------
// K6: the training forward on K1's tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kProjTile = 32;   // the projection's 32 x 32 tiles (as K1)

template <class P>
struct Gates2 {
  k1::GateArgs<P> l[2];
};

struct Proj2 {
  k1::Contract l[2];
};

struct Perm2 {
  const float* wr[2];     // [4C, R] w_gifo_r per layer
  float* wr_perm[2];      // [4 Cp, R]
};

// Both layers' gate-interleaved copies of Wr: layer first + blockIdx.y.
__global__ void stack_interleave_kernel(Perm2 a, int first, int C, int Cp,
                                        int R) {
  const bool two = first + blockIdx.y == 1;
  k1::interleave_rows(two ? a.wr[1] : a.wr[0],
                      two ? a.wr_perm[1] : a.wr_perm[0], C, Cp, R,
                      (size_t)blockIdx.x * blockDim.x + threadIdx.x,
                      (size_t)gridDim.x * blockDim.x);
}

// One wavefront step's gates: layer first + blockIdx.z, K1's gates tile.
template <int BM, bool VA, bool VB, class P>
__global__ void __launch_bounds__(
    k1::TileGemm<BM, k1::kGateBN, true, true>::kThreads)
stack_gates_kernel(Gates2<P> a, int first) {
  const k1::GateArgs<P> g = first + blockIdx.z == 1 ? a.l[1] : a.l[0];
  k1::gates_tile<BM, VA, VB, P>(g, blockIdx.x, blockIdx.y);
}

// One wavefront step's projections r = m Wrm^T: layer first + blockIdx.z.
template <bool VA, bool VB, class P>
__global__ void __launch_bounds__(
    k1::TileGemm<kProjTile, kProjTile, true, true>::kThreads)
stack_proj_kernel(Proj2 a, int first) {
  const k1::Contract c = first + blockIdx.z == 1 ? a.l[1] : a.l[0];
  k1::contract_tile<kProjTile, kProjTile, true, true, VA, VB, P>(
      c, blockIdx.x, blockIdx.y, 0);
}

template <int BM, class P>
cudaError_t launch_gates2(cudaStream_t st, const Gates2<P>& a, int first,
                          int nz) {
  using G = k1::TileGemm<BM, k1::kGateBN, true, true, P>;
  const k1::GateArgs<P>& g0 = a.l[first];
  bool va = g0.R % 4 == 0, vb = g0.R % 4 == 0;
  for (int l = first; l < first + nz; ++l) {
    va = va && k1::aligned16(a.l[l].r_prev);
    vb = vb && k1::aligned16(a.l[l].wr_perm);
  }
  auto kernel = va ? (vb ? stack_gates_kernel<BM, true, true, P>
                         : stack_gates_kernel<BM, true, false, P>)
                   : (vb ? stack_gates_kernel<BM, false, true, P>
                         : stack_gates_kernel<BM, false, false, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g0.S + BM - 1) / BM, g0.Cp / k1::kGateCells, nz);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(a, first);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch_proj2(cudaStream_t st, const Proj2& a, int first,
                         int nz) {
  using G = k1::TileGemm<kProjTile, kProjTile, true, true, P>;
  const k1::Contract& c0 = a.l[first];
  bool va = c0.lda % 4 == 0, vb = c0.ldb % 4 == 0;
  for (int l = first; l < first + nz; ++l) {
    va = va && k1::aligned16(a.l[l].a);
    vb = vb && k1::aligned16(a.l[l].b);
  }
  auto kernel = va ? (vb ? stack_proj_kernel<true, true, P>
                         : stack_proj_kernel<true, false, P>)
                   : (vb ? stack_proj_kernel<false, true, P>
                         : stack_proj_kernel<false, false, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((c0.M + kProjTile - 1) / kProjTile,
                  (c0.N + kProjTile - 1) / kProjTile, nz);
  kernel<<<grid, G::kThreads, G::kSmemBytes, st>>>(a, first);
  return cudaGetLastError();
}

// One layer's weights in Kaldi orientation and its sequences.
struct TrainLayer {
  const float* wx;      // [4C, I_l] w_gifo_x (I_2 = R)
  const float* wr;      // [4C, R] w_gifo_r
  const float* bias;    // [4C]
  const float* peep;    // [3, C]
  const float* wrm;     // [R, C] w_r_m
  const float* c0;      // [S, C]
  const float* r0;      // [S, R]
  void* gifo;           // [T, S, 4C] f32 (bf16 in the _bf16 entry point)
  float* c;             // [T, S, C]
  float* r;             // [T, S, R]
};

// K6 under precision P (see lstmp_stack_fwd2_f32 below).
template <class P>
int stack_fwd2(const TrainLayer (&L)[2], const float* x, float* xw1,
               float* xw2, float* wr_perm, float* m, int T, int S, int I,
               int C, int R, int tb, int phases, float cell_clip,
               int gate_bm, void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 || tb <= 0 ||
      T % tb != 0 || phases < 0 || phases > 2 ||
      (gate_bm != 32 && gate_bm != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool run1 = phases != 2, run2 = phases != 1;
  const int first = run1 ? 0 : 1;
  const int Cp = (C + k1::kGateCells - 1) / k1::kGateCells * k1::kGateCells;
  const size_t perm = (size_t)4 * Cp * R;
  float* wr_perms[2] = {wr_perm, wr_perm + perm};
  const Perm2 pa{{L[0].wr, L[1].wr}, {wr_perms[0], wr_perms[1]}};
  const int blocks = static_cast<int>(
      std::min<size_t>((perm + 255) / 256, 1024));
  stack_interleave_kernel<<<dim3(blocks, run1 + run2), 256, 0, st>>>(
      pa, first, C, Cp, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C4 = 4 * C;
  if (run1) {
    const k1::XwArgs xa{x, L[0].wx, L[0].bias, nullptr, 1.f, xw1, T * S, I,
                        C4};
    err = k1::launch_xw<P>(st, xa);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto gates = gate_bm == 64 ? launch_gates2<64, P> : launch_gates2<32, P>;
  const size_t g_step = (size_t)S * C4;
  const size_t c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R;
  const int K = T / tb;
  for (int kb = 0; kb <= K; ++kb) {
    const bool l1 = run1 && kb < K;
    const bool l2 = run2 && kb > 0;
    if (!l1 && !l2) continue;
    if (l2) {
      // xw2 [tb S, 4C] = r1 of block kb - 1 times Wx2^T, + b2
      const k1::XwArgs xa{L[0].r + (size_t)(kb - 1) * tb * r_step, L[1].wx,
                          L[1].bias, nullptr, 1.f, xw2, tb * S, R, C4};
      err = k1::launch_xw<P>(st, xa);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int j = 0; j < tb; ++j) {
      Gates2<P> ga = {};
      Proj2 pj = {};
      for (int l = 0; l < 2; ++l) {
        if (l == 0 ? !l1 : !l2) continue;
        const int t = (l == 0 ? kb : kb - 1) * tb + j;
        const TrainLayer& Y = L[l];
        float* ml = m + l * c_step;
        ga.l[l] = k1::GateArgs<P>{
            t == 0 ? Y.r0 : Y.r + (t - 1) * r_step, wr_perms[l],
            l == 0 ? xw1 + t * g_step : xw2 + j * g_step,
            t == 0 ? Y.c0 : Y.c + (t - 1) * c_step, Y.peep,
            static_cast<float*>(Y.gifo) + t * g_step, Y.c + t * c_step, ml,
            S, R, C, Cp, cell_clip};
        pj.l[l] = k1::make_contract(ml, C, Y.wrm, C, Y.r + t * r_step, S, R,
                                    C, 1);
      }
      const int f = l1 ? 0 : 1;
      const int nz = (l1 ? 1 : 0) + (l2 ? 1 : 0);
      err = gates(st, ga, f, nz);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_proj2<P>(st, pj, f, nz);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6 in bf16: K1 bf16's tiles (csrc/lstmp_tc16.cuh) over both layers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using k16::GateGemm16;
using k16::ld8;
using k16::ProjGemm16;
using k16::XwGemm16;

// The prologue's roundings: both layers' gate-interleaved Wr, Wrm and Wx,
// x, and both layers' r0.
constexpr int kStackCvts = 9;
using StackCvts = k16::FwdCvts<kStackCvts>;

__global__ void stack16_prep_kernel(StackCvts cv) {
  k16::round_rows(cv.c[blockIdx.y]);
}

// A hoisted input projection (xw1 over T S rows, xw2 over a time block's
// tb S rows): K1 bf16's routes.
__global__ void __launch_bounds__(XwGemm16::kThreads)
stack16_xw_kernel(k16::Xw16Args a) {
  extern __shared__ float4 smem4[];
  k16::xw_tile(a, blockIdx.x, blockIdx.y, smem4);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
stack16_xw_wg_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw,
                     k16::Xw16Args a) {
  extern __shared__ float4 smem4[];
  k16::xw_wg(&mx, &mw, a, smem4);
}

struct Gates16x2 {
  k16::Gate16Args l[2];
};

struct Proj16x2 {
  k16::Proj16Args l[2];
};

// One wavefront step's gates: layer first + blockIdx.z, K1 bf16's gates
// tile (64 x 128, 32 cells).
__global__ void __launch_bounds__(GateGemm16::kThreads)
stack16_gates_kernel(Gates16x2 a, int first) {
  extern __shared__ float4 smem4[];
  const k16::Gate16Args g = first + blockIdx.z == 1 ? a.l[1] : a.l[0];
  k16::gates_tile(g, blockIdx.x, blockIdx.y, smem4);
}

// One wavefront step's projections: layer first + blockIdx.z, 32 x 32.
__global__ void __launch_bounds__(ProjGemm16::kThreads)
stack16_proj_kernel(Proj16x2 a, int first) {
  extern __shared__ float4 smem4[];
  const k16::Proj16Args c = first + blockIdx.z == 1 ? a.l[1] : a.l[0];
  k16::proj_tile(c, blockIdx.x, blockIdx.y, smem4);
}

// K6 in bf16 (see lstmp_stack_fwd2_bf16 below).
int stack_fwd2_bf16(const TrainLayer (&L)[2], const float* x, float* xw1,
                    float* xw2, bf16* wr_b, bf16* wrm_b, bf16* wx1_b,
                    bf16* wx2_b, bf16* x_b, bf16* r0_b, bf16* r1_b,
                    bf16* m_b, int T, int S, int I, int C, int R, int tb,
                    int phases, float cell_clip, int xw1_wg, int xw2_wg,
                    int sms, void* stream) {
  if (T <= 0 || S <= 0 || I <= 0 || C <= 0 || R <= 0 || tb <= 0 ||
      T % tb != 0 || phases < 0 || phases > 2 || sms <= 0 ||
      (xw1_wg != 0 && xw1_wg != 1) || (xw2_wg != 0 && xw2_wg != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* copies[] = {wr_b, wrm_b, wx1_b, wx2_b, x_b, r0_b, r1_b, m_b};
  for (const void* q : copies) {
    if (!k1::aligned16(q)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool run1 = phases != 2, run2 = phases != 1;
  const int first = run1 ? 0 : 1;
  const int cells = k16::kGateCells16;
  const int Cp = (C + cells - 1) / cells * cells;
  const int C4 = 4 * C, R8 = ld8(R), C8 = ld8(C), I8 = ld8(I);
  const int N = T * S;
  // per layer: the interleaved Wr, Wrm, r0 (layer 2's is also its running
  // r copy) and m copies
  bf16* wrl[2] = {wr_b, wr_b + (size_t)4 * Cp * R8};
  bf16* wrml[2] = {wrm_b, wrm_b + (size_t)R * C8};
  bf16* r0l[2] = {r0_b, r0_b + (size_t)S * R8};
  bf16* ml[2] = {m_b, m_b + (size_t)S * C8};
  const int n1 = run1 ? 1 : 0, n2 = run2 ? 1 : 0;
  const StackCvts cv{{{L[0].wr, wrl[0], n1 * 4 * Cp, R, R8, cells, C},
                      {L[1].wr, wrl[1], n2 * 4 * Cp, R, R8, cells, C},
                      {L[0].wrm, wrml[0], n1 * R, C, C8, 0, C},
                      {L[1].wrm, wrml[1], n2 * R, C, C8, 0, C},
                      {L[0].wx, wx1_b, n1 * C4, I, I8, 0, C},
                      {L[1].wx, wx2_b, n2 * C4, R, R8, 0, C},
                      {x, x_b, n1 * N, I, I8, 0, C},
                      {L[0].r0, r0l[0], n1 * S, R, R8, 0, C},
                      {L[1].r0, r0l[1], n2 * S, R, R8, 0, C}}};
  stack16_prep_kernel<<<k16::prep_grid(cv), 256, 0, st>>>(cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (run1) {
    const k16::Xw16Args xa{x_b, wx1_b, L[0].bias, nullptr, 1.f, xw1, N, I,
                           C4, I8};
    err = k16::launch_xw(st, stack16_xw_kernel, stack16_xw_wg_kernel, xa,
                         xw1_wg != 0, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the step's two kernels: their shared-memory limits set once a call
  err = cudaFuncSetAttribute(stack16_gates_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GateGemm16::kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(stack16_proj_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ProjGemm16::kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t g_step = (size_t)S * C4, c_step = (size_t)S * C;
  const size_t r_step = (size_t)S * R, rb_step = (size_t)S * R8;
  const int K = T / tb;
  for (int kb = 0; kb <= K; ++kb) {
    const bool l1 = run1 && kb < K;
    const bool l2 = run2 && kb > 0;
    if (!l1 && !l2) continue;
    if (l2) {
      // xw2 [tb S, 4C] = r1 of block kb - 1 (its bf16 copy) times Wx2^T,
      // + b2
      const k16::Xw16Args xa{r1_b + (size_t)(kb - 1) * tb * rb_step, wx2_b,
                             L[1].bias, nullptr, 1.f, xw2, tb * S, R, C4,
                             R8};
      err = k16::launch_xw(st, stack16_xw_kernel, stack16_xw_wg_kernel, xa,
                           xw2_wg != 0, sms);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int f = l1 ? 0 : 1;
    const int nz = (l1 ? 1 : 0) + (l2 ? 1 : 0);
    const dim3 gate_grid((S + GateGemm16::kBM - 1) / GateGemm16::kBM,
                         4 * Cp / GateGemm16::kBN, nz);
    const dim3 proj_grid((S + ProjGemm16::kBM - 1) / ProjGemm16::kBM,
                         (R + ProjGemm16::kBN - 1) / ProjGemm16::kBN, nz);
    for (int j = 0; j < tb; ++j) {
      Gates16x2 ga = {};
      Proj16x2 pj = {};
      for (int l = 0; l < 2; ++l) {
        if (l == 0 ? !l1 : !l2) continue;
        const int t = (l == 0 ? kb : kb - 1) * tb + j;
        const TrainLayer& Y = L[l];
        // layer 1 reads r1_{t-1} from its [T, S, R8] copy (r01's at t =
        // 0); layer 2 its one-row copy, which its projection rewrites
        const bf16* r_prev = l == 1 || t == 0
                                 ? r0l[l]
                                 : r1_b + (size_t)(t - 1) * rb_step;
        bf16* r_next = l == 0 ? r1_b + (size_t)t * rb_step : r0l[1];
        ga.l[l] = k16::Gate16Args{
            r_prev, wrl[l], l == 0 ? xw1 + t * g_step : xw2 + j * g_step,
            t == 0 ? Y.c0 : Y.c + (t - 1) * c_step, Y.peep,
            static_cast<bf16*>(Y.gifo) + t * g_step, Y.c + t * c_step,
            ml[l], S, R, C, Cp, R8, C8, cell_clip};
        pj.l[l] = k16::Proj16Args{ml[l], wrml[l], Y.r + t * r_step, r_next,
                                  S, R, C, C8, R8};
      }
      stack16_gates_kernel<<<gate_grid, GateGemm16::kThreads,
                             GateGemm16::kSmemBytes, st>>>(ga, f);
      stack16_proj_kernel<<<proj_grid, ProjGemm16::kThreads,
                            ProjGemm16::kSmemBytes, st>>>(pj, f);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K7: the inference forward, one persistent cooperative launch
// ---------------------------------------------------------------------------

using pk::kThreads;
using pk::round4;

// One layer's operands in K5's layout.
struct InferLayer {
  const float* w_cat;   // [K, 4C] = [Wx^T; Wr^T], K = I_l + R
  const float* bias;    // [4C]
  const float* peep;    // [3, C]
  const float* wrm_t;   // [C, R]
  float* c;             // [S, C] in/out
  float* m;             // [S, C] scratch
  int K;
  int off_wg, off_wq;   // byte offsets of the resident slices in shared
                        // memory, or -1: read from device memory
};

struct InferParams {
  const float* x;       // [T, S, I]
  const float* r01;     // [S, R]
  const float* r02;     // [S, R]
  float* r1;            // [S, R] layer 1's latest r (the final r1 at the end)
  float* r2;            // [T, S, R]
  InferLayer l[2];
  int T, S, I, C, R;
  float cell_clip;
  int ncell, nq;        // cells / projection columns per CTA
  int wld, qld;         // row strides of the resident slices (elements)
  int buf;              // floats in each of the two staging buffers
  int cst_smem;         // the cells' bias and peepholes in shared memory
  int c_smem;           // the cells' c state in shared memory
  unsigned* bar;        // grid barrier arrivals, zero at launch
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
stack_infer2_kernel(InferParams p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int C = p.C, R = p.R, S = p.S, I = p.I;
  float* stage = reinterpret_cast<float*>(smem4);
  const size_t cst_l = round4(7 * (size_t)p.ncell);
  const size_t cs_l = round4((size_t)S * p.ncell);
  float* cst = stage + 2 * (size_t)p.buf;                 // [2][7][ncell]
  float* cs = cst + (p.cst_smem ? 2 * cst_l : 0);         // [2][S][ncell]
  const size_t C4 = 4 * (size_t)C;
  const int j0 = blockIdx.x * p.ncell;
  const int nc = max(0, min(p.ncell, C - j0));
  const int q0 = blockIdx.x * p.nq;
  const int nqc = max(0, min(p.nq, R - q0));
  const int nquad = (nqc + 3) / 4;

  // Per layer: bias gate g of cell c at bsrc[g bstr + c], peephole w at
  // psrc[w bstr + c], c state at csrc[s cstr + c], from shared memory where
  // the plan placed them (copied in here, c copied back at the end), else
  // from device memory; the gate slice wg [K][wld] and the projection
  // slice wq [C][qld] where resident, else null.
  const float* bsrc[2];
  const float* psrc[2];
  float* csrc[2];
  float* wg[2];
  float* wq[2];
  const int bstr = p.cst_smem ? p.ncell : C;
  const int cstr = p.c_smem ? p.ncell : C;
  #pragma unroll
  for (int l = 0; l < 2; ++l) {
    const InferLayer& L = p.l[l];
    bsrc[l] = L.bias + j0;
    psrc[l] = L.peep + j0;
    if (p.cst_smem) {
      float* dst = cst + l * cst_l;
      for (int e = threadIdx.x; e < 7 * nc; e += kThreads) {
        const int g = e / nc, c = e % nc;
        dst[g * p.ncell + c] = g < 4 ? L.bias[(size_t)g * C + j0 + c]
                                     : L.peep[(size_t)(g - 4) * C + j0 + c];
      }
      bsrc[l] = dst;
      psrc[l] = dst + 4 * p.ncell;
    }
    csrc[l] = L.c + j0;
    if (p.c_smem) {
      float* dst = cs + l * cs_l;
      for (int e = threadIdx.x; e < S * nc; e += kThreads) {
        dst[(e / nc) * p.ncell + e % nc] =
            L.c[(size_t)(e / nc) * C + j0 + e % nc];
      }
      csrc[l] = dst;
    }
    wg[l] = L.off_wg < 0 ? nullptr
                         : reinterpret_cast<float*>(base + L.off_wg);
    wq[l] = L.off_wq < 0 ? nullptr
                         : reinterpret_cast<float*>(base + L.off_wq);
    if (wg[l] != nullptr) {
      for (int e = threadIdx.x; e < L.K * nc * 4; e += kThreads) {
        const int k = e / (nc * 4), rem = e % (nc * 4);
        const int c = rem / 4, g = rem % 4;
        wg[l][(size_t)k * p.wld + 4 * c + g] =
            L.w_cat[(size_t)k * C4 + (size_t)g * C + j0 + c];
      }
    }
    if (wq[l] != nullptr) {
      // the last quad's columns past nqc are zero
      for (int e = threadIdx.x; e < C * 4 * nquad; e += kThreads) {
        const int k = e / (4 * nquad), q = e % (4 * nquad);
        wq[l][(size_t)k * p.qld + q] =
            q < nqc ? L.wrm_t[(size_t)k * R + q0 + q] : 0.f;
      }
    }
  }
  // (block_product synchronises before its first read)

  // Both layers' gates in one pass over the staged row [x_k | r1_{k-1} |
  // r2_{k-2}]: the block product's columns [0, n1) are layer 1's cells
  // (k in [0, I + R)), [n1, n1 + n2) layer 2's (k in [I, I + 2R)); each
  // updates its cells' c and writes m = tanh(c) o.
  auto gates = [&](const float* x_k, const float* r1_prev,
                   const float* r2_prev, int n1, int n2) {
    pk::block_product<VEC>(
        stage, p.buf, S, n2 > 0 ? I + 2 * R : I + R, n1 + n2,
        [&](int s, int k) {
          return k < I ? x_k + (size_t)s * I + k
                       : (k < I + R ? r1_prev + (size_t)s * R + (k - I)
                                    : r2_prev + (size_t)s * R + (k - I - R));
        },
        [&](int col) {
          return col < n1 ? make_int2(0, I + R) : make_int2(I, I + 2 * R);
        },
        [&](int k, int col, float (&w)[4]) {
          const bool two = col >= n1;
          const float* ws = two ? wg[1] : wg[0];
          const int c = two ? col - n1 : col;
          const int kl = two ? k - I : k;
          if (ws != nullptr) {
            pk::load4(ws + (size_t)kl * p.wld + 4 * c, w);
          } else {
            const float* row = (two ? p.l[1].w_cat : p.l[0].w_cat) +
                               (size_t)kl * C4 + j0 + c;
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              w[g] = __ldg(row + (size_t)g * C);
            }
          }
        },
        [&](int s, int col, const float (&a)[4]) {
          const bool two = col >= n1;
          const int c = two ? col - n1 : col;
          const float* bs = two ? bsrc[1] : bsrc[0];
          const float* ps = two ? psrc[1] : psrc[0];
          float* cp = (two ? csrc[1] : csrc[0]) + (size_t)s * cstr + c;
          float cn;
          const float mv = pk::cell_step(
              a[0] + bs[c], a[1] + bs[bstr + c], a[2] + bs[2 * bstr + c],
              a[3] + bs[3 * bstr + c], *cp, ps[c], ps[bstr + c],
              ps[2 * bstr + c], p.cell_clip, &cn);
          *cp = cn;
          (two ? p.l[1].m : p.l[0].m)[(size_t)s * C + j0 + c] = mv;
        });
  };
  // Both layers' projections in one pass over the staged row [m1 | m2]:
  // columns [0, n1) are layer 1's quads (k in [0, C)) writing r1_t,
  // [n1, n1 + n2) layer 2's (k in [C, 2C)) writing r2_t.
  auto proj = [&](float* r1_t, float* r2_t, int n1, int n2) {
    pk::block_product<VEC>(
        stage, p.buf, S, n2 > 0 ? 2 * C : C, n1 + n2,
        [&](int s, int k) {
          return k < C ? p.l[0].m + (size_t)s * C + k
                       : p.l[1].m + (size_t)s * C + (k - C);
        },
        [&](int col) {
          return col < n1 ? make_int2(0, C) : make_int2(C, 2 * C);
        },
        [&](int k, int col, float (&w)[4]) {
          const bool two = col >= n1;
          const float* ws = two ? wq[1] : wq[0];
          const int quad = two ? col - n1 : col;
          const int kl = two ? k - C : k;
          if (ws != nullptr) {
            pk::load4(ws + (size_t)kl * p.qld + 4 * quad, w);
          } else {
            const float* wrm_t = two ? p.l[1].wrm_t : p.l[0].wrm_t;
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int q = 4 * quad + g;
              w[g] = q < nqc ? __ldg(wrm_t + (size_t)kl * R + q0 + q) : 0.f;
            }
          }
        },
        [&](int s, int col, const float (&a)[4]) {
          const bool two = col >= n1;
          const int quad = two ? col - n1 : col;
          float* r_t = two ? r2_t : r1_t;
          #pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int q = 4 * quad + g;
            if (q < nqc) r_t[(size_t)s * R + q0 + q] = a[g];
          }
        });
  };

  pk::GridBarrier grid{p.bar, 0};
  const size_t r_step = (size_t)S * R;
  for (int k = 0; k <= p.T; ++k) {
    const bool l1 = k < p.T, l2 = k > 0;
    // layer 1 at t = k from [x_k | r1_{k-1}], layer 2 at t = k - 1 from
    // [r1_{k-1} | r2_{k-2}] (x_T is never read: layer 1 is done)
    if (nc > 0) {
      gates(p.x + (size_t)min(k, p.T - 1) * S * I, k == 0 ? p.r01 : p.r1,
            k <= 1 ? p.r02 : p.r2 + (size_t)(k - 2) * r_step, l1 ? nc : 0,
            l2 ? nc : 0);
    }
    grid.sync();
    if (nquad > 0) {
      proj(p.r1, p.r2 + (size_t)max(k - 1, 0) * r_step, l1 ? nquad : 0,
           l2 ? nquad : 0);
    }
    grid.sync();
  }
  if (p.c_smem) {   // every thread passed the last barrier
    #pragma unroll
    for (int l = 0; l < 2; ++l) {
      const float* src = cs + l * cs_l;
      for (int e = threadIdx.x; e < S * nc; e += kThreads) {
        p.l[l].c[(size_t)(e / nc) * C + j0 + e % nc] =
            src[(e / nc) * p.ncell + e % nc];
      }
    }
  }
}

// K7's staging buffers grow to 64 KB each where shared memory is left
// (narrower layers than C=800, R=512, where the f32 slices leave 14.4 KB a
// buffer): the staged rows then land in fewer chunks (the buf32k probe of
// tools/bench_stack_parts.py times K5's 32 KB cap against it).
constexpr int kMaxBufFloats = 16384;

struct InferPlan {
  int grid, ncell, nq, wld, qld, buf, smem, sms, cst_smem, c_smem;
  int off_wg[2], off_wq[2];
};

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// One CTA per SM at most, cells and projection columns dealt out as K5
// deals them (ceil(C / SMs), ceil(R / SMs)); shared memory as the source
// header says.
cudaError_t make_infer_plan(int S, int I, int C, int R, InferPlan* pl) {
  if (S <= 0 || I <= 0 || C <= 0 || R <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  const cudaError_t err = pk::device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  pl->sms = sms;
  pl->ncell = (C + sms - 1) / sms;
  pl->nq = (R + sms - 1) / sms;
  pl->grid = std::max((C + pl->ncell - 1) / pl->ncell,
                      (R + pl->nq - 1) / pl->nq);
  // strides in elements that keep the weight reads of neighbouring k on
  // distinct banks (K5's)
  const int nquad = (pl->nq + 3) / 4;
  pl->wld = 4 * pl->ncell + (pl->ncell % 2 == 0 ? 4 : 0);
  pl->qld = 4 * nquad + (nquad % 2 == 0 ? 4 : 0);
  const size_t esz = sizeof(float);
  const size_t room = static_cast<size_t>(optin);
  const size_t cst = 2 * round4(7 * (size_t)pl->ncell) * sizeof(float);
  const size_t cstate = 2 * round4((size_t)S * pl->ncell) * sizeof(float);
  const size_t wg[2] = {round16((size_t)(I + R) * pl->wld * esz),
                        round16((size_t)2 * R * pl->wld * esz)};
  const size_t wq = round16((size_t)C * pl->qld * esz);
  size_t used = 2 * pk::kMinBufFloats * sizeof(float);
  pl->cst_smem = used + cst <= room;
  if (pl->cst_smem) used += cst;
  // the slices in the order they stay resident: -1 marks device memory
  const size_t sizes[4] = {wg[0], wq, wq, wg[1]};
  bool res[4];
  for (int i = 0; i < 4; ++i) {
    res[i] = used + sizes[i] <= room;
    if (res[i]) used += sizes[i];
  }
  pl->c_smem = used + cstate <= room;
  if (pl->c_smem) used += cstate;
  const size_t extra = (room - used) / sizeof(float) / 2 / 4 * 4;
  pl->buf = static_cast<int>(std::min<size_t>(
      kMaxBufFloats, pk::kMinBufFloats + extra));
  size_t off = 2 * (size_t)pl->buf * sizeof(float) +
               (pl->cst_smem ? cst : 0) + (pl->c_smem ? cstate : 0);
  int* offs[4] = {&pl->off_wg[0], &pl->off_wq[0], &pl->off_wq[1],
                  &pl->off_wg[1]};
  for (int i = 0; i < 4; ++i) {
    *offs[i] = res[i] ? static_cast<int>(off) : -1;
    if (res[i]) off += sizes[i];
  }
  pl->smem = static_cast<int>(off);
  return cudaSuccess;
}

int stack_infer2(const float* x, const InferLayer (&L)[2], const float* r01,
                 const float* r02, float* r1, float* r2, unsigned* bar,
                 int T, int S, int I, int C, int R, int tb, float cell_clip,
                 void* stream) {
  if (T <= 0 || tb <= 0 || T % tb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  InferPlan pl;
  cudaError_t err = make_infer_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging copies need every row of x, r and m 16-byte aligned
  const bool vec = I % 4 == 0 && R % 4 == 0 && C % 4 == 0;
  const void* kernel =
      vec ? reinterpret_cast<const void*>(stack_infer2_kernel<true>)
          : reinterpret_cast<const void*>(stack_infer2_kernel<false>);
  InferParams prm{x, r01, r02, r1, r2, {L[0], L[1]}, T, S, I, C, R,
                  cell_clip, pl.ncell, pl.nq, pl.wld, pl.qld, pl.buf,
                  pl.cst_smem, pl.c_smem, bar};
  for (int l = 0; l < 2; ++l) {
    prm.l[l].K = (l == 0 ? I : R) + R;
    prm.l[l].off_wg = pl.off_wg[l];
    prm.l[l].off_wq = pl.off_wq[l];
  }
  void* args[] = {&prm};
  return static_cast<int>(pk::launch_cooperative(
      kernel, pl.grid, pl.smem, pl.sms, bar, args,
      static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// K7 in bf16: the persistent recurrence on the bf16 tensor cores
// ---------------------------------------------------------------------------

using pk::kUnitFloats;
using pk::kWarps;

constexpr int kTileStreams = 64;   // streams a staged tile holds at most

__host__ __device__ __forceinline__ int up(int n, int m) {
  return (n + m - 1) / m * m;
}

// K7 bf16's plan (ops/lstm_stack.py::k7_bf16_plan mirrors it, field for
// field; the header of this file says how it is chosen).
struct Tc2Plan {
  int grid, sms;
  int ncell, gcgroups, gsgroups, gnsg, gate_ctas, mg;
                                   // gates: cells a CTA (a multiple of 4)
                                   // of BOTH layers, cell groups, stream
                                   // groups, streams a group (a multiple
                                   // of 8), CTAs with cells, gate rows
                                   // 4 ncell a layer
  int mq, qgroups, sgroups, nsg, proj_ctas;
                                   // projection: columns a CTA (a multiple
                                   // of 16) of ONE layer, column groups a
                                   // layer, stream groups, streams a
                                   // group, CTAs with columns (both layers)
  int xp, rp, kg1, kg2, kg, ksg;   // x, r padded to 16; layer 1's
                                   // contraction [x | r1] and layer 2's
                                   // [r1 | r2]; the staged row [x | r1 |
                                   // r2] and its stride
  int cp, kq, ksq;                 // m padded to 8; the projection's
                                   // contraction padded to 16; its stride
  int ns_g, ns_q;                  // streams a staged tile, each phase
  int res_g1, res_q, res_g2, c_smem;
  int part_floats, stage_elems;    // partial sums; one staging buffer
  int off_cst, off_c, off_g1, off_q, off_g2, off_stage, smem;   // bytes
};
constexpr int kTc2PlanInts = 37;
static_assert(sizeof(Tc2Plan) == kTc2PlanInts * sizeof(int),
              "Tc2Plan holds ints only");

// Partial sums (floats) for tiles of ns_g (gates: both layers' row sets)
// and ns_q (projection) streams: 128 an output tile and split.
int tc2_part_floats(const Tc2Plan& q, int ns_g, int ns_q) {
  const int gate = 2 * (q.mg / 16) * (ns_g / 8);
  const int proj = (q.mq / 16) * (ns_q / 8);
  return kUnitFloats * std::max(kWarps, std::max(gate, proj));
}

// Shared bytes of the staging buffers and the partial sums.
long long tc2_stage_bytes(const Tc2Plan& q, int ns_g, int ns_q) {
  const long long stage =
      2LL * 2 * std::max((long long)ns_g * q.ksg, (long long)ns_q * q.ksq);
  return stage + 4LL * tc2_part_floats(q, ns_g, ns_q);
}

// Tiles of at most `most` streams over n, as even as multiples of 8 allow.
int even_tile(int n, int most) {
  const int tiles = (n + most - 1) / most;
  return up((n + tiles - 1) / tiles, 8);
}

// The largest staging tiles (a multiple of 8, at most 64 and each phase's
// stream group) whose buffers and partial sums fit in `avail` bytes:
// sets ns_g, ns_q; false if two 8-stream tiles do not fit.
bool tc2_tiles(Tc2Plan* q, long long avail) {
  for (int most = kTileStreams; most >= 8; most -= 8) {
    const int ng = even_tile(q->gnsg, most), nq = even_tile(q->nsg, most);
    if (tc2_stage_bytes(*q, ng, nq) <= avail) {
      q->ns_g = ng;
      q->ns_q = nq;
      return true;
    }
  }
  return false;
}

// The plan with the gate streams in gs groups. Gates: the CTAs of a
// stream group take ncell = ceil(C gs / SMs) cells each of both layers,
// rounded up to a multiple of 4 (4 ncell rows of a layer fill whole m16
// tiles). Projection: each CTA one layer's columns, in groups of mq = 16
// (one m16 tile; more only when R > 16 floor(SMs / 2)), and the streams
// in as many groups of nsg (a multiple of 8) as the SMs left over by both
// layers' column groups allow. Shared memory: the cells' bias and peepholes;
// then the weight slices in the order layer 1's gate slice, the
// projection slice, layer 2's gate slice, each resident while it and
// those before it leave room for two 8-stream staging tiles (from the
// first that does not, its bf16 copy and those after it are made in
// device memory by the prologue and read through L2); then the staging
// tiles as
// large as what is left allows; the cells' c state only where it does
// not cut those tiles (else it stays in device memory).
cudaError_t tc2_plan_for(int S, int I, int C, int R, int sms, int optin,
                         int gs, Tc2Plan* pl) {
  Tc2Plan q{};
  q.sms = sms;
  q.ncell = up((C + sms / gs - 1) / (sms / gs), 4);
  q.gcgroups = (C + q.ncell - 1) / q.ncell;
  q.gnsg = up((S + gs - 1) / gs, 8);
  q.gsgroups = (S + q.gnsg - 1) / q.gnsg;
  q.gate_ctas = q.gcgroups * q.gsgroups;
  q.mg = 4 * q.ncell;
  q.mq = 16 * (((R + 15) / 16 + sms / 2 - 1) / (sms / 2));
  q.qgroups = (R + q.mq - 1) / q.mq;
  q.sgroups = std::max(1, std::min(sms / (2 * q.qgroups), (S + 7) / 8));
  q.nsg = up((S + q.sgroups - 1) / q.sgroups, 8);
  q.sgroups = (S + q.nsg - 1) / q.nsg;
  q.proj_ctas = 2 * q.qgroups * q.sgroups;
  q.grid = std::max(q.gate_ctas, q.proj_ctas);
  q.xp = up(I, 16);
  q.rp = up(R, 16);
  q.kg1 = q.xp + q.rp;
  q.kg2 = 2 * q.rp;
  q.kg = q.xp + 2 * q.rp;
  q.ksg = q.kg + 8;
  q.cp = up(C, 8);
  q.kq = up(q.cp, 16);
  q.ksq = q.kq + 8;
  const long long cst = 4LL * 2 * up(7 * q.ncell, 4);
  const long long cstate = 4LL * 2 * up(q.gnsg * q.ncell, 4);
  const long long wg1 = 2LL * q.mg * (q.kg1 + 8);
  const long long wq = 2LL * q.mq * (q.kq + 8);
  const long long wg2 = 2LL * q.mg * (q.kg2 + 8);
  const long long least = tc2_stage_bytes(q, 8, 8);
  long long used = cst;
  q.res_g1 = used + wg1 + least <= optin;
  used += q.res_g1 ? wg1 : 0;
  q.res_q = q.res_g1 && used + wq + least <= optin;
  used += q.res_q ? wq : 0;
  q.res_g2 = q.res_q && used + wg2 + least <= optin;
  used += q.res_g2 ? wg2 : 0;
  if (!tc2_tiles(&q, optin - used)) return cudaErrorInvalidValue;
  auto tiles = [](const Tc2Plan& p) {   // staged tiles a step, both phases
    return (p.gnsg + p.ns_g - 1) / p.ns_g + (p.nsg + p.ns_q - 1) / p.ns_q;
  };
  Tc2Plan with_c = q;
  const bool c_fits = tc2_tiles(&with_c, optin - used - cstate);
  q.c_smem = c_fits && tiles(with_c) == tiles(q);
  if (q.c_smem) {
    q.ns_g = with_c.ns_g;
    q.ns_q = with_c.ns_q;
  }
  q.part_floats = tc2_part_floats(q, q.ns_g, q.ns_q);
  q.stage_elems = std::max(q.ns_g * q.ksg, q.ns_q * q.ksq);
  long long off = 4LL * q.part_floats;
  q.off_cst = static_cast<int>(off);
  off += cst;
  q.off_c = static_cast<int>(off);
  off += q.c_smem ? cstate : 0;
  q.off_g1 = static_cast<int>(off);
  off += q.res_g1 ? wg1 : 0;
  q.off_q = static_cast<int>(off);
  off += q.res_q ? wq : 0;
  q.off_g2 = static_cast<int>(off);
  off += q.res_g2 ? wg2 : 0;
  q.off_stage = static_cast<int>(off);
  q.smem = static_cast<int>(off + 2LL * 2 * q.stage_elems);
  *pl = q;
  return cudaSuccess;
}

// One gate stream group, or two from S = 128 on where that plan keeps
// every slice resident with tiles of 32 streams or more (K5 bf16's rule).
// At C=800, R=512 both layers' slices of 16 cells do not fit, so the deep
// configuration takes one group at every S.
cudaError_t make_tc2_plan(int S, int I, int C, int R, int sms, int optin,
                          Tc2Plan* pl) {
  if (S <= 0 || I <= 0 || C <= 0 || R <= 0 || sms < 2) {
    return cudaErrorInvalidValue;
  }
  if (S >= 128) {
    Tc2Plan two;
    if (tc2_plan_for(S, I, C, R, sms, optin, 2, &two) == cudaSuccess &&
        two.res_g1 && two.res_q && two.res_g2 && two.ns_g >= 32) {
      *pl = two;
      return cudaSuccess;
    }
  }
  return tc2_plan_for(S, I, C, R, sms, optin, 1, pl);
}

// One layer's operands of K7 bf16.
struct Tc2Layer {
  const float* wx;      // [4C, I_l]  (Kaldi orientation, as the params
  const float* wr;      // [4C, R]     hold them: each CTA reads its rows
  const float* bias;    // [4C]        once a call)
  const float* peep;    // [3, C]
  const float* wrm;     // [R, C]
  const float* r0;      // [S, R]
  float* c;             // [S, C] in/out
  bf16* rb;             // [S, rp] r_{t-1} rounded (the projection writes it)
  bf16* mb;             // [S, cp] m = tanh(c) o rounded (the gates write it)
  bf16* wg;             // [grid, mg, kg_l] the gate slices rounded, where
                        // they are not resident; else null
  int in;               // I_l: I, or R for layer 2
};

struct Tc2Params {
  const float* x;       // [T, S, I]
  float* r1;            // [S, R] layer 1's latest r (the final r1 at the end)
  float* r2;            // [T, S, R]
  bf16* xb;             // [T, S, xp] x rounded, once a call
  bf16* wq;             // [grid, mq, kq] the projection slices rounded,
                        // where they are not resident; else null
  Tc2Layer l[2];
  int T, S, I, C, R;
  float cell_clip;
  Tc2Plan pl;
  unsigned* bar;
};

__global__ void __launch_bounds__(kThreads, 1)
stack_infer2_tc_kernel(Tc2Params p) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const Tc2Plan& pl = p.pl;
  const int C = p.C, R = p.R, S = p.S, I = p.I;
  const int tid = threadIdx.x, b = blockIdx.x;
  float* part = reinterpret_cast<float*>(sm);
  float* cst = reinterpret_cast<float*>(sm + pl.off_cst);  // [2][7][ncell]
  const int cstl = up(7 * pl.ncell, 4);
  bf16* stage = reinterpret_cast<bf16*>(sm + pl.off_stage);

  // this CTA's cells (of both layers) and their streams; its projection
  // layer, columns and their streams
  const int j0 = (b % pl.gcgroups) * pl.ncell;
  const int nc = b < pl.gate_ctas ? min(pl.ncell, C - j0) : 0;
  const int sg0 = b < pl.gate_ctas ? (b / pl.gcgroups) * pl.gnsg : 0;
  const int sg1 = b < pl.gate_ctas ? min(S, sg0 + pl.gnsg) : 0;
  const int pq = pl.qgroups * pl.sgroups;
  const bool proj = b < pl.proj_ctas;
  const int lq = proj ? b / pq : 0;
  const int q0 = (b % pq % pl.qgroups) * pl.mq;
  const int nqc = proj ? min(pl.mq, R - q0) : 0;
  const int sq0 = proj ? (b % pq / pl.qgroups) * pl.nsg : 0;
  const int sq1 = proj ? min(S, sq0 + pl.nsg) : 0;

  // the weight slices in bf16, rounded once a call: gate row m = 4 c + g
  // (gate g of cell j0 + c) of layer l over its contraction (layer 1 [x |
  // r1], layer 2 [r1 | r2], each part padded to 16), projection row q
  // (column q0 + q of layer lq) over the cells; zero where there is no
  // weight
  const int kgl[2] = {pl.kg1, pl.kg2};
  const int res_g[2] = {pl.res_g1, pl.res_g2};
  bf16* wg[2];
  int wgld[2];
  #pragma unroll
  for (int l = 0; l < 2; ++l) {
    wg[l] = res_g[l] ? reinterpret_cast<bf16*>(
                           sm + (l == 0 ? pl.off_g1 : pl.off_g2))
                     : p.l[l].wg + (size_t)b * pl.mg * kgl[l];
    wgld[l] = res_g[l] ? kgl[l] + 8 : kgl[l];
  }
  bf16* wq = pl.res_q ? reinterpret_cast<bf16*>(sm + pl.off_q)
                      : p.wq + (size_t)b * pl.mq * pl.kq;
  const int wqld = pl.res_q ? pl.kq + 8 : pl.kq;
  // (row by row, neighbouring threads on neighbouring k; 8 loads a
  // thread in flight: the weights come from device memory)
  if (nc > 0) {
    #pragma unroll
    for (int l = 0; l < 2; ++l) {
      const Tc2Layer& L = p.l[l];
      const int kk = kgl[l], xo = l == 0 ? pl.xp : pl.rp;
      pk::batched_fill(pl.mg * kk, [&](int e) {
        const int m = e / kk, k = e % kk, c = m >> 2, g = m & 3;
        const size_t row = (size_t)g * C + j0 + c;
        if (c >= nc) return 0.f;
        if (k < L.in) return __ldg(L.wx + row * L.in + k);
        if (k >= xo && k - xo < R) return __ldg(L.wr + row * R + (k - xo));
        return 0.f;
      }, [&](int e, float v) {
        wg[l][(size_t)(e / kk) * wgld[l] + e % kk] = __float2bfloat16_rn(v);
      });
    }
  }
  if (nqc > 0) {
    const float* wrm = lq == 0 ? p.l[0].wrm : p.l[1].wrm;
    pk::batched_fill(pl.mq * pl.kq, [&](int e) {
      const int m = e / pl.kq, k = e % pl.kq;
      return m < nqc && k < C ? __ldg(wrm + (size_t)(q0 + m) * C + k) : 0.f;
    }, [&](int e, float v) {
      wq[(size_t)(e / pl.kq) * wqld + e % pl.kq] = __float2bfloat16_rn(v);
    });
  }
  // both layers' bias and peepholes, and c state of (stream sg0 + i, cell
  // j0 + c) at csrc[l][i cstr + c]
  float* csrc[2];
  const int cstr = pl.c_smem ? pl.ncell : C;
  const int csl = up(pl.gnsg * pl.ncell, 4);
  #pragma unroll
  for (int l = 0; l < 2; ++l) {
    const Tc2Layer& L = p.l[l];
    for (int e = tid; e < 7 * nc; e += kThreads) {
      const int g = e / nc, c = e % nc;
      cst[l * cstl + g * pl.ncell + c] =
          g < 4 ? L.bias[(size_t)g * C + j0 + c]
                : L.peep[(size_t)(g - 4) * C + j0 + c];
    }
    csrc[l] = L.c + (size_t)sg0 * C + j0;
    if (pl.c_smem) {
      float* cs = reinterpret_cast<float*>(sm + pl.off_c) + l * csl;
      for (int e = tid; e < (sg1 - sg0) * nc; e += kThreads) {
        cs[(e / nc) * pl.ncell + e % nc] =
            L.c[(size_t)(sg0 + e / nc) * C + j0 + e % nc];
      }
      csrc[l] = cs;
    }
  }
  // the bf16 copies every CTA stages: x (once a call), both layers' r0,
  // and the zero padding of m (the epilogues write only the real columns)
  {
    const size_t gt = (size_t)gridDim.x * kThreads;
    const size_t gi = (size_t)b * kThreads + tid;
    const size_t nx = (size_t)p.T * S * pl.xp;
    for (size_t e = gi; e < nx; e += gt) {
      const int k = static_cast<int>(e % pl.xp);
      p.xb[e] = __float2bfloat16_rn(k < I ? p.x[(e / pl.xp) * I + k] : 0.f);
    }
    const int mpad = pl.cp - C;
    #pragma unroll
    for (int l = 0; l < 2; ++l) {
      const Tc2Layer& L = p.l[l];
      for (size_t e = gi; e < (size_t)S * pl.rp; e += gt) {
        const int k = static_cast<int>(e % pl.rp);
        L.rb[e] = __float2bfloat16_rn(k < R ? L.r0[(e / pl.rp) * R + k] : 0.f);
      }
      for (size_t e = gi; e < (size_t)S * mpad; e += gt) {
        L.mb[(e / mpad) * pl.cp + C + e % mpad] = __float2bfloat16_rn(0.f);
      }
    }
  }
  pk::GridBarrier gbar{p.bar, 0};
  gbar.sync();   // the copies are complete, the slices in place

  const size_t r_step = (size_t)S * R;
  for (int k = 0; k <= p.T; ++k) {
    const bool l1 = k < p.T, l2 = k > 0;
    // layer 1 at t = k from [x_k | r1_{k-1}], layer 2 at t = k - 1 from
    // [r1_{k-1} | r2_{k-2}], both from one staged row [x_k | r1 | r2]
    // (x_T is staged but not read: layer 1 is done)
    if (nc > 0) {
      const bf16* x_k = p.xb + (size_t)min(k, p.T - 1) * S * pl.xp;
      // set 0 is layer 1's rows while it runs, else layer 2's
      const pk::RowSet set1{wg[0], wgld[0], pl.mg / 16, pl.kg1 / 16, 0,
                            pl.res_g1};
      const pk::RowSet set2{wg[1], wgld[1], pl.mg / 16, pl.kg2 / 16, pl.xp,
                            pl.res_g2};
      const pk::RowSet sets[2] = {l1 ? set1 : set2, set2};
      const int nsets = l1 && l2 ? 2 : 1;
      pk::mma_product_sets<-1>(
          stage, pl.stage_elems, part, sg0, sg1, pl.ns_g, pl.ksg, sets,
          nsets,
          [&](bf16* buf, int s0, int sn) {
            const int nch = pl.kg / 8;
            const int total = up(sn, 8) * nch;
            for (int e = tid; e < total; e += kThreads) {
              const int sl = e / nch, kk = (e % nch) * 8;
              const bf16* src = p.xb;
              int bytes = 0;
              if (sl < sn) {
                const int s = s0 + sl;
                bytes = 16;
                if (kk < pl.xp) {
                  src = x_k + (size_t)s * pl.xp + kk;
                } else if (kk < pl.xp + pl.rp) {
                  src = p.l[0].rb + (size_t)s * pl.rp + (kk - pl.xp);
                } else {
                  src = p.l[1].rb + (size_t)s * pl.rp + (kk - pl.xp - pl.rp);
                }
              }
              pk::cp_async16z(buf + (size_t)sl * pl.ksg + kk, src, bytes);
            }
            pk::cp_async_commit();
          },
          [&](int s0, int sn, const pk::MmaSum& sum) {
            const int per = sn * nc;
            for (int e = tid; e < nsets * per; e += kThreads) {
              const int a = e / per, sl = e % per / nc, c = e % nc;
              const int l = a == 1 || !l1 ? 1 : 0;
              const int s = s0 + sl, m = a * pl.mg + 4 * c;
              float* cp = (l ? csrc[1] : csrc[0]) + (size_t)(s - sg0) * cstr +
                          c;
              const float* bs = cst + l * cstl + c;
              const int bstr = pl.ncell;
              float cn;
              const float mv = pk::cell_step(
                  sum(m, sl) + bs[0], sum(m + 1, sl) + bs[bstr],
                  sum(m + 2, sl) + bs[2 * bstr],
                  sum(m + 3, sl) + bs[3 * bstr], *cp, bs[4 * bstr],
                  bs[5 * bstr], bs[6 * bstr], p.cell_clip, &cn);
              *cp = cn;
              (l ? p.l[1].mb : p.l[0].mb)[(size_t)s * pl.cp + j0 + c] =
                  __float2bfloat16_rn(mv);
            }
          });
    }
    gbar.sync();
    // projection of layer lq: r1_k (layer 1, into the one-row r1 and its
    // copy) or r2_{k-1} (layer 2, into the output and its copy)
    if (nqc > 0 && (lq == 0 ? l1 : l2)) {
      bf16* mb = lq == 0 ? p.l[0].mb : p.l[1].mb;
      bf16* rb = lq == 0 ? p.l[0].rb : p.l[1].rb;
      float* r_t = lq == 0 ? p.r1 : p.r2 + (size_t)max(k - 1, 0) * r_step;
      const pk::RowSet sets[2] = {
          pk::RowSet{wq, wqld, pl.mq / 16, pl.kq / 16, 0, pl.res_q},
          pk::RowSet{}};
      pk::mma_product_sets<-1>(
          stage, pl.stage_elems, part, sq0, sq1, pl.ns_q, pl.ksq, sets, 1,
          [&](bf16* buf, int s0, int sn) {
            const int nch = pl.kq / 8;
            const int total = up(sn, 8) * nch;
            for (int e = tid; e < total; e += kThreads) {
              const int sl = e / nch, kk = (e % nch) * 8;
              const bool ok = sl < sn && kk < pl.cp;
              pk::cp_async16z(buf + (size_t)sl * pl.ksq + kk,
                              ok ? mb + (size_t)(s0 + sl) * pl.cp + kk : mb,
                              ok ? 16 : 0);
            }
            pk::cp_async_commit();
          },
          [&](int s0, int sn, const pk::MmaSum& sum) {
            for (int e = tid; e < sn * nqc; e += kThreads) {
              const int sl = e / nqc, q = e % nqc, s = s0 + sl;
              const float v = sum(q, sl);
              r_t[(size_t)s * R + q0 + q] = v;
              rb[(size_t)s * pl.rp + q0 + q] = __float2bfloat16_rn(v);
            }
          });
    }
    gbar.sync();
  }
  if (pl.c_smem) {   // every thread passed the last barrier
    #pragma unroll
    for (int l = 0; l < 2; ++l) {
      const float* cs = reinterpret_cast<const float*>(sm + pl.off_c) +
                        l * csl;
      for (int e = tid; e < (sg1 - sg0) * nc; e += kThreads) {
        p.l[l].c[(size_t)(sg0 + e / nc) * C + j0 + e % nc] =
            cs[(e / nc) * pl.ncell + e % nc];
      }
    }
  }
}

int stack_infer2_bf16(const float* x, const Tc2Layer (&L)[2], float* r1,
                      float* r2, bf16* xb, bf16* wq, unsigned* bar, int T,
                      int S, int I, int C, int R, int tb, float cell_clip,
                      void* stream) {
  if (T <= 0 || tb <= 0 || T % tb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, optin = 0;
  cudaError_t err = pk::device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tc2Plan pl;
  err = make_tc2_plan(S, I, C, R, sms, optin, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* copies[] = {xb, L[0].rb, L[1].rb, L[0].mb, L[1].mb};
  for (const void* q : copies) {
    if (q == nullptr || !k1::aligned16(q)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if ((!pl.res_g1 && L[0].wg == nullptr) || (!pl.res_g2 && L[1].wg == nullptr) ||
      (!pl.res_q && wq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tc2Params prm{x, r1, r2, xb, wq, {L[0], L[1]}, T, S, I, C, R, cell_clip,
                pl, bar};
  void* args[] = {&prm};
  return static_cast<int>(pk::launch_cooperative(
      reinterpret_cast<const void*>(stack_infer2_tc_kernel), pl.grid,
      pl.smem, pl.sms, bar, args, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// K6. x [T, S, I] time-major; per layer n = 1, 2 the weights in Kaldi
// orientation: wxn [4C, I_n] (I_1 = I, I_2 = R), wrn [4C, R], biasn [4C],
// peepn [3, C] (i, f, o), wrmn [R, C]; c0n [S, C], r0n [S, R]. Out per
// layer: gifon [T, S, 4C] (g, i, f, o activations; bfloat16 in the _bf16
// entry point), cn [T, S, C] (clipped), rn [T, S, R]. Scratch: xw1
// [T, S, 4C], xw2 [tb, S, 4C], wr_perm [2, 4 Cp, R] (Cp = C rounded up to
// a multiple of 16), m [2, S, C]. tb divides T. phases: 0 both layers, 1
// layer 1 only, 2 layer 2 only (over whatever r1 holds); a timing
// ablation. gate_bm (32 or 64) is the gate tile's rows
// (ops/lstm_stack.py::fwd2_plan). 2 + K + 2 (T + tb) launches with both
// layers (K = T / tb), 2 + 2T with layer 1 only, 1 + K + 2T with layer 2
// only, on `stream`, no synchronisation, no allocation. Returns a CUDA
// error code (0 on success).
extern "C" int lstmp_stack_fwd2_f32(
    const float* x, const float* wx1, const float* wr1, const float* bias1,
    const float* peep1, const float* wrm1, const float* wx2,
    const float* wr2, const float* bias2, const float* peep2,
    const float* wrm2, const float* c01, const float* r01, const float* c02,
    const float* r02, float* gifo1, float* c1, float* r1, float* gifo2,
    float* c2, float* r2, float* xw1, float* xw2, float* wr_perm, float* m,
    int T, int S, int I, int C, int R, int tb, int phases, float cell_clip,
    int gate_bm, void* stream) {
  const TrainLayer L[2] = {
      {wx1, wr1, bias1, peep1, wrm1, c01, r01, gifo1, c1, r1},
      {wx2, wr2, bias2, peep2, wrm2, c02, r02, gifo2, c2, r2}};
  return stack_fwd2<tc::F32>(L, x, xw1, xw2, wr_perm, m, T, S, I, C, R, tb,
                             phases, cell_clip, gate_bm, stream);
}

// K6 in bf16 (its design in the header): the arguments of
// lstmp_stack_fwd2_f32 with gifo1 and gifo2 in bfloat16 and, in place of
// wr_perm and m, bf16 scratch whose rows are padded to a multiple of 8
// elements (ld8), each 16-byte aligned: wr_b [2, 4 Cp, ld8(R)] (Cp = C
// rounded up to whole 32-cell gate tiles), wrm_b [2, R, ld8(C)], wx1_b
// [4C, ld8(I)], wx2_b [4C, ld8(R)], x_b [T S, ld8(I)], r0_b [2, S,
// ld8(R)] (r01 and r02 rounded; layer 2's row is its running r copy),
// r1_b [T S, ld8(R)] (layer 1's r rounded, every t; zero on entry with
// phases 2), m_b [2, S, ld8(C)]. xw1_wg and xw2_wg pick the hoisted
// projections' routes (1: wgmma fed by TMA on a persistent grid of at
// most sms CTAs; 0: Gemm16 tiles). No gate_bm: the gate tile is K1
// bf16's 64 x 128. Launches as lstmp_stack_fwd2_f32. c and r stay f32.
extern "C" int lstmp_stack_fwd2_bf16(
    const float* x, const float* wx1, const float* wr1, const float* bias1,
    const float* peep1, const float* wrm1, const float* wx2,
    const float* wr2, const float* bias2, const float* peep2,
    const float* wrm2, const float* c01, const float* r01, const float* c02,
    const float* r02, __nv_bfloat16* gifo1, float* c1, float* r1,
    __nv_bfloat16* gifo2, float* c2, float* r2, float* xw1, float* xw2,
    __nv_bfloat16* wr_b, __nv_bfloat16* wrm_b, __nv_bfloat16* wx1_b,
    __nv_bfloat16* wx2_b, __nv_bfloat16* x_b, __nv_bfloat16* r0_b,
    __nv_bfloat16* r1_b, __nv_bfloat16* m_b, int T, int S, int I, int C,
    int R, int tb, int phases, float cell_clip, int xw1_wg, int xw2_wg,
    int sms, void* stream) {
  const TrainLayer L[2] = {
      {wx1, wr1, bias1, peep1, wrm1, c01, r01, gifo1, c1, r1},
      {wx2, wr2, bias2, peep2, wrm2, c02, r02, gifo2, c2, r2}};
  return stack_fwd2_bf16(L, x, xw1, xw2, wr_b, wrm_b, wx1_b, wx2_b, x_b,
                         r0_b, r1_b, m_b, T, S, I, C, R, tb, phases,
                         cell_clip, xw1_wg, xw2_wg, sms, stream);
}

// The launch plan of K7 for these widths. f32 (bf16 = 0; on the current
// device): out[0..13] = grid, cells per CTA, projection columns per CTA,
// gate-slice stride, projection-slice stride, floats per staging buffer,
// dynamic shared memory bytes, SM count, the cells' bias and peepholes in
// shared memory (1) or not, their c state in shared memory (1) or not,
// and the byte offsets in shared memory of layer 1's and layer 2's gate
// slices and of layer 1's and layer 2's projection slices (-1: read from
// device memory). bf16 (bf16 = 1; on the current device): out[0..36] =
// Tc2Plan's fields in order (ops/lstm_stack.py::K7_BF16_PLAN_KEYS).
// Returns a CUDA error code.
extern "C" int lstmp_stack_infer2_plan(int S, int I, int C, int R, int bf16,
                                       int* out) {
  if (bf16 != 0) {
    int sms = 0, optin = 0;
    cudaError_t err = pk::device_limits(&sms, &optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    Tc2Plan pl;
    err = make_tc2_plan(S, I, C, R, sms, optin, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int* v = reinterpret_cast<const int*>(&pl);
    for (int i = 0; i < kTc2PlanInts; ++i) out[i] = v[i];
    return 0;
  }
  InferPlan pl;
  const cudaError_t err = make_infer_plan(S, I, C, R, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[14] = {pl.grid, pl.ncell, pl.nq, pl.wld, pl.qld, pl.buf,
                     pl.smem, pl.sms, pl.cst_smem, pl.c_smem, pl.off_wg[0],
                     pl.off_wg[1], pl.off_wq[0], pl.off_wq[1]};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// K7. x [T, S, I] time-major; per layer n = 1, 2 the weights in K5's
// layout: w_catn = [Wx^T; Wr^T] ([(I + R), 4C] and [2R, 4C]), biasn [4C],
// peepn [3, C], wrmn_t [C, R]; r0n [S, R]. In/out: c1, c2 [S, C] hold c0
// on entry and the final c on return. Out: r1 [S, R] the final r of layer
// 1, r2 [T, S, R]. Scratch: m [2, S, C]; bar is one unsigned for the grid
// barrier, zeroed on `stream` here before the launch (a call's own). tb
// must divide T; it does not shape the kernel. One cooperative launch on
// `stream`, no synchronisation, no allocation. Returns a CUDA error code
// (0 on success): a grid that cannot be co-resident is refused, never
// run.
extern "C" int lstmp_stack_infer2_f32(
    const float* x, const float* w_cat1, const float* bias1,
    const float* peep1, const float* wrm1_t, const float* w_cat2,
    const float* bias2, const float* peep2, const float* wrm2_t,
    const float* r01, const float* r02, float* c1, float* c2, float* r1,
    float* r2, float* m, unsigned* bar, int T, int S, int I, int C, int R,
    int tb, float cell_clip, void* stream) {
  const size_t cs = (size_t)S * C;
  const InferLayer L[2] = {
      {w_cat1, bias1, peep1, wrm1_t, c1, m, 0, -1, -1},
      {w_cat2, bias2, peep2, wrm2_t, c2, m + cs, 0, -1, -1}};
  return stack_infer2(x, L, r01, r02, r1, r2, bar, T, S, I, C, R, tb,
                      cell_clip, stream);
}

// K7 in bf16 (its design in the header): x, bias, peep, r0, c and the
// outputs as for lstmp_stack_infer2_f32, the weights as the params hold
// them (wxn [4C, I_n] with I_1 = I, I_2 = R, wrn [4C, R], wrmn [R, C]; the
// kernel rounds its slices once a call), and bf16 scratch in place of m:
// xb [T, S, xp], rb [2, S, rp], mb [2, S, cp] (xp, rp: I, R padded to a
// multiple of 16; cp: C padded to 8), and where the plan keeps a slice
// out of shared memory wg1 [grid, mg, kg1], wg2 [grid, mg, kg2], wq
// [grid, mq, kq] (the plan's fields; null otherwise). Products on the
// bf16 tensor cores, sums, state and outputs f32. One cooperative launch;
// returns a CUDA error code (0 on success).
extern "C" int lstmp_stack_infer2_bf16(
    const float* x, const float* wx1, const float* wr1, const float* bias1,
    const float* peep1, const float* wrm1, const float* wx2,
    const float* wr2, const float* bias2, const float* peep2,
    const float* wrm2, const float* r01, const float* r02, float* c1,
    float* c2, float* r1, float* r2, __nv_bfloat16* xb, __nv_bfloat16* rb,
    __nv_bfloat16* mb, __nv_bfloat16* wg1, __nv_bfloat16* wg2,
    __nv_bfloat16* wq, unsigned* bar, int T, int S, int I, int C, int R,
    int tb, float cell_clip, void* stream) {
  const int rp = up(R, 16), cp = up(C, 8);
  const Tc2Layer L[2] = {
      {wx1, wr1, bias1, peep1, wrm1, r01, c1, rb, mb, wg1, I},
      {wx2, wr2, bias2, peep2, wrm2, r02, c2, rb + (size_t)S * rp,
       mb + (size_t)S * cp, wg2, R}};
  return stack_infer2_bf16(x, L, r1, r2, xb, wq, bar, T, S, I, C, R, tb,
                           cell_clip, stream);
}
