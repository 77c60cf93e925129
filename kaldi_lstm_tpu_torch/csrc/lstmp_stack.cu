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
//   114.7 KB, the two Wrm slices 12.8 KB each: 202 KB of f32 weights,
//   101 KB in bf16. The plan holds, in this order, two staging buffers of
//   at least 8 KB each, the cells' bias and peepholes, layer 1's gate
//   slice, both Wrm slices, layer 2's gate slice, the c state, and gives
//   the staging buffers what is left (up to 64 KB each). So at these
//   widths every f32 weight stays resident and the staging buffers take
//   the 14.4 KB each that is left (bf16: 63.7 KB). Where a slice does not
//   fit (a wider input, wider cells), the same kernel reads that slice
//   from device memory instead, K5's rule: layer 2's gate slice is the
//   first to go, then the Wrm slices, then layer 1's.
//   bf16 follows K5's bf16 mode: the weight slices are held as bf16, each
//   staged operand is rounded to bf16 at use, the sums are f32 FMAs (a
//   bf16 x bf16 product is exact in f32) and the gate math is f32.
//   The time block tb does not shape K7: the entry point only checks that
//   it divides T. Results differ from a serial K5 x 2 only by summation
//   order; every sum runs in a fixed order, so they repeat from run to
//   run.
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/lstm_stack.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lstmp_tc.cuh"
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
  void* gifo;           // [T, S, 4C] in P's Store type
  float* c;             // [T, S, C]
  float* r;             // [T, S, R]
};

// K6 under precision P (see lstmp_stack_fwd2_f32 below).
template <class P>
int stack_fwd2(const TrainLayer (&L)[2], const float* x, float* xw1,
               float* xw2, float* wr_perm, float* m, int T, int S, int I,
               int C, int R, int tb, int phases, float cell_clip,
               int gate_bm, void* stream) {
  using Store = typename P::Store;
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
            static_cast<Store*>(Y.gifo) + t * g_step, Y.c + t * c_step, ml,
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

template <bool VEC, class P>
__global__ void __launch_bounds__(kThreads, 1)
stack_infer2_kernel(InferParams p) {
  using W = typename P::Store;   // resident weight element: f32 or bf16
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
  W* wg[2];
  W* wq[2];
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
    wg[l] = L.off_wg < 0 ? nullptr : reinterpret_cast<W*>(base + L.off_wg);
    wq[l] = L.off_wq < 0 ? nullptr : reinterpret_cast<W*>(base + L.off_wq);
    if (wg[l] != nullptr) {
      for (int e = threadIdx.x; e < L.K * nc * 4; e += kThreads) {
        const int k = e / (nc * 4), rem = e % (nc * 4);
        const int c = rem / 4, g = rem % 4;
        tc::store(wg[l] + (size_t)k * p.wld + 4 * c + g,
                  L.w_cat[(size_t)k * C4 + (size_t)g * C + j0 + c]);
      }
    }
    if (wq[l] != nullptr) {
      // the last quad's columns past nqc are zero
      for (int e = threadIdx.x; e < C * 4 * nquad; e += kThreads) {
        const int k = e / (4 * nquad), q = e % (4 * nquad);
        tc::store(wq[l] + (size_t)k * p.qld + q,
                  q < nqc ? L.wrm_t[(size_t)k * R + q0 + q] : 0.f);
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
    pk::block_product<VEC, P>(
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
          const W* ws = two ? wg[1] : wg[0];
          const int c = two ? col - n1 : col;
          const int kl = two ? k - I : k;
          if (ws != nullptr) {
            pk::load4<P>(ws + (size_t)kl * p.wld + 4 * c, w);
          } else {
            const float* row = (two ? p.l[1].w_cat : p.l[0].w_cat) +
                               (size_t)kl * C4 + j0 + c;
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              w[g] = tc::at_use<P>(__ldg(row + (size_t)g * C));
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
    pk::block_product<VEC, P>(
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
          const W* ws = two ? wq[1] : wq[0];
          const int quad = two ? col - n1 : col;
          const int kl = two ? k - C : k;
          if (ws != nullptr) {
            pk::load4<P>(ws + (size_t)kl * p.qld + 4 * quad, w);
          } else {
            const float* wrm_t = two ? p.l[1].wrm_t : p.l[0].wrm_t;
            #pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int q = 4 * quad + g;
              w[g] = q < nqc
                         ? tc::at_use<P>(__ldg(wrm_t + (size_t)kl * R + q0 + q))
                         : 0.f;
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
// (bf16 at C=800, R=512): at S=8 the staged rows then land in one chunk
// (5% faster than K5's 32 KB cap on an H100 SXM: the buf32k probe of
// tools/bench_stack_parts.py).
constexpr int kMaxBufFloats = 16384;

struct InferPlan {
  int grid, ncell, nq, wld, qld, buf, smem, sms, cst_smem, c_smem;
  int off_wg[2], off_wq[2];
};

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// One CTA per SM at most, cells and projection columns dealt out as K5
// deals them (ceil(C / SMs), ceil(R / SMs)); shared memory as the source
// header says.
cudaError_t make_infer_plan(int S, int I, int C, int R, bool bf16,
                            InferPlan* pl) {
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
  const size_t esz = bf16 ? 2 : 4;
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

template <class P>
int stack_infer2(const float* x, const InferLayer (&L)[2], const float* r01,
                 const float* r02, float* r1, float* r2, unsigned* bar,
                 int T, int S, int I, int C, int R, int tb, float cell_clip,
                 void* stream) {
  if (T <= 0 || tb <= 0 || T % tb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  InferPlan pl;
  cudaError_t err = make_infer_plan(S, I, C, R, P::kBf16, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging copies need every row of x, r and m 16-byte aligned
  const bool vec = I % 4 == 0 && R % 4 == 0 && C % 4 == 0;
  const void* kernel =
      vec ? reinterpret_cast<const void*>(stack_infer2_kernel<true, P>)
          : reinterpret_cast<const void*>(stack_infer2_kernel<false, P>);
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

// K6 in bf16: the arguments of lstmp_stack_fwd2_f32, with gifo1 and gifo2
// in bfloat16; every product rounds its operands to bf16 (tc_gemm.cuh's
// bf16 mode), c and r stay f32.
extern "C" int lstmp_stack_fwd2_bf16(
    const float* x, const float* wx1, const float* wr1, const float* bias1,
    const float* peep1, const float* wrm1, const float* wx2,
    const float* wr2, const float* bias2, const float* peep2,
    const float* wrm2, const float* c01, const float* r01, const float* c02,
    const float* r02, __nv_bfloat16* gifo1, float* c1, float* r1,
    __nv_bfloat16* gifo2, float* c2, float* r2, float* xw1, float* xw2,
    float* wr_perm, float* m, int T, int S, int I, int C, int R, int tb,
    int phases, float cell_clip, int gate_bm, void* stream) {
  const TrainLayer L[2] = {
      {wx1, wr1, bias1, peep1, wrm1, c01, r01, gifo1, c1, r1},
      {wx2, wr2, bias2, peep2, wrm2, c02, r02, gifo2, c2, r2}};
  return stack_fwd2<tc::Bf16>(L, x, xw1, xw2, wr_perm, m, T, S, I, C, R,
                              tb, phases, cell_clip, gate_bm, stream);
}

// The launch plan of K7 for these widths on the current device, for the
// f32 kernel (bf16 = 0) or the bf16 one (bf16 = 1): out[0..13] = grid,
// cells per CTA, projection columns per CTA, gate-slice stride,
// projection-slice stride, floats per staging buffer, dynamic shared
// memory bytes, SM count, the cells' bias and peepholes in shared memory
// (1) or not, their c state in shared memory (1) or not, and the byte
// offsets in shared memory of layer 1's and layer 2's gate slices and of
// layer 1's and layer 2's projection slices (-1: read from device
// memory). Returns a CUDA error code.
extern "C" int lstmp_stack_infer2_plan(int S, int I, int C, int R, int bf16,
                                       int* out) {
  InferPlan pl;
  const cudaError_t err = make_infer_plan(S, I, C, R, bf16 != 0, &pl);
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
  return stack_infer2<tc::F32>(x, L, r01, r02, r1, r2, bar, T, S, I, C, R,
                               tb, cell_clip, stream);
}

// K7 in bf16: the arguments of lstmp_stack_infer2_f32; the weight slices
// are held in shared memory as bf16 and every operand of a product is
// rounded to bf16 at use, the sums, the state and the outputs stay f32.
extern "C" int lstmp_stack_infer2_bf16(
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
  return stack_infer2<tc::Bf16>(x, L, r01, r02, r1, r2, bar, T, S, I, C, R,
                                tb, cell_clip, stream);
}
