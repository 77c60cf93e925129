// Wavefront ("staircase") schedule for a stack of two LSTMP layers,
// float32 throughout with float32 accumulation.
//
// K6 (lstmp_stack_fwd2_f32) replaces
// kaldi_lstm_tpu/ops/lstm_stack_pallas.py::_fwd2_kernel: the training
// forward of both layers, streaming out K1's residuals for each (the
// post-activation gates g, i, f, o, the clipped c and r, every t), so that
// K2 (lstmp_train.cu) takes them layer by layer as it takes K1's.
// K7 (lstmp_stack_infer2_f32) replaces ::_infer2_kernel: the inference
// forward, which writes only layer 2's r and the final states.
//
// Cell math per layer and step (gate order g, i, f, o; Kaldi orientation):
//   pre = xw_t + bias + r_{t-1} Wr^T
//   g = tanh(g_pre), i = sigmoid(i_pre + c_{t-1} p_i),
//   f = sigmoid(f_pre + c_{t-1} p_f)
//   c = clip(g i + c_{t-1} f, +-cell_clip)          (no clip if <= 0)
//   o = sigmoid(o_pre + c_t p_o)                    (clipped c_t)
//   r = (tanh(c_t) o) Wrm^T
// Layer 1's xw_t = x_t Wx1^T, computed per step as K1 does; layer 2's
// input is layer 1's r, and its xw is hoisted: one tiled product
// [tb*S, R] x [R, 4C] per block of tb steps, the bias added per step.
//
// The schedule. T = K * tb steps in K blocks; wavefront block k = 0..K
// runs layer 1 over block k (while k < K) and layer 2 over block k-1
// (while k > 0). The two layers of one wavefront step are independent:
// layer 2 reads only r1 of the previous block, written by launches that
// have already finished on the stream. So each step is ONE gates launch
// over both layers (blockIdx.z picks the layer) and ONE projection launch
// over both, where the serial schedule makes two of each: the wavefront
// halves the launches of the recurrence and doubles the blocks of each.
// Per call: K hoisted products + 2 (T + tb) step launches.
//
// What bounds it on an H100: operations (2 N [(4C (I+R) + CR) +
// (4C 2R + CR)] f32 flops; 120 GFLOP at S=512, T=20, I=40, C=800, R=512,
// 1.8 ms at the f32 peak), and at small S the serial chain of T + tb
// dependent steps, each a pair of launches on 50 + 32 blocks per layer
// pair. This first design keeps the simple tiles of lstmp_infer.cu /
// lstmp_train.cu (CUDA-core fma, a thread per (stream, cell), the streams'
// rows staged in shared memory); both layers' weights (23 MB at f32) are
// read from the 50 MB L2 at each step. Tensor cores and a persistent
// recurrence are later work, as for K1/K5 (ROADMAP.md).
//
// Built with nvcc into a shared library with plain C entry points, loaded
// by kaldi_lstm_tpu_torch/ops/lstm_stack.py through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kCells = 32;    // threadIdx.x: cells / output columns
constexpr int kStreams = 8;   // threadIdx.y: streams per block
constexpr int kChunk = 512;   // staged K elements per stream and pass

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One layer's operands for one step of the gates kernel.
struct GateLayer {
  const float* x;       // [S, I] input rows, contracted with w_x (or null)
  const float* w_x;     // [I, 4C] Wx^T
  int I;
  const float* xw;      // [S, 4C] precomputed input projection (or null)
  const float* r_prev;  // [S, R]
  const float* w_r;     // [R, 4C] Wr^T
  const float* bias;    // [4C]
  const float* peep;    // [3, C] (i, f, o)
  const float* c_prev;  // [S, C]
  float* c_out;         // [S, C]; may be c_prev (in place, same thread)
  float* gifo;          // [S, 4C] activations, or null (inference)
  float* m;             // [S, C] out: tanh(c) o
};

struct GateArgs {
  GateLayer l[2];
};

struct ProjLayer {
  const float* m;       // [S, C]
  const float* wrm_t;   // [C, R] Wrm^T
  float* r;             // [S, R]
};

struct ProjArgs {
  ProjLayer l[2];
};

// acc[g] += sum_k src[s, k] w[k, g*C + j] for the block's 8 streams; the
// rows are staged in shared memory kChunk at a time. Called by every
// thread of the block (it synchronises).
__device__ __forceinline__ void contract_gates(
    const float* __restrict__ src, const float* __restrict__ w, int K,
    int s0, int sl, int j, int S, int C, bool active,
    float (&rows)[kStreams][kChunk], float (&acc)[4]) {
  const size_t C4 = 4 * (size_t)C;
  const int tid = threadIdx.y * kCells + threadIdx.x;
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
      const float* wp = w + (size_t)k0 * C4 + j;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float v = rows[sl][kk];
        acc[0] = fmaf(v, wp[0], acc[0]);
        acc[1] = fmaf(v, wp[C], acc[1]);
        acc[2] = fmaf(v, wp[2 * (size_t)C], acc[2]);
        acc[3] = fmaf(v, wp[3 * (size_t)C], acc[3]);
        wp += C4;
      }
    }
    __syncthreads();
  }
}

// One step of both layers' gates (blockIdx.z + first picks the layer): a
// thread owns one (stream, cell) pair.
__global__ void stack_gates_kernel(GateArgs args, int first, int S, int R,
                                   int C, float cell_clip) {
  __shared__ float rows[kStreams][kChunk];
  const GateLayer L = args.l[first + blockIdx.z];
  const int j = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const size_t C4 = 4 * (size_t)C;
  const bool active = (j < C) && (s < S);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  if (L.xw == nullptr) {
    contract_gates(L.x, L.w_x, L.I, s0, sl, j, S, C, active, rows, acc);
  } else if (active) {
    const float* xr = L.xw + (size_t)s * C4;
    #pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] = xr[(size_t)g * C + j];
  }
  if (active) {
    #pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] += L.bias[(size_t)g * C + j];
  }
  contract_gates(L.r_prev, L.w_r, R, s0, sl, j, S, C, active, rows, acc);
  if (!active) return;

  const size_t idx = (size_t)s * C + j;
  const float cp = L.c_prev[idx];
  const float g = tanhf(acc[0]);
  const float i = sigmoid_f(acc[1] + cp * L.peep[j]);
  const float f = sigmoid_f(acc[2] + cp * L.peep[C + j]);
  float cn = g * i + cp * f;
  if (cell_clip > 0.f) {
    // written out (not fminf/fmaxf) so that a NaN propagates like clip
    cn = cn < -cell_clip ? -cell_clip : (cn > cell_clip ? cell_clip : cn);
  }
  const float o = sigmoid_f(acc[3] + cn * L.peep[2 * C + j]);
  if (L.gifo != nullptr) {
    float* gr = L.gifo + (size_t)s * C4;
    gr[j] = g;
    gr[C + j] = i;
    gr[2 * (size_t)C + j] = f;
    gr[3 * (size_t)C + j] = o;
  }
  L.c_out[idx] = cn;
  L.m[idx] = tanhf(cn) * o;
}

// One step of both layers' projections: r[s, q] = sum_c m[s, c] Wrm^T[c, q].
__global__ void stack_proj_kernel(ProjArgs args, int first, int S, int C,
                                  int R) {
  __shared__ float rows[kStreams][kChunk];
  const ProjLayer L = args.l[first + blockIdx.z];
  const int q = blockIdx.x * kCells + threadIdx.x;
  const int sl = threadIdx.y;
  const int s0 = blockIdx.y * kStreams;
  const int s = s0 + sl;
  const int tid = threadIdx.y * kCells + threadIdx.x;
  const bool active = (q < R) && (s < S);
  float acc = 0.f;

  for (int k0 = 0; k0 < C; k0 += kChunk) {
    const int kn = min(kChunk, C - k0);
    for (int e = tid; e < kStreams * kn; e += kCells * kStreams) {
      const int ss = e / kn;
      const int sg = s0 + ss;
      rows[ss][e % kn] = (sg < S) ? L.m[(size_t)sg * C + k0 + e % kn] : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* wp = L.wrm_t + (size_t)k0 * R + q;
      #pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        acc = fmaf(rows[sl][kk], *wp, acc);
        wp += R;
      }
    }
    __syncthreads();
  }
  if (active) L.r[(size_t)s * R + q] = acc;
}

constexpr int kTM = 64;       // output rows per block
constexpr int kTN = 64;       // output columns per block
constexpr int kTK = 16;       // contraction chunk
constexpr int kMThreads = 256;

// Layer 2's hoisted input projection: out [M, N] = a [M, K] b [K, N], all
// row-major (a = one block of r1 rows, b = Wx2^T). One block owns one
// 64 x 64 output tile, a thread a 4 x 4 register tile; a and b are staged
// 16 deep in shared memory. Each output is one in-order sum over k.
__global__ void block_matmul_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int M, int N,
                                    int K) {
  __shared__ float As[kTK][kTM + 1];
  __shared__ float Bs[kTK][kTN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  float acc[4][4];
  #pragma unroll
  for (int u = 0; u < 4; ++u) {
    #pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTK * kTM; e += kMThreads) {
      const int mm = e / kTK;   // neighbouring threads along k
      const int kk = e % kTK;
      const int m = m0 + mm;
      const int k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? a[(size_t)m * K + k] : 0.f;
    }
    for (int e = tid; e < kTK * kTN; e += kMThreads) {
      const int kk = e / kTN;   // neighbouring threads along n
      const int nn = e % kTN;
      const int n = n0 + nn;
      const int k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? b[(size_t)k * N + n] : 0.f;
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
      const int n = n0 + tx + 16 * v;
      if (n < N) out[(size_t)m * N + n] = acc[u][v];
    }
  }
}

// The operands the host loop needs, shared by K6 and K7.
struct Stack {
  const float* x;        // [T, S, I]
  const float* w_cat1;   // [(I + R), 4C] = [Wx1^T; Wr1^T]
  const float* bias1;
  const float* peep1;
  const float* wrm1_t;   // [C, R]
  const float* w_cat2;   // [2R, 4C] = [Wx2^T; Wr2^T]
  const float* bias2;
  const float* peep2;
  const float* wrm2_t;
  float* xw2;            // [tb, S, 4C] scratch: the block's projection
  float* m;              // [2, S, C] scratch
  int T, S, I, C, R, tb;
  float cell_clip;
};

// Where one layer reads and writes at one step.
struct StepIo {
  const float* r_prev;
  const float* c_prev;
  float* c_out;
  float* gifo;
  float* r_out;
};

// The host loop over wavefront blocks and steps. Where a layer reads and
// writes at step t is the business of its I/O object (training: full
// sequences; inference: a ring for r1, c updated in place); Io1 also says
// where block kb of layer 1's r starts, the rows of layer 2's hoisted
// projection.
template <class Io1, class Io2>
int run_wavefront(const Stack& P, bool run1, bool run2, const Io1& io1,
                  const Io2& io2, cudaStream_t st) {
  const int K = P.T / P.tb;
  const size_t C4 = 4 * (size_t)P.C;
  const dim3 block(kCells, kStreams);
  const int sblocks = (P.S + kStreams - 1) / kStreams;
  const int cblocks = (P.C + kCells - 1) / kCells;
  const int rblocks = (P.R + kCells - 1) / kCells;
  cudaError_t err;
  for (int k = 0; k <= K; ++k) {
    const bool l1 = run1 && k < K;
    const bool l2 = run2 && k > 0;
    if (!l1 && !l2) continue;
    if (l2) {
      // xw2 [tb*S, 4C] = r1 of block k-1 times Wx2^T
      const int M = P.tb * P.S;
      const dim3 grid((4 * P.C + kTN - 1) / kTN, (M + kTM - 1) / kTM);
      block_matmul_kernel<<<grid, kMThreads, 0, st>>>(
          io1.block(k - 1), P.w_cat2, P.xw2, M, 4 * P.C, P.R);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int jj = 0; jj < P.tb; ++jj) {
      GateArgs ga = {};
      ProjArgs pa = {};
      if (l1) {
        const StepIo io = io1.step(k * P.tb + jj);
        GateLayer& g = ga.l[0];
        g.x = P.x + (size_t)(k * P.tb + jj) * P.S * P.I;
        g.w_x = P.w_cat1;
        g.I = P.I;
        g.xw = nullptr;
        g.r_prev = io.r_prev;
        g.w_r = P.w_cat1 + (size_t)P.I * C4;
        g.bias = P.bias1;
        g.peep = P.peep1;
        g.c_prev = io.c_prev;
        g.c_out = io.c_out;
        g.gifo = io.gifo;
        g.m = P.m;
        pa.l[0] = ProjLayer{P.m, P.wrm1_t, io.r_out};
      }
      if (l2) {
        const StepIo io = io2.step((k - 1) * P.tb + jj);
        float* m2 = P.m + (size_t)P.S * P.C;
        GateLayer& g = ga.l[1];
        g.x = nullptr;
        g.w_x = nullptr;
        g.I = 0;
        g.xw = P.xw2 + (size_t)jj * P.S * C4;
        g.r_prev = io.r_prev;
        g.w_r = P.w_cat2 + (size_t)P.R * C4;
        g.bias = P.bias2;
        g.peep = P.peep2;
        g.c_prev = io.c_prev;
        g.c_out = io.c_out;
        g.gifo = io.gifo;
        g.m = m2;
        pa.l[1] = ProjLayer{m2, P.wrm2_t, io.r_out};
      }
      const int first = l1 ? 0 : 1;
      const int nz = (l1 ? 1 : 0) + (l2 ? 1 : 0);
      stack_gates_kernel<<<dim3(cblocks, sblocks, nz), block, 0, st>>>(
          ga, first, P.S, P.R, P.C, P.cell_clip);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      stack_proj_kernel<<<dim3(rblocks, sblocks, nz), block, 0, st>>>(
          pa, first, P.S, P.C, P.R);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Training: full [T, S, .] sequences per layer (gifo, c, r).
struct SeqLayer {
  const float* c0;
  const float* r0;
  float* gifo;
  float* c;
  float* r;
  int S, C, R, tb;
  StepIo step(int t) const {
    const size_t cs = (size_t)S * C, rs = (size_t)S * R;
    StepIo io;
    io.r_prev = t == 0 ? r0 : r + (t - 1) * rs;
    io.c_prev = t == 0 ? c0 : c + (t - 1) * cs;
    io.c_out = c + t * cs;
    io.gifo = gifo + t * 4 * cs;
    io.r_out = r + t * rs;
    return io;
  }
  const float* block(int kb) const {
    return r + (size_t)kb * tb * S * R;
  }
};

// Inference, layer 1: c updated in place, r into a two-block ring
// [2, tb, S, R] (block kb in slot kb % 2).
struct RingLayer {
  const float* r0;
  float* c;
  float* ring;
  int S, R, tb;
  float* slot(int t) const {
    return ring + ((size_t)((t / tb) % 2) * tb + t % tb) * (size_t)S * R;
  }
  StepIo step(int t) const {
    StepIo io;
    io.r_prev = t == 0 ? r0 : slot(t - 1);
    io.c_prev = c;
    io.c_out = c;
    io.gifo = nullptr;
    io.r_out = slot(t);
    return io;
  }
  const float* block(int kb) const { return slot(kb * tb); }
};

// Inference, layer 2: c updated in place, every r written out.
struct OutLayer {
  const float* r0;
  float* c;
  float* r;
  int S, R;
  StepIo step(int t) const {
    const size_t rs = (size_t)S * R;
    StepIo io;
    io.r_prev = t == 0 ? r0 : r + (t - 1) * rs;
    io.c_prev = c;
    io.c_out = c;
    io.gifo = nullptr;
    io.r_out = r + t * rs;
    return io;
  }
};

}  // namespace

// K6. x [T, S, I] time-major; per layer n = 1, 2: w_catn = [Wx^T; Wr^T]
// ([(I + R), 4C] and [2R, 4C]), biasn [4C], peepn [3, C], wrmn_t [C, R],
// c0n [S, C], r0n [S, R]. Out per layer: gifon [T, S, 4C] (g, i, f, o
// activations), cn [T, S, C] (clipped), rn [T, S, R]. Scratch: xw2
// [tb, S, 4C], m [2, S, C]. tb divides T. phases: 0 both layers, 1 layer
// 1 only, 2 layer 2 only (over whatever r1 holds); a timing ablation.
// K + 2 (T + tb) launches (K = T / tb) for both phases, on `stream`, no
// synchronisation, no allocation. Returns cudaGetLastError().
extern "C" int lstmp_stack_fwd2_f32(
    const float* x, const float* w_cat1, const float* bias1,
    const float* peep1, const float* wrm1_t, const float* w_cat2,
    const float* bias2, const float* peep2, const float* wrm2_t,
    const float* c01, const float* r01, const float* c02, const float* r02,
    float* gifo1, float* c1, float* r1, float* gifo2, float* c2, float* r2,
    float* xw2, float* m, int T, int S, int I, int C, int R, int tb,
    int phases, float cell_clip, void* stream) {
  const Stack P{x, w_cat1, bias1, peep1, wrm1_t, w_cat2, bias2, peep2,
                wrm2_t, xw2, m, T, S, I, C, R, tb, cell_clip};
  const SeqLayer io1{c01, r01, gifo1, c1, r1, S, C, R, tb};
  const SeqLayer io2{c02, r02, gifo2, c2, r2, S, C, R, tb};
  return run_wavefront(P, phases != 2, phases != 1, io1, io2,
                       static_cast<cudaStream_t>(stream));
}

// K7. Operands as K6's. In/out: c1, c2 [S, C] hold c0 on entry and the
// final c on return. Out: r2 [T, S, R]; ring [2, tb, S, R] holds layer
// 1's last two blocks of r, the final r1 at slot ((T/tb - 1) % 2, tb - 1).
// Scratch: xw2 [tb, S, 4C], m [2, S, C]. K + 2 (T + tb) launches.
// Returns cudaGetLastError().
extern "C" int lstmp_stack_infer2_f32(
    const float* x, const float* w_cat1, const float* bias1,
    const float* peep1, const float* wrm1_t, const float* w_cat2,
    const float* bias2, const float* peep2, const float* wrm2_t,
    const float* r01, const float* r02, float* c1, float* c2, float* r2,
    float* ring, float* xw2, float* m, int T, int S, int I, int C, int R,
    int tb, float cell_clip, void* stream) {
  const Stack P{x, w_cat1, bias1, peep1, wrm1_t, w_cat2, bias2, peep2,
                wrm2_t, xw2, m, T, S, I, C, R, tb, cell_clip};
  const RingLayer io1{r01, c1, ring, S, R, tb};
  const OutLayer io2{r02, c2, r2, S, R};
  return run_wavefront(P, true, true, io1, io2,
                       static_cast<cudaStream_t>(stream));
}
