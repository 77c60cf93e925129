// A bf16 product mainloop for Hopper (sm_90a) on warpgroup MMA
// (wgmma.mma_async) fed by the Tensor Memory Accelerator (TMA): the
// mainloop of the bf16 K3 and K4 (csrc/xent_affine.cu), and meant for
// K1 bf16's frame-axis products next.
//
// C[m, n] = sum_k A(m, k) B(n, k) over bf16 operands in device memory,
// summed in f32. Each operand is a bf16 matrix whose leading dimension is
// a multiple of 8 elements (TMA needs 16-byte strides) and is either
// K-major (element (row, k) at p[row * ld + k]) or MN-major (element
// (row, k) at p[k * ld + row]), so one mainloop serves r W^T (both
// K-major), dz W (A K-major, B MN-major) and dz^T r (both MN-major).
//
// Tiles: a CTA owns 128 x 128 outputs, two consumer warpgroups of 64
// rows each (wgmma m64n128k16, 64 f32 accumulators a thread), and one
// producer warp. A stage is 64 deep: each operand's 128 x 64 tile is one
// or two TMA boxes with 128-byte swizzling, 16 KB, so a stage is 32 KB
// and a ring of 6 stages takes 192 KB. Rows and k past an operand's
// extent arrive as zeros (TMA fills them): nothing is padded in memory,
// and a ragged R = 130 or K = 1003 needs no special path.
//
// Shared-memory layouts (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B
// and what the wgmma descriptors read, 1024-byte aligned):
//   K-major tile: 128 rows of 128 bytes (64 k), 16-byte chunks XOR-ed by
//     row % 8; a descriptor's stride byte offset (SBO) 1024 (eight rows),
//     leading byte offset unused; a k16 step moves its start 32 bytes.
//   MN-major tile: two blocks of 64 rows x 64 k, each 64 lines (one k) of
//     128 bytes (64 rows); leading byte offset (LBO) 8192 between the
//     blocks, SBO 1024 (eight k lines); a k16 step moves 2048 bytes.
// The second warpgroup's A starts 8192 bytes in, in both layouts.
//
// Pipeline: full/empty mbarriers per stage. The producer's one thread
// waits for a stage to be empty, arms its full barrier with the stage's
// bytes and issues the TMA loads; each consumer warpgroup waits for the
// stage to be full, issues four wgmma (k16) on it, commits them, waits
// for the previous stage's group and releases that stage (one arrive per
// consumer warp). A caller walks any sequence of output tiles, each over
// any range of stages, in the same order on both sides: that is how K3's
// chunk walk and K4's dz walk run a CTA's next tile's loads under its
// current tile's epilogue, and how a persistent grid walks its items.
// Accumulation stays in the wgmma accumulators (f32) across the whole
// contraction.
//
// Accumulator fragment (wgmma m64nNk16, f32): warp w of a warpgroup
// holds rows 16 w + g and 16 w + g + 8 (g = lane / 4); element d[4 j +
// 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 (lane % 4) + e. Within
// a thread the columns rise with (j, e).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kBK = 64;                 // contraction depth of a stage
constexpr int kBM = 128;                // CTA tile rows (two warpgroups)
constexpr int kBN = 128;                // CTA tile columns
constexpr int kTileBytes = 128 * kBK * 2;   // one operand's stage tile
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer
constexpr int kProducer = 32 * kConsumerWarps;        // its thread

// A ring of `stages` stages: its stages, barriers and 1024-byte
// alignment slack.
constexpr int ring_bytes(int stages) {
  return stages * kStageBytes + 2 * stages * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One 2-D box of `map` at (inner c0, outer c1) into shared memory at dst;
// completion (the box's bytes) is reported to bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1)
      : "memory");
}

// One 2-D box of shared memory at src to `map` at (inner c0, outer c1);
// what lies past the tensor's extent is not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's committed stores are done.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of element (row, col) of a 128 x 128 bf16 tile staged
// for two TMA boxes of {64 columns, 128 rows} (16 KB each) with 128-byte
// swizzling (a 1024-byte aligned buffer; a warp writing a fragment's
// pairs of columns touches 32 distinct banks).
__device__ __forceinline__ uint32_t staged_offset(int row, int col) {
  return (col >> 6) * kTileBytes + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Consumer warps only (the producer warp never joins): named barrier 1.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumerWarps) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor with 128-byte swizzling.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of a 64- (A) or 128-row (B) operand at the k16 step kk of
// the stage tile at addr.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, int kk) {
  if constexpr (MN) {
    return desc(addr + kk * 2048, 8192, 1024);
  } else {
    return desc(addr + kk * 32, 16, 1024);
  }
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
  #pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (+)= A B over 16 of depth: A 64 x 16, B 128 x 16 (bf16, from shared
// memory), d 64 x 128 f32; TA / TB: 1 where the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// A_MN / B_MN: the operands' layouts; STAGES: the ring's depth. One Ring
// per thread, each side walking the stages in the same order.
template <bool A_MN, bool B_MN, int STAGES = 6>
struct Ring {
  static constexpr int kStages = STAGES;
  static constexpr int kBytes = ring_bytes(STAGES);
  uint32_t base;      // the first stage (1024-byte aligned)
  uint32_t bars;      // full[kStages], then empty[kStages]
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit Ring(void* smem) {
    const uint32_t raw = smem_u32(smem);
    base = (raw + 1023u) & ~1023u;
    bars = base + kStages * kStageBytes;
  }

  // Shared memory past the ring (the caller's epilogue scratch).
  __device__ static void* tail(void* smem) {
    const uint32_t raw = smem_u32(smem);
    const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
    return static_cast<char*>(smem) + pad + kStages * kStageBytes +
           2 * kStages * 8;
  }

  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t a_tile(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t b_tile(int s) const {
    return base + s * kStageBytes + kTileBytes;
  }

  // By one thread, before the CTA's first __syncthreads.
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // 128 rows from row0 and 64 k from k0 of an operand into dst: one box
  // {64 k, 128 rows} K-major, two boxes {64 rows, 64 k} MN-major.
  template <bool MN>
  __device__ static void load(const CUtensorMap* map, uint32_t dst,
                              uint32_t bar, int row0, int k0) {
    if constexpr (MN) {
      tma_load(dst, map, bar, row0, k0);
      tma_load(dst + kTileBytes / 2, map, bar, row0 + 64, k0);
    } else {
      tma_load(dst, map, bar, k0, row0);
    }
  }

  // Producer: the stage of A rows m0.., B rows n0.., contraction k0.. .
  __device__ void produce(const CUtensorMap* ma, const CUtensorMap* mb,
                          int m0, int n0, int k0) {
    bar_wait(empty(stage), phase ^ 1u);
    bar_expect_tx(full(stage), kStageBytes);
    load<A_MN>(ma, a_tile(stage), full(stage), m0, k0);
    load<B_MN>(mb, b_tile(stage), full(stage), n0, k0);
    advance();
  }

  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bar_arrive(empty(s));
  }

  // Consumer warpgroup `group` (0 or 1): acc = the sum over the next nk
  // stages of its 64 rows of A times B. Returns with every stage released.
  __device__ void consume(float (&acc)[64], int nk, int group) {
    int prev = -1;
    for (int s = 0; s < nk; ++s) {
      bar_wait(full(stage), phase);
      const uint32_t a = a_tile(stage) + group * (kTileBytes / 2);
      const uint32_t b = b_tile(stage);
      fence_acc(acc);
      mma_fence();
      #pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        mma_m64n128k16<A_MN, B_MN>(acc, operand_desc<A_MN>(a, kk),
                                   operand_desc<B_MN>(b, kk),
                                   (s | kk) != 0);
      }
      mma_commit();
      mma_wait<1>();
      fence_acc(acc);
      if (prev >= 0) release(prev);
      prev = stage;
      advance();
    }
    mma_wait<0>();
    fence_acc(acc);
    if (prev >= 0) release(prev);
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 matrix of `outer` lines of `inner` elements (line
// stride ld elements, a multiple of 8; p 16-byte aligned), read in boxes
// of box_inner x box_outer with 128-byte swizzling; reads past the extent
// fill zeros. False if the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* p, int inner, int outer,
                     int ld, int box_inner, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of an operand as the ring loads it: K-major (rows x k, box
// {64 k, 128 rows}) or MN-major (k lines of rows, box {64 rows, 64 k}).
inline bool operand_map(CUtensorMap* map, const void* p, bool mn, int rows,
                        int kext, int ld) {
  return mn ? make_map(map, p, rows, kext, ld, 64, kBK)
            : make_map(map, p, kext, rows, ld, kBK, 128);
}

}  // namespace wg
