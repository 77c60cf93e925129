// The product precision of the f32 kernels, as a type, so that it shows
// in each kernel's name and a profiler trace tells their launches from
// the bf16 kernels' (chip_smoke.py::kernel_counts_in_trace):
//   F32:  float32-accurate products (3xTF32 on the tensor cores, f32 FMA
//         on the CUDA cores).
// The bf16 entry points (the --bf16 training path, the JAX package's
// set_matmul_dtype(bfloat16) contract) are kernels of their own, on bf16
// copies of their operands made once (tc_gemm.cuh's Gemm16,
// wg_gemm.cuh, persistent.cuh's mma products); this header brings them
// the bf16 type.

#pragma once

#include <cuda_bf16.h>

namespace tc {

struct F32 {};

}  // namespace tc
