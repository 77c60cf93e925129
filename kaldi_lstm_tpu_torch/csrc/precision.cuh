// The product precision of the kernels, as a type, so that it shows in
// each kernel's name and a profiler trace tells the bf16 launches from
// the float32 ones:
//   F32:  float32-accurate products (3xTF32 on the tensor cores, f32 FMA
//         on the CUDA cores);
//   Bf16: the --bf16 training path, the JAX package's set_matmul_dtype
//         (bfloat16) contract: every operand of a product is rounded to
//         bf16 where the reference casts it before its dot, the products
//         are summed in f32 (a bf16 x bf16 product is exact in f32), and
//         K1's gate residual is stored in bf16.
// Rounding is round to nearest even, as torch's .to(torch.bfloat16) and
// JAX's astype(jnp.bfloat16).

#pragma once

#include <cuda_bf16.h>

namespace tc {

// Store: the element type of what the Bf16 precision keeps in bf16 (K1's
// gate residual, K7's weights in shared memory), float under F32.
struct F32 {
  static constexpr bool kBf16 = false;
  using Store = float;
};

struct Bf16 {
  static constexpr bool kBf16 = true;
  using Store = __nv_bfloat16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v as a product reads it under precision P
template <class P>
__device__ __forceinline__ float at_use(float v) {
  if constexpr (P::kBf16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace tc
