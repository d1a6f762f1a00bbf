// Shared helpers of the port's CUDA kernels: element type conversions and
// the dispatch from the C interfaces' dtype code (0 = float32, 1 = bfloat16,
// as ops/_build.py DTYPE_CODES) to a template argument.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vap {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through T and widened back (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes of a half-warp (lanes that differ in bits 0-3)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace vap

// Runs the statement list with `T` bound to the element type of `code`;
// an unknown code returns cudaErrorInvalidValue from the enclosing function.
#define VAP_DISPATCH_DTYPE(code, T, ...)                  \
  do {                                                    \
    if ((code) == vap::kF32) {                            \
      using T = float;                                    \
      __VA_ARGS__;                                        \
    } else if ((code) == vap::kBF16) {                    \
      using T = __nv_bfloat16;                            \
      __VA_ARGS__;                                        \
    } else {                                              \
      return static_cast<int>(cudaErrorInvalidValue);     \
    }                                                     \
  } while (0)
