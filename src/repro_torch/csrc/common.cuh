// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads f32 or bf16 operands, accumulates in f32 and
// writes its output in the caller's dtype. The Python wrappers pass a
// dtype code per operand (DTYPE_F32 / DTYPE_BF16) and the launch
// function picks the matching template instance.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DTypeCode : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// Round an f32 value through dtype T (the Pallas kernels' `.astype`).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}
