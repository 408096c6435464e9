// Shared helpers of the port's CUDA kernels: element loads/stores in float32
// or bfloat16, and warp reductions.  Every kernel computes in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reduce over the `width` lanes of an aligned lane group (width a power of 2).
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
#define REPRO_F32 0
#define REPRO_BF16 1
