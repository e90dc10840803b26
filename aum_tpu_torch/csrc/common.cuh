// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aum {

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a bf16 cast does
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

}  // namespace aum

// Each library exports its own copy, so either one can name a status code.
#define AUM_DEFINE_ERROR_STRING(fn)                               \
  extern "C" const char* fn(int status) {                         \
    return cudaGetErrorString(static_cast<cudaError_t>(status)); \
  }
