// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// AUM_SCAN_GATED=0 builds a scan library's ungated form (ops/_build.py
// names it "<source>_sliced"): every kernel of the source as it is, but a
// forward writes the fp32 partial sum_n C_t[n] x_t[n] of its states with no
// D u and no SiLU(z) gate, and a backward writes fp32 du and ddelta
// partials with no D terms and no dz (scan_combine.cu sums the partials of
// a scan's slices of 16 states and applies D and the gate). The default
// build (1) is the gated form, unchanged.
#ifndef AUM_SCAN_GATED
#define AUM_SCAN_GATED 1
#endif

namespace aum {

constexpr bool kGated = AUM_SCAN_GATED != 0;

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

// 2^v on the special-function unit alone. exp2f without fast-math wraps the
// same instruction in a range fix-up for results below 2^-126 (three more
// instructions); the scans' decays flush those to zero instead, which
// changes no state by more than 2^-126 times its size.
__device__ __forceinline__ float exp2_sfu(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1 / v on the special-function unit alone (rcp.approx: about 1 ulp).
__device__ __forceinline__ float rcp_sfu(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// sigmoid(v) and v sigmoid(v) from the SFU's exponential and reciprocal (a
// few ulp; the limits 0 and 1 hold for large |v|, where 1 + 2^(-v log2 e)
// overflows to infinity and its reciprocal is 0).
__device__ __forceinline__ float sigmoid_fast(float v) {
  return rcp_sfu(1.0f + exp2_sfu(-v * 1.4426950408889634f));
}
__device__ __forceinline__ float silu_fast(float v) { return v * sigmoid_fast(v); }

// kCount consecutive values from a 16-byte aligned row, as fp32, in 16-byte
// loads through the read-only path.
template <int kCount>
__device__ __forceinline__ void load_row16(const float* p, float (&out)[kCount]) {
  static_assert(kCount % 4 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < kCount / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}
template <int kCount>
__device__ __forceinline__ void load_row16(const __nv_bfloat16* p, float (&out)[kCount]) {
  static_assert(kCount % 8 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < kCount / 8; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k in the low half, as bf16 pairs lie
      out[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      out[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

}  // namespace aum

// A kernel's resources on this card, for one instantiation: what the
// occupancy calculator allows (blocks per SM at `threads` and `smem` bytes
// of dynamic shared memory) and what ptxas gave it. info[0..5]: blocks per
// SM, threads per block, registers per thread, local (spill) bytes per
// thread, static shared bytes, dynamic shared bytes.
template <typename Kernel>
int aum_kernel_resources(Kernel kernel, int threads, int smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = blocks;
  info[1] = threads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = static_cast<int>(attr.sharedSizeBytes);
  info[5] = smem;
  return 0;
}

// Each library exports its own copy, so either one can name a status code.
#define AUM_DEFINE_ERROR_STRING(fn)                               \
  extern "C" const char* fn(int status) {                         \
    return cudaGetErrorString(static_cast<cudaError_t>(status)); \
  }
