// Depthwise causal / anti-causal 1D convolution + bias + optional SiLU
// (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/conv1d.py:_conv_kernel. Weights are
// (D, K), K = 4 (the mixer's width, the only one built), with tap k multiplying x[t - (K-1) + k] (causal); reverse = 1 is the
// anti-causal form out[t] = sum_i x[t + i] * w[K-1-i], i.e. flip -> causal
// conv -> flip. Out-of-range inputs are zeros (the halo). The taps are summed
// in fp32 in the kernel's order (tap 0 first), then the bias is added and the
// SiLU applied in fp32, and the result is cast once: the TPU kernel's
// compute_f32 form.
//
// Design: a thread owns one channel over a tile of kTileL steps and slides a
// K-value window of that channel through registers, so each input is read
// from memory once per tile (plus the K-1 halo) with neighbouring threads on
// neighbouring channels. Grid = (ceil(D / kThreads), ceil(L / kTileL), batch).
//
// What bounds it: bytes. Per element it does 2K + 4 fp32 operations and one
// exponential against one read and one write, far below the card's ratio of
// operations to bytes, so the floor is one read of x plus one write of out.

#include <cstdint>

#include "common.cuh"

struct ConvArgs {
  const void* x;        // (batch, L, D), channel stride 1
  const float* weight;  // (D, K) fp32, contiguous
  const float* bias;    // (D,) fp32 or null
  void* out;            // (batch, L, D), contiguous, x's dtype
  long long x_sb, x_sl;
};

namespace {

constexpr int kThreads = 128;
constexpr int kTileL = 64;
constexpr int K = 4;  // the model's conv width; the only one built

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1d_fwd_kernel(const ConvArgs a, int seqlen, int dim, int reverse, int silu) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= dim) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileL;
  const int t1 = min(t0 + kTileL, seqlen);

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + d;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * seqlen * dim + d;

  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = a.weight[static_cast<long long>(d) * K + k];
  const float bias = a.bias != nullptr ? a.bias[d] : 0.0f;

  float win[K];
  if (!reverse) {
    // Before step t: win[i] = x[t - K + i]; the step shifts left and appends x[t].
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int t = t0 - K + i;
      win[i] = t >= 0 ? aum::to_float(x[t * a.x_sl]) : 0.0f;
    }
    for (int t = t0; t < t1; ++t) {
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) win[i] = win[i + 1];
      win[K - 1] = aum::to_float(x[t * a.x_sl]);
      float acc = win[0] * w[0];
#pragma unroll
      for (int i = 1; i < K; ++i) acc += win[i] * w[i];
      acc += bias;
      if (silu) acc = aum::silu(acc);
      out[static_cast<long long>(t) * dim] = aum::from_float<T>(acc);
    }
  } else {
    // Walk the tile backwards. Before step t: win[i] = x[t + 1 + i]; the step
    // shifts right and puts x[t] in front.
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int t = t1 + i;
      win[i] = t < seqlen ? aum::to_float(x[t * a.x_sl]) : 0.0f;
    }
    for (int t = t1 - 1; t >= t0; --t) {
#pragma unroll
      for (int i = K - 1; i > 0; --i) win[i] = win[i - 1];
      win[0] = aum::to_float(x[t * a.x_sl]);
      float acc = win[0] * w[K - 1];
#pragma unroll
      for (int i = 1; i < K; ++i) acc += win[i] * w[K - 1 - i];
      acc += bias;
      if (silu) acc = aum::silu(acc);
      out[static_cast<long long>(t) * dim] = aum::from_float<T>(acc);
    }
  }
}

template <typename T>
int launch(const ConvArgs& a, int batch, int seqlen, int dim, int reverse, int silu,
           cudaStream_t s) {
  const dim3 grid((dim + kThreads - 1) / kThreads, (seqlen + kTileL - 1) / kTileL, batch);
  conv1d_fwd_kernel<T><<<grid, kThreads, 0, s>>>(a, seqlen, dim, reverse, silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x and out); width must be 4. Returns
// cudaGetLastError() after the launch (0 on success).
int aum_causal_conv1d_fwd(const ConvArgs* args, int batch, int seqlen, int dim,
                          int width, int reverse, int silu, int dtype,
                          void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || width != K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(*args, batch, seqlen, dim, reverse, silu, s);
  if (dtype == 1) return launch<__nv_bfloat16>(*args, batch, seqlen, dim, reverse, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_conv_error_string)
